"""The LM serving steps on the port (``repro_torch.serve.serve_step``)
against the JAX reference's (``repro.serve.serve_step``) on the CPU.

Weights are the port's ``init(seed)``, carried to the reference with
``interop.lm_params_to_numpy``.  ``greedy_generate`` must give the
reference's tokens; where a token differs, the reference's own top-2
margin at that step must be under the logits tolerance (a near-tie), and
nothing is re-seeded.  The example ``examples/torch_serve_lm.py`` runs
at a reduced size.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.lm import build_model as ref_build_model
from repro.serve import serve_step as RS
from repro_torch.configs import get_config, list_configs
from repro_torch.interop import lm_cache_to_numpy, lm_params_to_numpy
from repro_torch.models.lm import build_model
from repro_torch.serve import serve_step as PS

ROOT = Path(__file__).resolve().parents[1]
SERVE_ARCHS = ["deepseek-7b", "h2o-danube-1.8b", "mamba2-370m",
               "jamba-v0.1-52b"]
GREEDY_ARCHS = SERVE_ARCHS + ["seamless-m4t-medium", "deepseek-moe-16b"]
STEP_ARCHS = GREEDY_ARCHS + ["granite-20b", "grok-1-314b", "qwen2-vl-7b"]
TOL = 1e-4


def pair(name, seed=0, dtype=None):
    cfg = get_config(name).reduced()
    rcfg = ref_get_config(name).reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        rcfg = dataclasses.replace(rcfg, dtype=dtype)
    model = build_model(cfg, device="cpu")
    params = model.init(seed)
    rmodel = ref_build_model(rcfg)
    rparams = jax.tree.map(jnp.asarray, lm_params_to_numpy(params))
    if dtype == "bfloat16":
        # every leaf of a dense model is bf16 (no router, no SSM constants)
        rparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rparams)
    return cfg, rcfg, model, params, rmodel, rparams


def batches(cfg, B=2, S=12, seed=3):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.encdec:
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    elif cfg.input_kind == "embeds3":
        del b["tokens"]
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * .1).astype(
            np.float32)
        b["positions3"] = np.broadcast_to(
            np.arange(S)[None, None], (3, B, S)).astype(np.int32).copy()
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


def ref_cache(c):
    if dataclasses.is_dataclass(c):
        return {f.name: np.asarray(getattr(c, f.name), np.float32)
                if f.name != "pos" else np.asarray(c.pos)
                for f in dataclasses.fields(c)}
    if isinstance(c, dict):
        return {k: ref_cache(v) for k, v in c.items()}
    return type(c)(ref_cache(v) for v in c)


def same_tree(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            if k == "pos":
                np.testing.assert_array_equal(got[k], want[k])
            else:
                same_tree(got[k], want[k], tol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same_tree(g, w, tol)
    else:
        close(torch.from_numpy(np.asarray(got)), want, tol)


@pytest.mark.parametrize("name", sorted(list_configs()))
@pytest.mark.parametrize("seq_len", [1, 16, 4096, 524288])
def test_cache_len_for_matches_reference(name, seq_len):
    assert PS.cache_len_for(get_config(name), seq_len) == \
        RS.cache_len_for(ref_get_config(name), seq_len)


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_prefill_and_decode_steps_match_reference(name):
    """One prefill and two decode steps: logits, encoder output and every
    cache against the reference's steps (qwen2-vl with explicit
    positions3, as tests/test_models.py drives it)."""
    cfg, rcfg, model, params, rmodel, rparams = pair(name)
    tb, jb = batches(cfg)
    B, S = 2, 12
    caches = model.init_cache(B, S + 4, dtype=torch.float32)
    rcaches = rmodel.init_cache(B, S + 4, dtype=jnp.float32)
    logits, caches, enc = PS.make_prefill_step(model, cfg)(params, tb, caches)
    rlogits, rcaches, renc = RS.make_prefill_step(rmodel, rcfg)(
        rparams, jb, rcaches)
    close(logits, rlogits)
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert (enc is None) == (renc is None)
    if enc is not None:
        close(enc, renc)
    same_tree(lm_cache_to_numpy(caches), ref_cache(rcaches))
    decode = PS.make_decode_step(model, cfg)
    rdecode = RS.make_decode_step(rmodel, rcfg)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    for t in range(2):
        kw, rkw = {}, {}
        if cfg.input_kind == "embeds3":
            p3 = np.full((3, B, 1), S + t, np.int32)
            kw["positions3"] = torch.from_numpy(p3)
            rkw["positions3"] = jnp.asarray(p3)
        logits, caches = decode(params, tok, caches, enc=enc, **kw)
        rlogits, rcaches = rdecode(rparams, jnp.asarray(tok.numpy()), rcaches,
                                   enc=renc, **rkw)
        close(logits, rlogits)
        same_tree(lm_cache_to_numpy(caches), ref_cache(rcaches))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def ref_margins(rmodel, rcfg, rparams, jb, tokens, max_new):
    """The reference's relative top-2 margin of the logits that chose
    each generated token (prefill, then its decode steps on ``tokens``)."""
    B = tokens.shape[0]
    if rcfg.encdec:
        s_max = jb["tokens"].shape[1] + max_new
    else:
        s_max = RS.cache_len_for(rcfg, jb["tokens"].shape[1] + max_new)
    caches = rmodel.init_cache(B, s_max, dtype=jnp.float32)
    logits, caches, enc = RS.make_prefill_step(rmodel, rcfg)(rparams, jb,
                                                            caches)
    decode = RS.make_decode_step(rmodel, rcfg)
    out = []
    for t in range(max_new):
        lg = np.asarray(logits[:, -1], np.float64)
        top = np.sort(lg, axis=-1)
        out.append((top[:, -1] - top[:, -2]) / np.abs(lg).max())
        logits, caches = decode(rparams, jnp.asarray(tokens[:, t:t + 1]),
                                caches, enc=enc)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("name", GREEDY_ARCHS)
def test_greedy_generate_matches_reference(name):
    cfg, rcfg, model, params, rmodel, rparams = pair(name)
    tb, jb = batches(cfg, S=10)
    max_new = 6
    got = PS.greedy_generate(model, cfg, params, tb, max_new, device="cpu")
    want = np.asarray(RS.greedy_generate(rmodel, rcfg, rparams, jb, max_new))
    assert got.dtype == torch.int32 and got.shape == (2, max_new)
    diff = got.numpy() != want
    if diff.any():
        # only a near-tie of the reference's own logits may differ, and
        # only from its first differing step on (after that the inputs
        # differ)
        first = diff.argmax(axis=1)
        margins = ref_margins(rmodel, rcfg, rparams, jb, want, max_new)
        for b in np.flatnonzero(diff.any(axis=1)):
            assert margins[b, first[b]] < TOL, (b, first[b], margins[b])


def bf16_steps(pkg, model, cfg, params, batch, cache_dtype, steps=2):
    """Prefill then ``steps`` greedy decode steps; the logits of each."""
    S = (PS if pkg is torch else RS)
    caches = model.init_cache(2, 16, dtype=cache_dtype)
    logits, caches, _ = S.make_prefill_step(model, cfg)(params, batch, caches)
    out = [logits]
    decode = S.make_decode_step(model, cfg)
    for _ in range(steps):
        tok = pkg.argmax(logits[:, -1], axis=-1)[:, None].astype(pkg.int32) \
            if pkg is jnp else \
            torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        logits, caches = decode(params, tok, caches)
        out.append(logits)
    return out


def test_bf16_model_with_bf16_caches_matches_reference():
    """danube in bf16 (its published dtype) with bf16 caches: every step's
    logits bf16 in both packages, within bf16's precision."""
    cfg, rcfg, model, params, rmodel, rparams = pair("h2o-danube-1.8b",
                                                     dtype="bfloat16")
    tb, jb = batches(cfg)
    got = bf16_steps(torch, model, cfg, params, tb, torch.bfloat16)
    want = bf16_steps(jnp, rmodel, rcfg, rparams, jb, jnp.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        close(g, w, 3e-2)


def test_bf16_model_with_f32_caches_promotes_per_operation():
    """greedy_generate's default f32 caches under a bf16 model: a decode
    step's attention reads the f32 cache, so (JAX's promotion, made
    explicit) its output and the residual stream after it are f32.  The
    reference cannot run this step: its lax.scan refuses a carry that
    turns f32 (ROADMAP, faults).  The port's logits are f32 and agree
    within bf16's precision with the reference's f32 model on the same
    bf16-rounded weights."""
    cfg, rcfg, model, params, rmodel, rparams = pair("h2o-danube-1.8b",
                                                     dtype="bfloat16")
    tb, jb = batches(cfg)
    with pytest.raises(TypeError, match="carry"):
        bf16_steps(jnp, rmodel, rcfg, rparams, jb, jnp.float32)
    got = bf16_steps(torch, model, cfg, params, tb, torch.float32)
    assert [g.dtype for g in got] == [torch.bfloat16] + [torch.float32] * 2
    f32 = dataclasses.replace(rcfg, dtype="float32")
    want = bf16_steps(jnp, ref_build_model(f32), f32,
                      jax.tree.map(lambda a: a.astype(jnp.float32), rparams),
                      jb, jnp.float32)
    for g, w in zip(got, want):
        close(g, w, 3e-2)
    gen = PS.greedy_generate(model, cfg, params, tb, 3, device="cpu")
    assert gen.shape == (2, 3) and gen.dtype == torch.int32


def test_greedy_generate_raises_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("mamba2-370m").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    b = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.greedy_generate(model, cfg, params, b, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    assert PS.greedy_generate(model, cfg, params, b, 2,
                              device="cpu").shape == (1, 2)


def test_greedy_generate_refuses_another_device():
    cfg = get_config("mamba2-370m").reduced()
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="model is on"):
        PS.greedy_generate(model, cfg, model.init(0),
                           {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                           2, device="meta")


def test_serve_step_is_not_in_the_serve_package_all():
    import repro_torch.serve as S
    assert "greedy_generate" not in S.__all__
    assert set(PS.__all__) == set(RS.__all__)


def load_example():
    path = ROOT / "examples" / "torch_serve_lm.py"
    spec = importlib.util.spec_from_file_location("torch_serve_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_lm_example_on_cpu(capsys):
    ex = load_example()
    out = ex.run("cpu", max_new=3, batch=2, prompt_len=8)
    lines = capsys.readouterr().out.strip().splitlines()
    assert list(out) == ex.ARCHS == SERVE_ARCHS
    assert len(lines) == 4
    for name, line in zip(ex.ARCHS, lines):
        assert line.startswith(f"{name:18s} generated (2, 3) in ")
        assert line.endswith("tok/s, reduced config)")
        assert out[name]["shape"] == [2, 3] and out[name]["tokens_per_s"] > 0


def test_serve_lm_example_main_takes_the_reference_flags(capsys):
    ex = load_example()
    out = ex.main(["--max-new", "2", "--batch", "1", "--prompt-len", "4",
                   "--device", "cpu"])
    assert all(v["shape"] == [1, 2] for v in out.values())
    assert "reduced config" in capsys.readouterr().out
