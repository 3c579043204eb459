"""The LM model zoo on the port (``repro_torch.models``) against the JAX
reference (``repro.models``) on the CPU, at reduced widths in f32.

Weights are drawn once by the port's ``init`` (host numpy) and handed to
the reference as numpy arrays (``interop.lm_params_to_numpy``), so both
packages compute the same function on the same inputs.  Tolerances: one
layer within 1e-5 of its output's largest magnitude, a whole model within
1e-4; routing integers, cache positions and shapes exactly.  The second
half mirrors ``tests/test_models.py`` case by case on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import blocks as R_blocks
from repro.models import layers as R
from repro.models import mamba2 as R_mamba2
from repro.models import moe as R_moe
from repro.models.lm import build_model as ref_build_model
from repro.models.lm import cross_entropy as ref_cross_entropy
from repro_torch.configs import get_config, list_configs
from repro_torch.interop import (lm_cache_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import blocks as P_blocks
from repro_torch.models import layers as P
from repro_torch.models import mamba2 as P_mamba2
from repro_torch.models import moe as P_moe
from repro_torch.models.lm import build_model, cross_entropy

LM_ARCHS = [n for n, c in list_configs().items() if c.family != "ising"]
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4


def T(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def J(tree):
    """A torch tree (dict/tuple/list) -> the same tree of jax arrays."""
    if isinstance(tree, dict):
        return {k: J(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(J(v) for v in tree)
    return jnp.asarray(tree.detach().numpy())


def N(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def close(got, want, tol):
    got, want = N(got), N(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, scale, err / scale)


def ref_cache(c):
    """A reference KVCache/Mamba2Cache (or tree of them) -> field dicts."""
    if isinstance(c, (R.KVCache, R_mamba2.Mamba2Cache)):
        return {f.name: np.asarray(getattr(c, f.name))
                for f in dataclasses.fields(c)}
    if isinstance(c, dict):
        return {k: ref_cache(v) for k, v in c.items()}
    return type(c)(ref_cache(v) for v in c)


def same_caches(got, want, tol):
    """Port cache fields (lm_cache_to_numpy) against the reference's:
    positions exactly, K/V and states within ``tol`` of their scale."""
    if isinstance(want, dict) and "pos" in want:
        np.testing.assert_array_equal(got["pos"], want["pos"])
        close(got["k"], want["k"], tol)
        close(got["v"], want["v"], tol)
    elif isinstance(want, dict) and "ssm" in want:
        close(got["ssm"], want["ssm"], tol)
        close(got["conv"], want["conv"], tol)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            same_caches(got[k], want[k], tol)
    else:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same_caches(g, w, tol)


def port_cache(c):
    """One port KVCache/Mamba2Cache -> field dicts of numpy arrays."""
    return lm_cache_to_numpy({"c": (c,)})["c"][0]


# ---------------------------------------------------------------- layers


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    got = P.rms_norm({"scale": T(scale)}, T(x))
    close(got, R.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
          LAYER_TOL)


def test_rms_norm_keeps_bf16():
    x = torch.ones(2, 3, 8, dtype=torch.bfloat16)
    y = P.rms_norm(P.init_rms(8, torch.bfloat16), x)
    assert y.dtype == torch.bfloat16


def test_rope_freqs_are_the_reference():
    np.testing.assert_array_equal(P.rope_freqs(80, 10000.0),
                                  R.rope_freqs(80, 10000.0))


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    f = np.asarray(P.rope_freqs(16), np.float32)
    gq, gk = P.apply_rope(T(q), T(k), T(pos), T(f))
    wq, wk = R.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                          jnp.asarray(f))
    close(gq, wq, LAYER_TOL)
    close(gk, wk, LAYER_TOL)


def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos3 = rng.integers(0, 300, (3, 2, 6)).astype(np.int32)
    f = np.asarray(P.rope_freqs(16), np.float32)
    gq, gk = P.apply_mrope(T(q), T(k), T(pos3), T(f), (2, 3, 3))
    wq, wk = R.apply_mrope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos3),
                           jnp.asarray(f), (2, 3, 3))
    close(gq, wq, LAYER_TOL)
    close(gk, wk, LAYER_TOL)
    with pytest.raises(ValueError):
        P.apply_mrope(T(q), T(k), T(pos3), T(f), (2, 3, 2))


def test_init_dense_scales_and_casts():
    p = P.init_dense(np.random.default_rng(0), 256, 512, torch.bfloat16)
    assert p["w"].dtype == torch.bfloat16 and p["w"].shape == (256, 512)
    std = float(p["w"].float().std())
    assert abs(std - 1 / 16) < 0.002
    # the same stream gives the same weights
    again = P.init_dense(np.random.default_rng(0), 256, 512, torch.bfloat16)
    assert torch.equal(p["w"], again["w"])


D_MODEL, N_HEADS, D_HEAD = 64, 4, 16


def attn_params(n_kv, seed=0):
    return P.init_attention(np.random.default_rng(seed), D_MODEL, N_HEADS,
                            n_kv, D_HEAD)


# mode -> (S, window, n_kv, causal, cache: (smax, pos) or None, cross)
ATTN_MODES = {
    "causal": (12, None, 2, True, None, False),
    "causal_mha": (12, None, 4, True, None, False),
    "bidirectional": (12, None, 2, False, None, False),
    "window": (20, 6, 2, True, None, False),
    "chunked": (2048, None, 2, True, None, False),
    "chunked_window": (2048, 300, 2, True, None, False),
    "cache_prefill": (10, None, 2, True, (16, 0), False),
    "cache_decode": (1, None, 2, True, (16, 9), False),
    "cache_window_decode": (1, 4, 2, True, (16, 11), False),
    "cache_clamped": (4, None, 2, True, (16, 14), False),
    "ring_prefill_ge_smax": (20, 8, 2, True, (8, 0), False),
    "ring_prefill_lt_smax": (5, 8, 2, True, (8, 0), False),
    "ring_prefill_after": (5, 8, 2, True, (8, 6), False),
    "ring_chunked_prefill": (2048, 1100, 2, True, (1100, 0), False),
    "ring_decode_full": (1, 8, 2, True, (8, 13), False),
    "ring_decode_filling": (1, 8, 2, True, (8, 3), False),
    "cross": (9, None, 2, False, None, True),
}


@pytest.mark.parametrize("mode", list(ATTN_MODES))
def test_attention_fwd_matches_reference(mode):
    S, window, n_kv, causal, cache, cross = ATTN_MODES[mode]
    B = 1 if S >= 2048 else 2
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, D_MODEL)).astype(np.float32)
    base = 0 if cache is None else cache[1]
    pos = np.broadcast_to(base + np.arange(S), (B, S)).astype(np.int32)
    kv_x = rng.standard_normal((B, 7, D_MODEL)).astype(np.float32) \
        if cross else None
    f = np.asarray(P.rope_freqs(D_HEAD), np.float32)
    p = attn_params(n_kv)
    kw = dict(n_heads=N_HEADS, n_kv=n_kv, d_head=D_HEAD, causal=causal,
              window=window)
    pc = rc = None
    if cache is not None:
        smax, cpos = cache
        k0 = rng.standard_normal((B, n_kv, smax, D_HEAD)).astype(np.float32)
        v0 = rng.standard_normal((B, n_kv, smax, D_HEAD)).astype(np.float32)
        pc = P.KVCache(k=T(k0), v=T(v0), pos=T(np.int32(cpos)))
        rc = R.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                       pos=jnp.asarray(np.int32(cpos)))
    got, gc = P.attention_fwd(p, T(x), T(pos), T(f), cache=pc,
                              kv_x=None if kv_x is None else T(kv_x), **kw)
    want, wc = R.attention_fwd(J(p), jnp.asarray(x), jnp.asarray(pos),
                               jnp.asarray(f), cache=rc,
                               kv_x=None if kv_x is None
                               else jnp.asarray(kv_x), **kw)
    close(got, want, LAYER_TOL)
    if cache is None:
        assert gc is None and wc is None
    else:
        same_caches(port_cache(gc), ref_cache(wc), LAYER_TOL)
        # the cache given is left as it was
        assert torch.equal(pc.k, T(k0)) and int(pc.pos) == cache[1]


def test_attention_cache_overflow_raises():
    p = attn_params(2)
    c = P.init_kv_cache(1, 2, 4, D_HEAD, torch.float32, device="cpu")
    x = torch.zeros(1, 6, D_MODEL)
    with pytest.raises(ValueError):
        P.attention_fwd(p, x, torch.zeros(1, 6, dtype=torch.int32),
                        torch.tensor(P.rope_freqs(D_HEAD), dtype=torch.float32),
                        n_heads=N_HEADS, n_kv=2, d_head=D_HEAD, cache=c)


def test_gqa_repeats_each_kv_head_in_place():
    """Head h reads K/V head h // rep (jnp.repeat), not h % Hkv."""
    B, S, H, Hkv, Dh = 1, 3, 4, 2, 2
    q = torch.zeros(B, S, H, Dh)
    k = torch.zeros(B, S, Hkv, Dh)
    v = torch.zeros(B, S, Hkv, Dh)
    v[:, :, 1] = 1.0
    mask = torch.ones(B, 1, S, S, dtype=torch.bool)
    out = P._sdpa(q, k, v, mask, Dh)
    assert out[0, 0, :, 0].tolist() == [0.0, 0.0, 1.0, 1.0]


def test_fully_masked_row_is_uniform_not_nan():
    q = torch.randn(1, 2, 2, 4, generator=torch.Generator().manual_seed(0))
    k = torch.ones(1, 3, 2, 4)
    v = torch.arange(3.0)[None, :, None, None].expand(1, 3, 2, 4)
    mask = torch.zeros(1, 1, 2, 3, dtype=torch.bool)
    out = P._sdpa(q, k, v, mask, 4)
    assert torch.allclose(out, torch.ones_like(out))


def test_sdpa_promotes_bf16_queries_against_f32_cache():
    """The reference's einsum promotes bf16 x f32 to f32 (greedy_generate
    builds f32 caches under a bf16 model); the port does the same."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 5, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 5, 2, 16)).astype(np.float32)
    mask = np.ones((1, 1, 1, 5), bool)
    got = P._sdpa(T(q, torch.bfloat16), T(k), T(v), T(mask), 16)
    want = R._sdpa(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k),
                   jnp.asarray(v), jnp.asarray(mask), 16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close(got, np.asarray(want), 1e-2)


def test_mlp_fwd_matches_reference():
    p = P.init_mlp(np.random.default_rng(5), D_MODEL, 128)
    x = np.random.default_rng(6).standard_normal((2, 9, D_MODEL)).astype(
        np.float32)
    close(P.mlp_fwd(p, T(x)), R.mlp_fwd(J(p), jnp.asarray(x)), LAYER_TOL)


# ---------------------------------------------------------------- mamba2


def test_init_mamba2_dt_bias_and_a_log_are_the_reference_bits():
    p = P_mamba2.init_mamba2(np.random.default_rng(0), 32, 16, headdim=16)
    r = R_mamba2.init_mamba2(jax.random.PRNGKey(0), 32, 16, headdim=16)
    for k in ("dt_bias", "A_log", "D"):
        np.testing.assert_array_equal(N(p[k]), np.asarray(r[k]))
    assert {k: tuple(N(v).shape) for k, v in p.items() if k != "norm"
            and not isinstance(v, dict)} == \
        {k: tuple(np.shape(v)) for k, v in r.items() if k != "norm"
         and not isinstance(v, dict)}


def mamba_case(S, seed=7, d=32, n=16, hd=16):
    p = P_mamba2.init_mamba2(np.random.default_rng(seed), d, n, headdim=hd)
    x = np.random.default_rng(seed + 1).standard_normal((2, S, d)).astype(
        np.float32)
    return p, x, dict(d_state=n, headdim=hd)


@pytest.mark.parametrize("S,chunk", [(24, 8), (21, 8), (16, 16), (5, 16)])
def test_mamba2_chunked_matches_reference(S, chunk):
    p, x, kw = mamba_case(S)
    got, gc = P_mamba2.mamba2_fwd(p, T(x), chunk=chunk, **kw)
    want, wc = R_mamba2.mamba2_fwd(J(p), jnp.asarray(x), chunk=chunk, **kw)
    assert gc is None and wc is None
    close(got, want, LAYER_TOL)


def test_segsum_matches_reference():
    x = np.random.default_rng(8).standard_normal((2, 3, 6)).astype(np.float32)
    got, want = N(P_mamba2._segsum(T(x))), np.asarray(R_mamba2._segsum(
        jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    close(got[fin], want[fin], LAYER_TOL)


def test_mamba2_prefill_then_recurrent_steps_match_reference():
    """Chunked prefill into a cache, then three exact recurrent steps,
    each output and cache (conv window, f32 state) against the
    reference."""
    p, x, kw = mamba_case(20)
    pc = P_mamba2.init_mamba2_cache(2, 64, 16, 4, 16, torch.float32,
                                    device="cpu")
    rc = R_mamba2.init_mamba2_cache(2, 64, 16, 4, 16, jnp.float32)
    got, pc = P_mamba2.mamba2_fwd(p, T(x[:, :17]), chunk=8, cache=pc, **kw)
    want, rc = R_mamba2.mamba2_fwd(J(p), jnp.asarray(x[:, :17]), chunk=8,
                                   cache=rc, **kw)
    close(got, want, LAYER_TOL)
    same_caches(port_cache(pc), ref_cache(rc), LAYER_TOL)
    for t in range(17, 20):
        got, pc = P_mamba2.mamba2_fwd(p, T(x[:, t:t + 1]), chunk=8,
                                      cache=pc, **kw)
        want, rc = R_mamba2.mamba2_fwd(J(p), jnp.asarray(x[:, t:t + 1]),
                                       chunk=8, cache=rc, **kw)
        close(got, want, LAYER_TOL)
        same_caches(port_cache(pc), ref_cache(rc), LAYER_TOL)


def test_mamba2_bf16_decode_keeps_f32_state():
    """bf16 activations against the f32 state (mamba2.py:168-178): the
    state stays f32, the conv window takes the activations' dtype, the
    output is bf16; values as the reference's within bf16's precision."""
    p, x, kw = mamba_case(1)
    keep32 = ("A_log", "D", "dt_bias")
    pb = {k: v if k in keep32 else jax.tree.map(
        lambda t: t.to(torch.bfloat16), v) for k, v in p.items()}
    c = P_mamba2.init_mamba2_cache(2, 64, 16, 4, 16, torch.float32,
                                   device="cpu")
    got, gc = P_mamba2.mamba2_fwd(pb, T(x, torch.bfloat16), chunk=8, cache=c,
                                  **kw)
    rpb = jax.tree.map(lambda a: jnp.asarray(np.asarray(a.float()),
                                             jnp.bfloat16)
                       if a.dtype == torch.bfloat16 else jnp.asarray(N(a)), pb)
    want, wc = R_mamba2.mamba2_fwd(
        rpb, jnp.asarray(x, jnp.bfloat16), chunk=8,
        cache=R_mamba2.init_mamba2_cache(2, 64, 16, 4, 16, jnp.float32), **kw)
    assert got.dtype == torch.bfloat16 and gc.ssm.dtype == torch.float32
    assert gc.conv.dtype == torch.bfloat16 and wc.conv.dtype == jnp.bfloat16
    close(got.float(), np.asarray(want, np.float32), 2e-2)


# ---------------------------------------------------------------- MoE


def ref_dispatch(probs, top_k, capacity_factor):
    """moe.py:322-344's routing, in JAX, on the given probabilities."""
    T_, E = probs.shape
    topv, topi = jax.lax.top_k(probs, top_k)
    eid = topi.reshape(-1)
    order = jnp.argsort(eid)
    eid_s = eid[order]
    counts = jnp.zeros((E,), jnp.int32).at[eid_s].add(1)
    offsets = jnp.cumsum(counts) - counts
    pos = jnp.arange(T_ * top_k) - offsets[eid_s]
    cap = int(np.ceil(T_ * top_k / E * capacity_factor / 8.0) * 8)
    keep = pos < cap
    dest = jnp.where(keep, eid_s * cap + pos, E * cap)
    src = jnp.repeat(jnp.arange(T_), top_k)
    return {"topi": topi, "eid_s": eid_s, "src_s": src[order],
            "counts": counts, "cap": cap, "keep": keep, "dest": dest}


def moe_params(router=None, shared=0, seed=0, E=4, d=16):
    p = P_moe.init_moe(np.random.default_rng(seed), d, 32, n_experts=E,
                       n_shared=shared, d_ff_shared=64 if shared else None)
    if router is not None:
        p["router"] = T(router)
    return p


def forced_router(d=16, E=4):
    r = np.zeros((d, E), np.float32)
    r[:, 0] = 100.0
    return r


# case -> (router, shared, top_k, capacity_factor, tokens per row)
MOE_CASES = {
    "random_top2": (None, 0, 2, 8.0, 32),
    "random_top1": (None, 0, 1, 1.25, 32),
    "shared_experts": (None, 2, 2, 1.25, 24),
    "zero_router_ties": (np.zeros((16, 4), np.float32), 0, 2, 8.0, 32),
    "capacity_drops": ("forced", 0, 1, 0.25, 64),
    "capacity_drops_top2": ("forced", 0, 2, 0.5, 40),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_fwd_local_matches_reference(case):
    router, shared, k, cf, S = MOE_CASES[case]
    if isinstance(router, str):
        router = forced_router()
    p = moe_params(router, shared)
    x = np.random.default_rng(9).standard_normal((2, S, 16)).astype(
        np.float32)
    got, gaux = P_moe._moe_fwd_local(p, T(x), top_k=k, capacity_factor=cf)
    want, waux = R_moe._moe_fwd_local(J(p), jnp.asarray(x), top_k=k,
                                      capacity_factor=cf)
    close(got, want, LAYER_TOL)
    assert abs(float(gaux) - float(waux)) <= LAYER_TOL * max(1.0, float(waux))
    got2, _ = P_moe.moe_fwd(p, T(x), top_k=k, capacity_factor=cf)
    assert torch.equal(got, got2)
    # the routing integers bitwise, on the reference's own probabilities
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 16)
                           @ jnp.asarray(N(p["router"])), axis=-1)
    mine = P_moe._dispatch(T(np.asarray(probs)), k, cf)
    ref = ref_dispatch(probs, k, cf)
    assert mine["cap"] == ref["cap"]
    for key in ("topi", "eid_s", "src_s", "counts", "keep", "dest"):
        np.testing.assert_array_equal(N(mine[key]), np.asarray(ref[key]),
                                      err_msg=key)
    if case.startswith("capacity"):
        assert not bool(mine["keep"].all())
    if case == "zero_router_ties":
        # every probability ties: the lowest indices win, as lax.top_k
        assert N(mine["topi"]).tolist() == [[0, 1]] * (2 * S)


# ---------------------------------------------------------------- blocks

BLOCK_SPECS = [("attn", "dense"), ("swa", "dense"), ("attn", None),
               ("mamba", None), ("mamba", "dense"), ("mamba", "moe"),
               ("attn", "moe"), ("cross_attn", "dense")]


def block_cfg():
    return get_config("jamba-v0.1-52b").reduced(), \
        ref_get_config("jamba-v0.1-52b").reduced()


@pytest.mark.parametrize("mixer,ffn", BLOCK_SPECS)
@pytest.mark.parametrize("cached", [False, True])
def test_block_fwd_matches_reference(mixer, ffn, cached):
    cfg, rcfg = block_cfg()
    cfg = dataclasses.replace(cfg, window=8)
    rcfg = dataclasses.replace(rcfg, window=8)
    spec, rspec = P_blocks.BlockSpec(mixer, ffn), R_blocks.BlockSpec(mixer,
                                                                     ffn)
    p = P_blocks.init_block(np.random.default_rng(10), spec, cfg,
                            torch.float32)
    rng = np.random.default_rng(11)
    B, S = 2, 12
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    enc = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    f = np.asarray(P.rope_freqs(cfg.d_head), np.float32)
    pc = rc = None
    if cached:
        pc = P_blocks.init_block_cache(spec, cfg, B, 16, torch.float32,
                                       device="cpu")
        rc = R_blocks.init_block_cache(rspec, rcfg, B, 16, jnp.float32)
    kw = dict(enc_out=T(enc)) if mixer == "cross_attn" else {}
    rkw = dict(enc_out=jnp.asarray(enc)) if mixer == "cross_attn" else {}
    got, gc, gaux = P_blocks.block_fwd(p, spec, cfg, T(x), T(pos), T(f),
                                       cache=pc, **kw)
    want, wc, waux = R_blocks.block_fwd(J(p), rspec, rcfg, jnp.asarray(x),
                                        jnp.asarray(pos), jnp.asarray(f),
                                        cache=rc, **rkw)
    close(got, want, LAYER_TOL)
    assert abs(float(gaux) - float(waux)) <= LAYER_TOL * max(1.0, float(waux))
    if cached:
        same_caches(port_cache(gc), ref_cache(wc), LAYER_TOL)


def test_block_cache_shapes_match_reference():
    cfg, rcfg = block_cfg()
    for mixer in ("attn", "swa", "cross_attn", "mamba"):
        got = port_cache(P_blocks.init_block_cache(
            P_blocks.BlockSpec(mixer, None), cfg, 3, 40, torch.float32,
            device="cpu"))
        want = ref_cache(R_blocks.init_block_cache(
            R_blocks.BlockSpec(mixer, None), rcfg, 3, 40, jnp.float32))
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}


# ---------------------------------------------------------------- models


@pytest.fixture(scope="module")
def zoo():
    """name -> (cfg, port model, port params, reference model, reference
    params): the port's init(seed=0) carried to the reference."""
    out = {}
    for name in LM_ARCHS:
        cfg = get_config(name).reduced()
        model = build_model(cfg, device="cpu")
        params = model.init(0)
        rmodel = ref_build_model(ref_get_config(name).reduced())
        rparams = jax.tree.map(jnp.asarray, lm_params_to_numpy(params))
        out[name] = (cfg, model, params, rmodel, rparams)
    return out


def np_batch(cfg, B=2, S=16, seed=12):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "mask": (rng.random((B, S)) < 0.8).astype(np.int32)}
    if cfg.encdec:
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    elif cfg.input_kind == "embeds3":
        del b["tokens"]
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * .1).astype(
            np.float32)
        b["positions3"] = rng.integers(0, S, (3, B, S)).astype(np.int32)
    return b


@pytest.mark.parametrize("name", LM_ARCHS)
def test_model_forward_and_loss_match_reference(zoo, name):
    cfg, model, params, rmodel, rparams = zoo[name]
    b = np_batch(cfg)
    tb = {k: T(v) for k, v in b.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if cfg.encdec:
        enc = model.encode(params, tb["frames"])
        renc = rmodel.encode(rparams, jb["frames"])
        close(enc, renc, MODEL_TOL)
        got, _ = model.decode(params, tb["tokens"], enc)
        want, _ = rmodel.decode(rparams, jb["tokens"], renc)
    else:
        got, _, gaux = model.forward(params, tb.get("tokens"),
                                     embeds=tb.get("embeds"),
                                     positions3=tb.get("positions3"))
        want, _, waux = rmodel.forward(rparams, jb.get("tokens"),
                                       embeds=jb.get("embeds"),
                                       positions3=jb.get("positions3"))
        assert abs(float(gaux) - float(waux)) <= MODEL_TOL * max(
            1.0, float(waux))
    close(got, want, MODEL_TOL)
    assert got.shape[-1] == cfg.vocab_padded
    gl, wl = model.loss(params, tb), rmodel.loss(rparams, jb)
    assert abs(float(gl) - float(wl)) <= MODEL_TOL * float(wl)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_params_cross_packages_both_ways(zoo, name):
    cfg, model, params, _, rparams = zoo[name]
    ref = ref_build_model(ref_get_config(name).reduced()).init(
        jax.random.PRNGKey(0))
    mine = lm_params_to_numpy(params)
    assert jax.tree.structure(ref) == jax.tree.structure(mine)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(mine)):
        assert np.shape(a) == b.shape and np.asarray(a).dtype == b.dtype
    back = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                                device="cpu")
    assert lm_params_to_numpy(back).keys() == mine.keys()
    for a, b in zip(jax.tree.leaves(mine),
                    jax.tree.leaves(lm_params_to_numpy(back))):
        np.testing.assert_array_equal(a, b)


def test_params_from_numpy_checks_the_group_count(zoo):
    cfg, _, params, _, _ = zoo["deepseek-7b"]
    tree = lm_params_to_numpy(params)
    other = dataclasses.replace(cfg, n_layers=3)
    with pytest.raises(ValueError):
        lm_params_from_numpy(other, tree, device="cpu")


@pytest.mark.parametrize("name", LM_ARCHS)
def test_init_cache_crosses_in_reference_shapes(zoo, name):
    cfg, model, _, rmodel, _ = zoo[name]
    got = lm_cache_to_numpy(model.init_cache(2, 24, dtype=torch.float32))
    want = ref_cache(rmodel.init_cache(2, 24, dtype=jnp.float32))
    shapes = lambda t: jax.tree.map(lambda a: (a.shape, a.dtype), t)  # noqa
    assert shapes(got) == shapes(want)


def test_init_is_deterministic_and_cast():
    cfg = get_config("jamba-v0.1-52b").reduced()
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    a = build_model(cfg, device="cpu").init(3)
    b = build_model(bf, device="cpu").init(3)
    # the bf16 weights are the f32 draw cast (the router, A_log, D and
    # dt_bias stay f32, as the reference's)
    la, lb = _leaves(a), _leaves(b)
    assert {t.dtype for t in lb} == {torch.bfloat16, torch.float32}
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x.to(y.dtype), y)
    assert all(torch.equal(x, y) for x, y in zip(
        la, _leaves(build_model(cfg, device="cpu").init(3))))


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    tg = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    got = cross_entropy(T(logits), T(tg), T(mask))
    want = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(tg),
                             jnp.asarray(mask))
    assert abs(float(got) - float(want)) <= LAYER_TOL * float(want)


# ------------------------------------- tests/test_models.py, case by case


def _batch_for(cfg, B=2, S=16):
    if cfg.encdec:
        return {"frames": torch.ones((B, S, cfg.d_model)),
                "tokens": torch.zeros((B, S), dtype=torch.int32),
                "targets": torch.zeros((B, S), dtype=torch.int32),
                "mask": torch.ones((B, S), dtype=torch.int32)}
    if cfg.input_kind == "embeds3":
        return {"embeds": torch.ones((B, S, cfg.d_model)),
                "positions3": torch.zeros((3, B, S), dtype=torch.int32),
                "targets": torch.zeros((B, S), dtype=torch.int32),
                "mask": torch.ones((B, S), dtype=torch.int32)}
    return {"tokens": torch.zeros((B, S), dtype=torch.int32),
            "targets": torch.zeros((B, S), dtype=torch.int32),
            "mask": torch.ones((B, S), dtype=torch.int32)}


def _leaves(tree):
    return [t for t in jax.tree.leaves(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))]


@pytest.mark.parametrize("name", LM_ARCHS)
def test_smoke_forward_loss_grad(zoo, name):
    """One forward + a backward pass on a reduced same-family config:
    correct shapes, finite loss, finite non-zero gradients (torch
    autograd); the loss equals the reference's on the same weights."""
    cfg, model, params, rmodel, rparams = zoo[name]
    params = jax.tree.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()), params,
        is_leaf=lambda t: isinstance(t, torch.Tensor))
    batch = _batch_for(cfg)
    loss = model.loss(params, batch)
    loss.backward()
    loss = float(loss.detach())
    assert np.isfinite(loss)
    assert loss < 2 * np.log(cfg.vocab) + 1
    gn = sum(float((t.grad.float() ** 2).sum()) for t in _leaves(params)
             if t.grad is not None)
    assert np.isfinite(gn) and gn > 0
    want = rmodel.loss(rparams, {k: jnp.asarray(N(v))
                                 for k, v in batch.items()})
    assert abs(loss - float(want)) <= MODEL_TOL * float(want)
    if not cfg.encdec:
        with torch.no_grad():
            logits, _, _ = model.forward(params, batch.get("tokens"),
                                         embeds=batch.get("embeds"),
                                         positions3=batch.get("positions3"))
        assert logits.shape == (2, 16, cfg.vocab_padded)


def decode_vs_forward(m, params, toks, frames=None, emb=None, p3=None,
                      pkg=torch):
    """(full forward's last position, prefill S-1 + one decode step):
    the reference's steps on either package's model."""
    B, S = toks.shape
    f32 = torch.float32 if pkg is torch else jnp.float32
    caches = m.init_cache(B, S + 8, dtype=f32)
    if frames is not None:
        enc = m.encode(params, frames)
        full, _ = m.decode(params, toks, enc)
        _, c2 = m.decode(params, toks[:, :-1], enc, caches=caches)
        last, _ = m.decode(params, toks[:, -1:], enc, caches=c2)
    elif emb is not None:
        full, _, _ = m.forward(params, embeds=emb, positions3=p3)
        _, c2, _ = m.forward(params, embeds=emb[:, :-1],
                             positions3=p3[:, :, :-1], caches=caches)
        last, _, _ = m.forward(params, embeds=emb[:, -1:],
                               positions3=p3[:, :, -1:], caches=c2)
    else:
        full, _, _ = m.forward(params, toks)
        _, c2, _ = m.forward(params, toks[:, :-1], caches=caches)
        last, _, _ = m.forward(params, toks[:, -1:], caches=c2)
    return N(full)[:, -1], N(last)[:, 0]


@pytest.mark.parametrize("name", LM_ARCHS)
def test_decode_matches_forward(zoo, name):
    cfg, model, params, rmodel, rparams = zoo[name]
    B, S = 2, 24
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = emb = p3 = None
    if cfg.encdec:
        frames = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    elif cfg.input_kind == "embeds3":
        emb = (rng.standard_normal((B, S, cfg.d_model)) * .1).astype(
            np.float32)
        p3 = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).astype(
            np.int32).copy()
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    full, last = decode_vs_forward(model, params, T(toks), opt(frames, T),
                                   opt(emb, T), opt(p3, T))
    rel = float(np.abs(last - full).max()) / float(np.abs(full).max())
    assert rel < 2e-2, rel
    rfull, rlast = decode_vs_forward(
        rmodel, rparams, jnp.asarray(toks), opt(frames, jnp.asarray),
        opt(emb, jnp.asarray), opt(p3, jnp.asarray), pkg=jnp)
    close(full, rfull, MODEL_TOL)
    close(last, rlast, MODEL_TOL)


def test_rolling_swa_long_decode(zoo):
    """Ring cache smaller than the sequence still reproduces windowed
    attention exactly — the long_500k mechanism; each step's logits and
    the ring against the reference's."""
    cfg, model, params, rmodel, rparams = zoo["h2o-danube-1.8b"]  # window 16
    S = 48
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, S)).astype(
        np.int32)
    full, _, _ = model.forward(params, T(toks))
    caches = model.init_cache(1, cfg.window, dtype=torch.float32)
    rc = rmodel.init_cache(1, cfg.window, dtype=jnp.float32)
    _, c2, _ = model.forward(params, T(toks[:, :S - 4]), caches=caches)
    _, rc, _ = rmodel.forward(rparams, jnp.asarray(toks[:, :S - 4]),
                              caches=rc)
    same_caches(lm_cache_to_numpy(c2), ref_cache(rc), MODEL_TOL)
    for t in range(S - 4, S):
        last, c2, _ = model.forward(params, T(toks[:, t:t + 1]), caches=c2)
        rlast, rc, _ = rmodel.forward(rparams, jnp.asarray(toks[:, t:t + 1]),
                                      caches=rc)
        close(last, rlast, MODEL_TOL)
    same_caches(lm_cache_to_numpy(c2), ref_cache(rc), MODEL_TOL)
    rel = float((last[:, 0] - full[:, -1]).abs().max()) / \
        float(full[:, -1].abs().max())
    assert rel < 2e-2


def test_mamba2_chunk_invariance():
    """SSD output must not depend on the chunk size (algebraic identity)."""
    p = P_mamba2.init_mamba2(np.random.default_rng(0), 32, 16, headdim=16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, 32)).astype(np.float32))
    outs = []
    for chunk in (4, 8, 24):
        y, _ = P_mamba2.mamba2_fwd(p, x, d_state=16, headdim=16, chunk=chunk)
        outs.append(N(y))
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-4, atol=2e-4)


def test_moe_routes_and_balances():
    p = P_moe.init_moe(np.random.default_rng(0), 16, 32, n_experts=4)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 16)).astype(np.float32))
    y, aux = P_moe.moe_fwd(p, x, top_k=2, capacity_factor=8.0)
    assert y.shape == x.shape
    assert np.isfinite(float(aux))
    # zero routing logits => near-uniform probs => aux ~ 1 (balanced)
    p["router"] = torch.zeros_like(p["router"])
    _, aux0 = P_moe.moe_fwd(p, x, top_k=2, capacity_factor=8.0)
    assert abs(float(aux0) - 1.0) < 0.1


def test_moe_capacity_drops():
    p = P_moe.init_moe(np.random.default_rng(0), 16, 32, n_experts=4)
    # force all tokens to expert 0 => capacity drop at small factor
    p["router"] = T(forced_router())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 16)).astype(np.float32))
    y_small, _ = P_moe.moe_fwd(p, x, top_k=1, capacity_factor=0.25)
    y_big, _ = P_moe.moe_fwd(p, x, top_k=1, capacity_factor=8.0)
    # dropped tokens contribute zero -> outputs differ
    assert float((y_small - y_big).abs().max()) > 1e-6


def test_cross_entropy_masking():
    logits = torch.zeros((1, 4, 8))
    targets = torch.zeros((1, 4), dtype=torch.int32)
    full = cross_entropy(logits, targets, torch.ones((1, 4)))
    assert abs(float(full) - np.log(8)) < 1e-5
    none = cross_entropy(logits, targets, torch.zeros((1, 4)))
    assert float(none) == 0.0


def test_exact_config_dimensions():
    """Assigned-architecture configs carry the published numbers."""
    c = get_config("deepseek-67b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (95, 8192, 64, 8, 22016, 102400)
    c = get_config("grok-1-314b")
    assert (c.moe_experts, c.moe_top_k, c.vocab) == (8, 2, 131072)
    c = get_config("deepseek-moe-16b")
    assert (c.moe_experts, c.moe_top_k, c.moe_shared) == (64, 6, 2)
    c = get_config("jamba-v0.1-52b")
    assert len(c.group) == 8
    assert sum(1 for b in c.group if b.mixer == "attn") == 1
    assert sum(1 for b in c.group if b.ffn == "moe") == 4
    c = get_config("mamba2-370m")
    assert c.ssm_state == 128 and c.d_ff == 0
    c = get_config("qwen2-vl-7b")
    assert c.mrope_sections == (16, 24, 24)
    c = get_config("h2o-danube-1.8b")
    assert c.window == 4096
    c = get_config("seamless-m4t-medium")
    assert c.encdec and c.enc_layers == 12 and c.vocab == 256206


@pytest.mark.parametrize("name", sorted(list_configs()))
def test_configs_equal_the_reference(name):
    """Every field of every config and of its reduced variant, and the
    derived values, as the reference's (dtypes by name)."""
    mine, ref = get_config(name), ref_get_config(name)
    for a, b in ((mine, ref), (mine.reduced(), ref.reduced())):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert fa == fb
        assert (a.n_groups, a.vocab_padded, a.d_head) == \
            (b.n_groups, b.vocab_padded, b.d_head)
        assert str(a.compute_dtype).split(".")[-1] == \
            np.dtype(b.compute_dtype).name
        assert [s.name for s in a.shapes()] == [s.name for s in b.shapes()]


def test_shape_cells_equal_the_reference():
    from repro.configs.base import SHAPES as RS
    from repro_torch.configs.base import SHAPES
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in RS.items()}


def test_build_model_raises_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("deepseek-7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", LM_ARCHS)
def test_chip_smoke_param_count_is_the_init_tree(zoo, name):
    """chip_smoke.lm_param_count (phase 12's table of what fits the card)
    counts the tree ``init`` builds, here on each reduced config."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg, _, params, _, _ = zoo[name]
    assert smoke.lm_param_count(cfg) == sum(t.numel()
                                            for t in _leaves(params))


def test_bf16_reference_params_cross_as_bf16():
    """A config at its published dtype: the reference's bf16 leaves (numpy
    of ml_dtypes' bfloat16) become torch bf16 tensors with the same
    values, its f32 leaves (router, SSM constants) stay f32."""
    rcfg = dataclasses.replace(ref_get_config("jamba-v0.1-52b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              dtype="bfloat16")
    ref = jax.tree.map(np.asarray, ref_build_model(rcfg).init(
        jax.random.PRNGKey(0)))
    mine = lm_params_from_numpy(cfg, ref, device="cpu")
    back = lm_params_to_numpy(mine)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.astype(np.float32), b)
    dtypes = {t.dtype for t in _leaves(mine)}
    assert dtypes == {torch.bfloat16, torch.float32}
