"""LM training on the port against the reference: ``tests/test_train.py``
case by case with imports from ``repro_torch`` and ``device="cpu"``, then
parity with the JAX package on the same inputs.

Tolerances: ``q8_encode``'s codes and scales and ``MarkovLM``'s samples
bitwise; one ``AdamW.update`` within 1 ulp of the reference's run op by
op (under ``jit`` XLA contracts ``b1 * m + (1 - b1) * g`` into fused
multiply-adds, the port's eager ops do not); four ``make_train_step``
steps from a carried state: each step's loss and gradient norm within
1e-5 relative, the parameters within 1e-3 (a third of one step at
lr=3e-3: near-zero gradients make Adam's m / sqrt(v) sensitive to the
last ulp); remat on == remat off bitwise.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import build_model
from repro_torch.serve.serve_step import cache_len_for, greedy_generate
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import MarkovLM, prefetch
from repro_torch.train.optimizer import (AdamW, OptState,
                                         clip_by_global_norm, q8_decode,
                                         q8_encode)
from repro_torch.train.train_step import (TrainState, make_train_step,
                                          sync_budget)
from repro_torch.train.tree import tree_leaves

CPU = "cpu"


def tensors(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# -- tests/test_train.py, case by case ---------------------------------------


def test_q8_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    for shape in [(130,), (4, 257), (3, 5, 128)]:
        x = torch.from_numpy(rng.normal(0, 2.0, shape).astype(np.float32))
        q, s = q8_encode(x)
        y = q8_decode(q, s, shape)
        blockmax = float(x.abs().max())
        assert float((y - x).abs().max()) <= blockmax / 127.0 + 1e-6


def test_clip_by_global_norm():
    g = {"a": torch.ones((10,)) * 3.0}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert abs(float(gn) - 3.0 * np.sqrt(10)) < 1e-4
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-4


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_converges_quadratic(int8):
    opt = AdamW(lr=0.1, warmup=1, weight_decay=0.0, int8_state=int8)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    st = opt.init(params)
    for _ in range(150):
        grads = {"w": params["w"]}          # d/dw (w^2/2)
        params, st = opt.update(grads, st, params)
    assert float(params["w"].abs().max()) < 0.1


def test_train_loss_decreases_both_optimizers():
    cfg = get_config("deepseek-7b").reduced()
    model = build_model(cfg, CPU)
    params = model.init(0)
    for int8 in (False, True):
        opt = AdamW(lr=3e-3, warmup=5, int8_state=int8)
        st = TrainState(params=params, opt=opt.init(params))
        step = make_train_step(model, opt)
        data = MarkovLM(cfg.vocab, seed=1)
        losses = []
        for i, b in zip(range(25), data.batches(8, 32)):
            st, m = step(st, tensors(b))
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.2, (int8, losses[0], losses[-1])


def test_grad_accum_equivalence():
    """Pre-split microbatch accumulation == single-batch gradients."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    model = build_model(cfg, CPU)
    params = model.init(0)
    opt = AdamW(lr=1e-3, warmup=1)
    data = MarkovLM(cfg.vocab, seed=2)
    toks = torch.from_numpy(data.sample(8, 32))
    b1 = {"tokens": toks, "targets": toks,
          "mask": torch.ones((8, 32), dtype=torch.int32)}
    b2 = {k: v.reshape(2, 4, 32) for k, v in b1.items()}
    s1 = TrainState(params=params, opt=opt.init(params))
    s2 = TrainState(params=params, opt=opt.init(params))
    s1, m1 = make_train_step(model, opt, grad_accum=1)(s1, b1)
    s2, m2 = make_train_step(model, opt, grad_accum=2)(s2, b2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert d < 1e-5


def test_checkpoint_roundtrip_and_retention(tmp_path):
    cfg = get_config("mamba2-370m").reduced()
    model = build_model(cfg, CPU)
    params = model.init(0)
    opt = AdamW()
    st = TrainState(params=params, opt=opt.init(params))
    for step in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), step, st, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    dirs = sorted(os.listdir(tmp_path))
    assert len([d for d in dirs if d.startswith("step_")]) == 2  # retention
    st2 = ckpt.restore(str(tmp_path), st)
    for a, b in zip(tree_leaves(st), tree_leaves(st2)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_checkpoint_shape_mismatch_raises(tmp_path):
    st = {"w": torch.zeros((4,))}
    ckpt.save(str(tmp_path), 1, st)
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"w": torch.zeros((5,))})


def test_markov_data_learnable_structure():
    data = MarkovLM(64, seed=0)
    toks = data.sample(4, 256, seed=1)
    assert toks.shape == (4, 256) and toks.max() < 64
    # order-1 structure: conditional entropy < unigram entropy
    uni = np.bincount(toks.ravel(), minlength=64) + 1e-9
    uni = uni / uni.sum()
    H_uni = -(uni * np.log(uni)).sum()
    pair = np.zeros((64, 64)) + 1e-9
    for row in toks:
        np.add.at(pair, (row[:-1], row[1:]), 1)
    cond = pair / pair.sum(axis=1, keepdims=True)
    H_cond = -(pair / pair.sum() * np.log(cond)).sum()
    assert H_cond < H_uni - 0.3


def test_prefetch_order():
    it = prefetch(iter(range(10)), depth=3)
    assert list(it) == list(range(10))


def test_sync_budget_design_rule():
    # tiny model, fast link: sync every step; huge model, slow link: rarely
    assert sync_budget(1e6, 0.1, 50e9) == 1
    assert sync_budget(2 * 314e9, 0.5, 50e9) > 10


def test_serve_greedy_generate_all_cache_kinds():
    for name in ("h2o-danube-1.8b", "mamba2-370m", "jamba-v0.1-52b",
                 "seamless-m4t-medium"):
        cfg = get_config(name).reduced()
        model = build_model(cfg, CPU)
        params = model.init(0)
        if cfg.encdec:
            batch = {"frames": torch.ones((2, 8, cfg.d_model)),
                     "tokens": torch.zeros((2, 4), dtype=torch.int32)}
        else:
            batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
        out = greedy_generate(model, cfg, params, batch, max_new=4,
                              device=CPU)
        assert tuple(out.shape) == (2, 4)
        assert bool((out >= 0).all()) and bool((out < cfg.vocab_padded).all())


def test_cache_len_for_swa():
    cfg = get_config("h2o-danube-1.8b")
    assert cache_len_for(cfg, 524288) == 4096      # rolling window
    cfg2 = get_config("deepseek-7b")
    assert cache_len_for(cfg2, 32768) == 32768


# -- parity with the reference ------------------------------------------------


@pytest.mark.parametrize("shape", [(130,), (4, 257), (3, 5, 128), (7, 1)])
def test_q8_codes_and_scales_bitwise_to_reference(shape):
    import jax.numpy as jnp
    from repro.train.optimizer import q8_decode as ref_decode
    from repro.train.optimizer import q8_encode as ref_encode
    rng = np.random.default_rng(len(shape))
    x = rng.normal(0, 2.0, shape).astype(np.float32)
    x.flat[::7] = 0.5 * np.round(x.flat[::7])      # halves: ties to even
    q, s = q8_encode(torch.from_numpy(x))
    rq, rs = ref_encode(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(s.numpy().view(np.int32),
                          np.asarray(rs).view(np.int32))
    assert np.array_equal(q8_decode(q, s, shape).numpy(),
                          np.asarray(ref_decode(rq, rs, shape)))


@pytest.mark.parametrize("vocab,seed", [(64, 0), (256, 1), (1000, 7)])
def test_markov_samples_bitwise_to_reference(vocab, seed):
    from repro.train.data import MarkovLM as RefMarkovLM
    mine, ref = MarkovLM(vocab, seed=seed), RefMarkovLM(vocab, seed=seed)
    assert np.array_equal(mine.cum, ref.cum)
    for _ in range(2):                               # the shared stream
        assert np.array_equal(mine.sample(3, 40), ref.sample(3, 40))
    assert np.array_equal(mine.sample(2, 9, seed=5), ref.sample(2, 9, seed=5))
    a, b = next(mine.batches(2, 8)), next(ref.batches(2, 8))
    assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "targets",
                                                     "mask"))


def ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_adamw_update_within_one_ulp_of_reference(int8):
    import jax.numpy as jnp
    from repro.train.optimizer import AdamW as RefAdamW
    from repro.train.optimizer import OptState as RefOptState
    from repro.train.optimizer import q8_encode as ref_encode
    rng = np.random.default_rng(3)
    shapes = {"a": (130,), "b": (4, 257), "c": (3, 5, 128)}
    p = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.normal(0, 1e-2, s).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: rng.normal(0, 1e-2, s).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: rng.uniform(0, 1e-4, s).astype(np.float32)
         for k, s in shapes.items()}
    J = lambda t: {k: jnp.asarray(x) for k, x in t.items()}  # noqa: E731
    if int8:
        enc = lambda t, f: {k: ref_encode(f(jnp.asarray(x)))  # noqa: E731
                            for k, x in t.items()}
        mq, vq = enc(m, lambda x: x), enc(v, jnp.sqrt)
        rstate = RefOptState(
            step=jnp.int32(2), m={k: c for k, (c, _) in mq.items()},
            v={k: c for k, (c, _) in vq.items()},
            m_scale={k: s for k, (_, s) in mq.items()},
            v_scale={k: s for k, (_, s) in vq.items()})
    else:
        rstate = RefOptState(step=jnp.int32(2), m=J(m), v=J(v),
                             m_scale=None, v_scale=None)
    T = lambda t: None if t is None else {  # noqa: E731
        k: torch.from_numpy(np.array(x)) for k, x in t.items()}
    state = OptState(step=torch.tensor(2, dtype=torch.int32), m=T(rstate.m),
                     v=T(rstate.v), m_scale=T(rstate.m_scale),
                     v_scale=T(rstate.v_scale))
    kw = dict(lr=1e-3, warmup=4, int8_state=int8)
    rp, rs = RefAdamW(**kw).update(J(g), rstate, J(p))     # op by op
    pp, ps = AdamW(**kw).update(T(g), state, T(p))
    assert int(ps.step) == int(rs.step) == 3
    for k in shapes:
        assert ulps(pp[k].numpy(), rp[k]) <= 1
        if int8:
            assert np.array_equal(ps.m[k].numpy(), np.asarray(rs.m[k]))
            assert np.array_equal(ps.v[k].numpy(), np.asarray(rs.v[k]))
            assert ulps(ps.m_scale[k].numpy(), rs.m_scale[k]) <= 1
            assert ulps(ps.v_scale[k].numpy(), rs.v_scale[k]) <= 1
        else:
            assert ulps(ps.m[k].numpy(), rs.m[k]) <= 1
            assert ulps(ps.v[k].numpy(), rs.v[k]) <= 1


STEP_CASES = [("deepseek-7b", False), ("deepseek-moe-16b", False),
              ("mamba2-370m", False), ("jamba-v0.1-52b", False),
              ("deepseek-7b", True)]


@pytest.mark.parametrize("name,int8", STEP_CASES,
                         ids=[f"{n}-{'int8' if i else 'f32'}"
                              for n, i in STEP_CASES])
def test_train_steps_from_carried_state_match_reference(name, int8):
    """The port's init carried to the reference; one reference step; its
    state carried back (``train_state_from_numpy``); then four steps on
    each package from the same state and the same batches."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models.lm import build_model as ref_build_model
    from repro.train.optimizer import AdamW as RefAdamW
    from repro.train.train_step import TrainState as RefTrainState
    from repro.train.train_step import make_train_step as ref_make
    from repro_torch.interop import (train_state_from_numpy,
                                     train_state_to_numpy)
    cfg = get_config(name).reduced()
    model = build_model(cfg, CPU)
    rcfg = ref_get_config(name).reduced()
    rmodel = ref_build_model(rcfg)
    opt = AdamW(lr=3e-3, warmup=5, int8_state=int8)
    ropt = RefAdamW(lr=3e-3, warmup=5, int8_state=int8)
    params = model.init(0)
    rparams = jax.tree.map(jnp.asarray,
                           train_state_to_numpy(TrainState(
                               params, opt.init(params)))["params"])
    rstate = RefTrainState(rparams, ropt.init(rparams))
    rstep = jax.jit(ref_make(rmodel, ropt))
    step = make_train_step(model, opt)
    batches = [tensors(b) for _, b in zip(range(5), MarkovLM(
        cfg.vocab, seed=1).batches(8, 32))]
    J = lambda b: {k: jnp.asarray(v.numpy()) for k, v in b.items()}  # noqa
    rstate, _ = rstep(rstate, J(batches[0]))
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate),
                                   device=CPU)
    back = train_state_to_numpy(state)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
        jax.tree.leaves(back["params"]), jax.tree.leaves(rstate.params)))
    for b in batches[1:]:
        state, m = step(state, b)
        rstate, rm = rstep(rstate, J(b))
        for key in ("loss", "grad_norm"):
            want = float(rm[key])
            assert abs(float(m[key]) - want) <= 1e-5 * abs(want), key
        assert int(m["step"]) == int(rm["step"])
    mine = train_state_to_numpy(state)
    d = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        jax.tree.leaves(mine["params"]), jax.tree.leaves(rstate.params)))
    assert d < 1e-3


def grads_of(cfg, params, batch):
    model = build_model(cfg, CPU)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    from repro_torch.train.tree import tree_flatten
    _, unflatten = tree_flatten(params)
    loss = model.loss(unflatten(leaves), batch, train=True)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name,S", [("h2o-danube-1.8b", 2048),
                                    ("jamba-v0.1-52b", 32),
                                    ("seamless-m4t-medium", 16)])
def test_remat_changes_no_gradient(name, S):
    """``train=True`` with remat on (each group, and each block of a
    one-block group, rematerialised; the chunked attention's chunks at
    S=2048) gives the gradients of remat off bitwise."""
    cfg = get_config(name).reduced()
    params = build_model(cfg, CPU).init(0)
    toks = torch.from_numpy(MarkovLM(cfg.vocab, seed=3).sample(1, S))
    batch = {"tokens": toks, "targets": toks,
             "mask": torch.ones_like(toks)}
    if cfg.encdec:
        batch["frames"] = torch.from_numpy(np.random.default_rng(0)
                                           .standard_normal(
            (1, S, cfg.d_model)).astype(np.float32))
    on = grads_of(cfg, params, batch)
    off = grads_of(dataclasses.replace(cfg, remat=False), params, batch)
    assert cfg.remat and torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


def test_four_chained_steps_amplify_one_ulp():
    """Why chip_smoke.py phase 13a holds each card step to a CPU step
    from the same state, not two chained runs to 1e-5: moving jamba's
    reduced weights by one ulp (a random sign per element) moves its
    fourth step's gradient norm by more than 1e-5 relative; the first
    step's by far less."""
    import importlib.util
    from pathlib import Path
    from repro_torch.train.tree import tree_map
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_config("jamba-v0.1-52b").reduced()
    gen = torch.Generator().manual_seed(0)
    nudge = lambda x: torch.nextafter(x, torch.where(  # noqa: E731
        torch.rand(x.shape, generator=gen) < 0.5, -torch.inf, torch.inf))
    norms = []
    for move in (False, True):
        model = build_model(cfg, CPU)
        params = model.init(smoke.LM_SEED)
        if move:
            params = tree_map(nudge, params)
        opt = AdamW(lr=smoke.TRAIN_LR, warmup=smoke.TRAIN_WARMUP)
        st, step = TrainState(params, opt.init(params)), make_train_step(
            model, opt)
        out = []
        for b in smoke.train_batches(cfg):
            st, m = step(st, tensors(b))
            out.append(float(m["grad_norm"]))
        norms.append(out)
    rel = [abs(a - b) / a for a, b in zip(*norms)]
    assert rel[0] < 1e-6 and rel[-1] > 1e-5, rel
