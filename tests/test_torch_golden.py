"""The L=100 golden values of ``chip_smoke.py``, recomputed from JAX.

``chip_smoke.py`` holds the card to the JAX reference at full width through
constants: energies, per-replica flips and sha256 digests of the spins and
LFSR states after 16 sweeps (int8), and energies and flips at the f32
default, whose LFSR digest is the int8 one; the same for the reference's
(2,2,2) mesh; and for its general-graph engines on the same instance
(f32 ``GibbsEngine``, int8 ``DSIMEngine`` on K=8 bricks), started from the
script's ``graph_m0`` spins.  This test recomputes them with the JAX
package on the CPU, so they cannot drift from the reference.
"""

import hashlib
import importlib.util
import warnings
from pathlib import Path

import numpy as np

from repro.core.annealing import ea_schedule
from repro.engines.registry import make_engine

ROOT = Path(__file__).resolve().parents[1]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(precision, R):
    smoke = chip_smoke()
    with warnings.catch_warnings():
        # the TPU VMEM model warns about a 100^3 brick; irrelevant here
        warnings.simplefilter("ignore", RuntimeWarning)
        h = make_engine("lattice", L=smoke.L, seed=smoke.SEED, replicas=R,
                        precision=precision, impl="ref")
    st, rec = h.run_recorded(h.init_state(seed=smoke.SEED), ea_schedule(16),
                             [8, 16], sync_every=smoke.SYNC)
    return smoke.GOLDEN, st, np.asarray(rec.energies)


def test_int8_golden_values_match_jax():
    golden, st, energies = run_jax("int8", 2)
    assert energies.tolist() == golden["energies"]
    assert np.asarray(st.flips).tolist() == golden["flips"]
    m = np.asarray(st.m)
    s = np.asarray(st.s)
    assert m.shape == (2, 100, 100, 100) and m.dtype == np.int8
    assert s.dtype == np.uint32
    assert hashlib.sha256(m.tobytes()).hexdigest() == golden["m_sha256"]
    assert hashlib.sha256(s.tobytes()).hexdigest() == golden["s_sha256"]


def test_bitplane_golden_lanes_match_jax():
    golden, st, energies = run_jax("bitplane", 32)
    assert energies[:, :2].tolist() == golden["energies"]
    assert np.asarray(st.flips)[:2].tolist() == golden["flips"]


def test_f32_golden_values_match_jax():
    """The default precision: its energies and flips (held to 0.5% on the
    card, whose tanh is not XLA's) and its LFSR states, which do not depend
    on the precision."""
    smoke = chip_smoke()
    golden, st, energies = run_jax("f32", 2)
    assert energies.tolist() == smoke.GOLDEN_F32["energies"]
    assert np.asarray(st.flips).tolist() == smoke.GOLDEN_F32["flips"]
    s = np.asarray(st.s)
    assert hashlib.sha256(s.tobytes()).hexdigest() == golden["s_sha256"]


MESH_REFERENCE = """
import hashlib, json, warnings
import numpy as np, jax
from jax.sharding import Mesh
from repro.core.annealing import ea_schedule
from repro.engines.registry import make_engine

mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2), ("x", "y", "z"))
out = {}
for prec, R in (("int8", 2), ("f32", 2), ("bitplane", 32)):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        h = make_engine("lattice", L=%(L)d, seed=%(seed)d, replicas=R,
                        precision=prec, impl="ref", mesh=mesh,
                        dim_axes=("x", "y", "z"))
    st, rec = h.run_recorded(h.init_state(seed=%(seed)d), ea_schedule(16),
                             [8, 16], sync_every=%(sync)d)
    sha = lambda a: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()
    out[prec] = dict(energies=np.asarray(rec.energies)[:, :2].tolist(),
                     flips=np.asarray(st.flips)[:2].tolist(),
                     m_sha256=sha(st.m), s_sha256=sha(np.asarray(st.s)[:2]))
print(json.dumps(out))
"""


def test_mesh_golden_values_match_jax_on_8_devices():
    """``MESH_GOLDEN``: the JAX reference's (2,2,2) mesh on 8 forced host
    devices at L=100 (int8 R=2; f32 and bit-plane R=32 lanes 0-1 give the
    same energies and flips, and every LFSR digest is the int8 one)."""
    import json
    import os
    import subprocess
    import sys
    smoke = chip_smoke()
    code = MESH_REFERENCE % dict(L=smoke.L, seed=smoke.SEED, sync=smoke.SYNC)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    golden = smoke.MESH_GOLDEN
    assert out["int8"] == golden
    for prec in ("f32", "bitplane"):
        assert out[prec]["energies"] == golden["energies"]
        assert out[prec]["flips"] == golden["flips"]
        assert out[prec]["s_sha256"] == golden["s_sha256"]


def graph_engines_jax():
    from repro.core.coloring import lattice3d_coloring
    from repro.core.graph import ea3d
    smoke = chip_smoke()
    return smoke, ea3d(smoke.L, seed=smoke.SEED), \
        lattice3d_coloring(smoke.L), smoke.graph_m0(smoke.L ** 3)


def test_gibbs_golden_values_match_jax():
    """``GIBBS_GOLDEN``: the reference's f32 Gibbs engine at L=100 (R=2,
    lfsr, every replica from graph_m0); the card holds its LFSR digest
    exactly and its energies and flips to 0.5%."""
    from repro.core.gibbs import GibbsEngine
    smoke, g, col, m0 = graph_engines_jax()
    eng = GibbsEngine(g, col, rng="lfsr")
    st = eng.init_state(seed=smoke.SEED, m0=m0, replicas=2)
    st, rec = eng.run_recorded_full(st, ea_schedule(16), [8, 16])
    golden = smoke.GIBBS_GOLDEN
    assert np.asarray(rec.energies).tolist() == golden["energies"]
    assert np.asarray(st.flips).tolist() == golden["flips"]
    s = np.asarray(st.rng)
    assert s.shape == (2, smoke.L ** 3) and s.dtype == np.uint32
    assert hashlib.sha256(s.tobytes()).hexdigest() == golden["s_sha256"]


def test_dsim_golden_values_match_jax():
    """``DSIM_GOLDEN``: the reference's int8 DSIM engine at L=100 on the
    (2,2,2) brick partition (K=8, sync_every=SYNC, R=2, lfsr, every
    replica from graph_m0), held bitwise on the card."""
    from repro.core.dsim import DSIMEngine, build_partitioned
    from repro.core.partition import brick_partition
    smoke, g, col, m0 = graph_engines_jax()
    L = smoke.L
    prob = build_partitioned(g, col, brick_partition((L, L, L),
                                                     smoke.BRICKS), 8)
    eng = DSIMEngine(prob, rng="lfsr", precision="int8")
    st = eng.init_state(seed=smoke.SEED, m0=m0, replicas=2)
    st, rec = eng.run_recorded(st, ea_schedule(16), [8, 16],
                               sync_every=smoke.SYNC)
    golden = smoke.DSIM_GOLDEN
    assert np.asarray(rec.energies).tolist() == golden["energies"]
    assert np.asarray(st.flips).tolist() == golden["flips"]
    m, s = np.asarray(st.m), np.asarray(st.rng)
    assert m.shape == s.shape == (2, 8, L ** 3 // 8)
    assert hashlib.sha256(m.tobytes()).hexdigest() == golden["m_sha256"]
    assert hashlib.sha256(s.tobytes()).hexdigest() == golden["s_sha256"]


DIST_REFERENCE = """
import hashlib, json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.annealing import ea_schedule
from repro.core.coloring import lattice3d_coloring
from repro.core.dsim import DSIMState, build_partitioned
from repro.core.dsim_dist import DistDSIMEngine
from repro.core.graph import ea3d
from repro.core.partition import brick_partition

L, seed, sync, K = %(L)d, %(seed)d, %(sync)d, 8
m0 = np.random.default_rng(%(m0_seed)d).choice(np.array([-1, 1], np.int8),
                                               size=L ** 3)
prob = build_partitioned(ea3d(L, seed=seed), lattice3d_coloring(L),
                         brick_partition((L, L, L), %(bricks)r), K)
gid = np.asarray(prob.global_ids)
mesh = Mesh(np.asarray(jax.devices()[:K]), ("data",))
sha = lambda a: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()
out = {}
for prec in ("int8", "f32"):
    d = DistDSIMEngine(prob, mesh, rng="lfsr", replicas=2, precision=prec)
    st = d.init_state(seed=seed)
    # every replica from graph_m0 (padding slots +1)
    m = np.where(gid < prob.n, m0[np.minimum(gid, prob.n - 1)], 1)
    m = jnp.asarray(np.repeat(m[:, None], 2, axis=1).astype(np.int8))
    st = d.shard_state(DSIMState(m=m, ghosts=d._exchange_host(m),
                                 macc=st.macc, rng=st.rng, sweep=st.sweep,
                                 flips=st.flips))
    st, rec = d.run_recorded(st, ea_schedule(16), [8, 16], sync_every=sync)
    out[prec] = dict(
        energies=np.asarray(rec.energies).tolist(),
        flips=np.asarray(st.flips).tolist(),
        # the stacked engine's (R, K, n_max) layout, and the dist one's
        m_sha256=sha(np.asarray(st.m).transpose(1, 0, 2)),
        s_sha256=sha(np.asarray(st.rng).transpose(1, 0, 2)),
        s_dist_sha256=sha(st.rng))
print(json.dumps(out))
"""


def test_dist_golden_values_match_jax_on_8_devices():
    """The reference's ``DistDSIMEngine`` on K=8 forced host devices at
    L=100 from ``graph_m0`` (sync_every=SYNC, R=2, lfsr): int8 reproduces
    ``DSIM_GOLDEN`` (energies, flips, and the spin and LFSR digests once
    transposed to the stacked engine's layout), and f32 (bitpack, its
    own LFSR stream ``lfsr_init(K*R*n_max, seed)``) gives ``DIST_GOLDEN``
    (energies and flips, held to 0.5% on the card, and the LFSR digest in
    the dist layout)."""
    import json
    import os
    import subprocess
    import sys
    smoke = chip_smoke()
    code = DIST_REFERENCE % dict(L=smoke.L, seed=smoke.SEED,
                                 sync=smoke.SYNC, m0_seed=smoke.GRAPH_M0_SEED,
                                 bricks=smoke.BRICKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    golden = smoke.DSIM_GOLDEN
    for f in ("energies", "flips", "m_sha256", "s_sha256"):
        assert out["int8"][f] == golden[f], f
    dist = smoke.DIST_GOLDEN
    assert out["f32"]["energies"] == dist["energies"]
    assert out["f32"]["flips"] == dist["flips"]
    assert out["f32"]["s_dist_sha256"] == dist["s_sha256"]


def test_apt_golden_values_match_jax(monkeypatch):
    """``APT_GOLDEN``: the JAX reference's APT+ICM (rng="lfsr", run
    eagerly, its uniforms from ``HostDraws(APT_DRAW_SEED)`` through a
    patched ``jax.random.uniform``) on the G81-shaped torus, from the
    port's initial state at ``SEED``."""
    import jax
    import jax.numpy as jnp
    from repro.core.apt_icm import APTICM, APTState
    from repro.core.coloring import greedy_coloring
    from repro.problems.maxcut import gset_like_toroidal, maxcut_to_ising
    from repro_torch.core.apt_icm import APTICM as PortAPT, HostDraws
    from repro_torch.core.coloring import Coloring
    from repro_torch.core.graph import IsingGraph as PortGraph
    from repro_torch.interop import state_to_numpy
    import torch
    smoke = chip_smoke()
    g = maxcut_to_ising(gset_like_toroidal(**smoke.G81))
    col = greedy_coloring(np.asarray(g.idx), np.asarray(g.w))
    betas = smoke.apt_betas()
    apt = APTICM(g, col, betas, chains=smoke.APT_CHAINS, rng="lfsr")
    port = PortAPT(PortGraph(idx=torch.from_numpy(np.array(g.idx)),
                             w=torch.from_numpy(np.array(g.w)),
                             h=torch.from_numpy(np.array(g.h))),
                   Coloring(col.colors), betas, chains=smoke.APT_CHAINS,
                   rng="lfsr", device="cpu")
    d = state_to_numpy(port.init_state(seed=smoke.SEED))
    st = APTState(m=jnp.asarray(d["m"]), E=jnp.asarray(d["E"]),
                  key=jax.random.PRNGKey(0), sweep=jnp.asarray(d["sweep"]),
                  swaps=jnp.asarray(d["swaps"]), icms=jnp.asarray(d["icms"]),
                  lfsr=jnp.asarray(d["lfsr"]))
    hd = HostDraws(smoke.APT_DRAW_SEED)
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
        jnp.asarray(hd.sample(shape, minval, maxval)))
    apt._step = apt._step_impl
    st, (ts, best) = apt.run(st, smoke.APT_GOLDEN_SWEEPS,
                             icm_every=smoke.APT_GOLDEN_ICM,
                             record_every=smoke.APT_GOLDEN_ICM)
    sha = lambda a: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()  # noqa: E731
    assert np.asarray(st.m).dtype == np.int8
    assert dict(m_sha256=sha(st.m), E_sha256=sha(st.E),
                lfsr_sha256=sha(st.lfsr), swaps=int(st.swaps),
                icms=int(st.icms), sweeps=ts.tolist(),
                best=best.tolist()) == smoke.APT_GOLDEN


def ref_lm_golden(smoke, name):
    """The JAX reference's ``greedy_generate`` and prefill logits on the
    port's ``init(LM_SEED)`` weights of ``name``'s reduced config, as
    ``chip_smoke.lm_digest`` keeps them."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models.lm import build_model as ref_build_model
    from repro.serve.serve_step import (cache_len_for, greedy_generate,
                                        make_prefill_step)
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_to_numpy
    from repro_torch.models.lm import build_model

    cfg = get_config(name).reduced()
    params = build_model(cfg, device="cpu").init(smoke.LM_SEED)
    rcfg = ref_get_config(name).reduced()
    rmodel = ref_build_model(rcfg)
    rparams = jax.tree.map(jnp.asarray, lm_params_to_numpy(params))
    batch = {k: jnp.asarray(v) for k, v in smoke.lm_prompt(cfg).items()}
    tokens = greedy_generate(rmodel, rcfg, rparams, batch, smoke.LM_MAX_NEW)
    B, S = smoke.LM_PROMPT
    s_max = S + smoke.LM_MAX_NEW
    caches = rmodel.init_cache(B, s_max if rcfg.encdec else cache_len_for(
        rcfg, s_max), dtype=jnp.float32)
    logits, _, _ = make_prefill_step(rmodel, rcfg)(rparams, batch, caches)
    return smoke.lm_digest(np.asarray(tokens), np.asarray(logits[:, -1]))


def test_lm_golden_values_match_jax():
    """``LM_GOLDEN``: the JAX reference's greedy tokens and prefill logits
    on the port's reduced-width weights, for every ``LM_GOLDEN_ARCHS``
    config (chip_smoke.py phase 11a holds the card to them)."""
    smoke = chip_smoke()
    got = {name: ref_lm_golden(smoke, name) for name in smoke.LM_GOLDEN_ARCHS}
    assert got == smoke.LM_GOLDEN


def ref_train_golden(smoke, name, int8):
    """The JAX reference's ``make_train_step`` on the port's reduced-width
    ``init(LM_SEED)`` weights of ``name`` over ``chip_smoke.train_batches``:
    each step's loss and gradient norm, as ``chip_smoke.train_digest``
    keeps them."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models.lm import build_model as ref_build_model
    from repro.train.optimizer import AdamW
    from repro.train.train_step import TrainState, make_train_step
    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_to_numpy
    from repro_torch.models.lm import build_model

    cfg = get_config(name).reduced()
    params = build_model(cfg, device="cpu").init(smoke.LM_SEED)
    rmodel = ref_build_model(ref_get_config(name).reduced())
    rparams = jax.tree.map(jnp.asarray, lm_params_to_numpy(params))
    opt = AdamW(lr=smoke.TRAIN_LR, warmup=smoke.TRAIN_WARMUP,
                int8_state=int8)
    state = TrainState(params=rparams, opt=opt.init(rparams))
    step = jax.jit(make_train_step(rmodel, opt))
    losses, norms = [], []
    for b in smoke.train_batches(cfg):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    return smoke.train_digest(losses, norms)


def test_train_golden_values_match_jax():
    """``TRAIN_GOLDEN``: the JAX reference's per-step loss and gradient
    norm on the port's reduced-width weights, for every ``TRAIN_RUNS``
    run (chip_smoke.py phase 12a holds the card to them)."""
    smoke = chip_smoke()
    got = {smoke.train_key(n, i): ref_train_golden(smoke, n, i)
           for n, i in smoke.TRAIN_RUNS}
    assert got == smoke.TRAIN_GOLDEN
