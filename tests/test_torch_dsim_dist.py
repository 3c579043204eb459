"""The port's distributed DSIM (``make_engine("dsim_dist")``) against the
JAX reference's ``DistDSIMEngine`` on forced host devices.

The port runs every partition in one process on the CPU (its default
mesh).  One reference subprocess (``XLA_FLAGS`` forcing 4 host devices,
K=2 or K=4 of them per case) runs every case of ``CASES`` from the port's
initial state, and writes its final state, record-point energies, flips,
global spins, the LFSR states of its own ``init_state``, its
``boundary_payload()`` and its ``dist_eta_meter``'s ``n_color`` and
``c_max`` to npz and JSON files.  The port is then held to them:

* int8 bitwise (spins, ghosts, window accumulators, LFSR states,
  per-replica flips, energies, global spins) over ``sync_every`` in
  {1, 4, "phase", None} x R in {1, 3} on a random regular graph cut by the
  greedy partitioner (partitions hold different numbers of sites of a
  colour, so padded colour slots occur: the reference's ``shard_map``
  scatter lets them rewrite a partition's slot 0, and the port writes the
  same values), at K=2, and on ``ea3d(8)`` cut into four slabs; one case
  starts its odometers just below 2^31 and wraps them;
* bit-plane bitwise at R=40 (two words) and R=5;
* f32 with ``bitpack`` True and False and cmft: LFSR states bitwise, the
  spins equal except near tanh ties (at most 1% differ; with none
  differing, every field bitwise); cmft at ``sync_every="phase"``
  publishes instantaneous +-1 boundaries;
* every case's initial LFSR states equal the reference's ``init_state``;
  ``boundary_payload()`` and ``dist_eta_meter`` equal the reference's.

Port-only checks follow: bit-plane lanes equal int8 replicas and are
prefix-stable, philox (another stream than the reference's) against LFSR
statistically, dist int8 equals the stacked engine's replicas, snapshot,
restore, checkpoint and ``interop`` round trips, and the guards.
"""

import functools
import json

import numpy as np
import pytest
import torch

from repro_torch import make_engine as t_make
from repro_torch.core import graph as t_graph
from repro_torch.core.annealing import ea_schedule
from repro_torch.core.coloring import greedy_coloring, lattice3d_coloring
from repro_torch.core.dsim import DSIMEngine, DSIMState, build_partitioned
from repro_torch.core.dsim_dist import DistDSIMEngine
from repro_torch.core.mesh import make_mesh
from repro_torch.core.partition import greedy_partition, slab_partition
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.obs.timing import dist_eta_meter
from test_torch_mesh import run_reference

CPU = dict(device="cpu")
FIELDS = ("m", "ghosts", "macc", "rng", "sweep", "flips")
SWEEPS, POINTS, INIT_SEED = 16, [8, 16], 4
WRAP = 2 ** 31 - 40

# name: (problem, K, precision, R, sync_every, mode, bitpack)
CASES = {
    **{f"reg4-int8-{s}-R{R}": ("regular", 4, "int8", R, s, "dsim", True)
       for s in (1, 4, "phase", None) for R in (1, 3)},
    "reg2-int8-4-R3": ("regular", 2, "int8", 3, 4, "dsim", True),
    "ea3d-int8-1-R3": ("ea3d", 4, "int8", 3, 1, "dsim", True),
    "reg4-int8-4-R3-wrap": ("regular", 4, "int8", 3, 4, "dsim", True),
    "reg4-bitplane-4-R40": ("regular", 4, "bitplane", 40, 4, "dsim", True),
    "reg2-bitplane-phase-R5": ("regular", 2, "bitplane", 5, "phase", "dsim",
                               True),
    "reg4-f32-4-R3": ("regular", 4, "f32", 3, 4, "dsim", True),
    "reg4-f32-1-R3-unpacked": ("regular", 4, "f32", 3, 1, "dsim", False),
    "ea3d-f32-phase-R2": ("ea3d", 4, "f32", 2, "phase", "dsim", True),
    "ea3d-cmft-phase-R1": ("ea3d", 2, "f32", 1, "phase", "cmft", True),
    "reg4-cmft-4-R3": ("regular", 4, "f32", 3, 4, "cmft", True),
}
INT8 = [n for n, c in CASES.items() if c[2] == "int8"]
BITPLANE = [n for n, c in CASES.items() if c[2] == "bitplane"]
F32 = [n for n, c in CASES.items() if c[2] == "f32"]

REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import graph as jg
from repro.core.annealing import ea_schedule
from repro.core.coloring import greedy_coloring, lattice3d_coloring
from repro.core.dsim import DSIMState, build_partitioned
from repro.core.dsim_dist import DistDSIMEngine
from repro.core.partition import greedy_partition, slab_partition
from repro.obs.timing import dist_eta_meter

out, cases = sys.argv[1], json.loads(sys.argv[2])

def problem(kind, K):
    if kind == "regular":
        g = jg.random_regular(48, 4, seed=3)
        col = greedy_coloring(np.asarray(g.idx), np.asarray(g.w))
        labels = greedy_partition(np.asarray(g.idx), np.asarray(g.w), K,
                                  seed=0)
    else:
        g, col, labels = jg.ea3d(8, seed=1), lattice3d_coloring(8), \\
            slab_partition(8, K)
    return build_partitioned(g, col, labels, K)

meta = {}
for name, (kind, K, prec, R, sync, mode, bp) in cases.items():
    mesh = Mesh(np.asarray(jax.devices()[:K]), ("data",))
    d = DistDSIMEngine(problem(kind, K), mesh, rng="lfsr", mode=mode,
                       bitpack=bp, replicas=R, precision=prec)
    z = np.load(f"{out}/{name}-in.npz")
    st = d.shard_state(DSIMState(**{f: jnp.asarray(z[f]) for f in
                                    ("m", "ghosts", "macc", "rng", "sweep",
                                     "flips")}))
    st, rec = d.run_recorded(st, ea_schedule(%(sweeps)d), %(points)r,
                             sync_every=sync)
    eta = dist_eta_meter(d)
    np.savez(f"{out}/{name}-out.npz",
             **{f: np.asarray(getattr(st, f)) for f in
                ("m", "ghosts", "macc", "rng", "sweep", "flips")},
             energies=np.asarray(rec.energies), total_flips=rec.flips,
             spins=np.asarray(d.global_spins(st)),
             init_rng=np.asarray(d.init_state(%(init_seed)d).rng))
    meta[name] = dict(payload=d.boundary_payload(), n_color=eta.n_color,
                      c_max=eta.c_max)
with open(f"{out}/meta.json", "w") as f:
    json.dump(meta, f)
""" % dict(sweeps=SWEEPS, points=POINTS, init_seed=INIT_SEED)


@functools.lru_cache(maxsize=None)
def problem(kind: str, K: int):
    if kind == "regular":
        g = t_graph.random_regular(48, 4, seed=3, **CPU)
        col = greedy_coloring(g.idx, g.w)
        labels = greedy_partition(g.idx, g.w, K, seed=0)
    else:
        g, col = t_graph.ea3d(8, seed=1, **CPU), lattice3d_coloring(8)
        labels = slab_partition(8, K)
    return build_partitioned(g, col, labels, K)


@functools.lru_cache(maxsize=None)
def handle(kind, K, prec, R, mode="dsim", bitpack=True):
    return t_make("dsim_dist", problem(kind, K), rng="lfsr",
                  precision=prec, replicas=R, mode=mode, bitpack=bitpack,
                  **CPU)


def start(name):
    """The case's engine and its initial state (odometers at WRAP for the
    wrap case)."""
    kind, K, prec, R, sync, mode, bp = CASES[name]
    h = handle(kind, K, prec, R, mode, bp)
    st = h.init_state(seed=INIT_SEED)
    if name.endswith("wrap"):
        st.flips = torch.full((R,), WRAP, dtype=torch.int32)
    return h, st


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dsim_dist_ref")
    for name in CASES:
        np.savez(out / f"{name}-in.npz", **state_to_numpy(start(name)[1]))
    run_reference(REFERENCE, [str(out), json.dumps(CASES)], devices=4)
    return out, json.loads((out / "meta.json").read_text())


def run(name):
    h, st0 = start(name)
    st, rec = h.eng.run_recorded(st0, ea_schedule(SWEEPS), POINTS,
                                 sync_every=CASES[name][4])
    return h, st0, st, rec


def assert_fields(ref, st, fields=FIELDS):
    got = state_to_numpy(st)
    for f in fields:
        assert got[f].dtype == ref[f].dtype and \
            got[f].shape == ref[f].shape, f
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


@pytest.mark.parametrize("name", INT8 + BITPLANE)
def test_fixed_point_matches_reference_bitwise(reference, name):
    out, _ = reference
    ref = np.load(out / f"{name}-out.npz")
    h, st0, st, rec = run(name)
    np.testing.assert_array_equal(state_to_numpy(st0)["rng"],
                                  ref["init_rng"])
    assert_fields(ref, st)
    np.testing.assert_array_equal(rec.energies.numpy(), ref["energies"])
    assert rec.flips == int(ref["total_flips"]) > 0
    np.testing.assert_array_equal(h.eng.global_spins(st).numpy(),
                                  ref["spins"])
    if CASES[name][:2] == ("regular", 4):
        # the greedy partition pads colour slot lists
        assert any(c.lost is not None for c in h.eng._colors)
    if name.endswith("wrap"):
        assert (st.flips < 0).all()
        assert rec.flips == int(
            ((st.flips.long() - WRAP) % (1 << 32)).sum())


@pytest.mark.parametrize("name", F32)
def test_f32_matches_reference_up_to_tanh_ties(reference, name):
    out, _ = reference
    ref = np.load(out / f"{name}-out.npz")
    h, st0, st, rec = run(name)
    np.testing.assert_array_equal(state_to_numpy(st0)["rng"],
                                  ref["init_rng"])
    assert_fields(ref, st, ("rng", "sweep"))
    got = state_to_numpy(st)
    differ = got["m"] != ref["m"]
    assert differ.mean() <= 0.01
    if CASES[name][4] == "phase":
        # the per-phase refresh publishes instantaneous +-1 states, also
        # in cmft mode (never all-zero window means)
        assert (np.abs(got["ghosts"]) == 1).all()
        assert (np.abs(ref["ghosts"]) == 1).all()
    if differ.any():
        return
    assert_fields(ref, st)
    np.testing.assert_array_equal(rec.energies.numpy(), ref["energies"])
    assert rec.flips == int(ref["total_flips"])


@pytest.mark.parametrize("name", list(CASES))
def test_boundary_payload_matches_reference(reference, name):
    _, meta = reference
    h = handle(*(CASES[name][:4] + CASES[name][5:]))
    assert h.eng.boundary_payload() == meta[name]["payload"]


@pytest.mark.parametrize("kind,K", [("regular", 4), ("regular", 2),
                                    ("ea3d", 4), ("ea3d", 2)])
def test_dist_eta_meter_matches_reference(reference, kind, K):
    _, meta = reference
    name = next(n for n, c in CASES.items() if c[:2] == (kind, K))
    eta = dist_eta_meter(handle(kind, K, "int8", 1).eng, sync_every=4)
    assert eta.n_color == meta[name]["n_color"]
    assert eta.c_max == meta[name]["c_max"]
    assert eta.sync_every == 4


@pytest.mark.parametrize("sync", [4, "phase"])
def test_bitplane_lanes_are_int8_replicas_and_prefix_stable(sync):
    """Lane r of the bit-plane engine is replica r of the int8 engine at
    matched seeds (spins, per-lane flips, energies), and lanes do not
    depend on how many others run (R=5 is R=40's first five)."""
    runs = {}
    for prec, R in (("int8", 40), ("bitplane", 40), ("bitplane", 5)):
        h = handle("regular", 4, prec, R)
        st, rec = h.run_recorded(h.init_state(seed=2), ea_schedule(12),
                                 [4, 12], sync_every=sync)
        runs[prec, R] = (h.global_spins(st), st.flips, rec.energies)
    for a, b in zip(runs["int8", 40], runs["bitplane", 40]):
        assert torch.equal(a, b)
    (spins, flips, energies), five = runs["bitplane", 40], \
        runs["bitplane", 5]
    for a, b in zip((spins[:5], flips[:5], energies[:, :5]), five):
        assert torch.equal(a, b)


def test_philox_statistics_match_lfsr():
    """philox (one torch.Generator per partition and replica, another
    stream than the reference's jax.random keys) against LFSR on the
    same problem at sync 'phase' and 4: mean energy after
    ea_schedule(200) over three chains within 10%."""
    prob = problem("ea3d", 2)
    out = {}
    for rng in ("philox", "lfsr"):
        h = t_make("dsim_dist", prob, rng=rng, replicas=3, **CPU)
        for sync in ("phase", 4):
            _, rec = h.run_recorded(h.init_state(seed=1), ea_schedule(200),
                                    [200], sync_every=sync)
            out[rng, sync] = float(rec.energies[-1].mean())
    for sync in ("phase", 4):
        a, b = out["philox", sync], out["lfsr", sync]
        assert a < 0 and abs(a - b) / abs(b) < 0.1


def test_int8_replicas_are_the_stacked_engines():
    """dist int8 replica r is replica r of the stacked int8 engine from
    init_state(seed, replicas=R): the same seeds, spins and LFSR columns."""
    prob = problem("regular", 4)
    stacked = DSIMEngine(prob, rng="lfsr", precision="int8", **CPU)
    ss, rs = stacked.run_recorded(stacked.init_state(5, replicas=3),
                                  ea_schedule(16), POINTS, sync_every=4)
    h = handle("regular", 4, "int8", 3)
    st, rd = h.run_recorded(h.init_state(5), ea_schedule(16), POINTS,
                            sync_every=4)
    assert torch.equal(rs.energies, rd.energies) and rs.flips == rd.flips
    for f in ("m", "ghosts", "rng"):
        assert torch.equal(getattr(ss, f),
                           getattr(st, f).transpose(0, 1)), f


@pytest.mark.parametrize("prec,rng,mode", [("int8", "lfsr", "dsim"),
                                           ("bitplane", "lfsr", "dsim"),
                                           ("f32", "philox", "dsim"),
                                           ("f32", "lfsr", "cmft")])
def test_snapshot_checkpoint_and_interop_round_trips(prec, rng, mode):
    """A snapshot restored, a mid-run checkpoint resumed in a fresh cursor
    and (LFSR) a state through ``interop`` continue the uninterrupted run
    bitwise; energies (P, R)."""
    R = 33 if prec == "bitplane" else 2
    h = t_make("dsim_dist", problem("ea3d", 4), rng=rng, mode=mode,
               precision=prec, replicas=R, **CPU)
    assert h.name == "dsim_dist" and not h.supports_packing
    st0 = h.init_state(seed=5)
    ref_state, ref = h.run_recorded(st0, ea_schedule(16), [4, 8, 16],
                                    sync_every=4)
    assert ref.energies.shape == (3, R) and ref.flips > 0
    st1, rec1 = h.run_recorded(h.restore(h.snapshot(st0)), ea_schedule(16),
                               [4, 8, 16], sync_every=4)
    assert torch.equal(rec1.energies, ref.energies)
    cur = h.start_recorded(st0, ea_schedule(16), [4, 8, 16], sync_every=4)
    cur.advance(2)
    ck = cur.checkpoint()
    fresh = h.start_recorded(h.init_state(seed=1), ea_schedule(16),
                             [4, 8, 16], sync_every=4)
    fresh.restore_checkpoint(ck)
    while not fresh.done:
        fresh.advance(1)
    assert torch.equal(fresh.record().energies, ref.energies)
    assert fresh.record().flips == ref.flips
    for f in FIELDS:
        a, b = getattr(fresh.state, f), getattr(ref_state, f)
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.uint32 else b), f
    np.testing.assert_array_equal(fresh.flips_per_replica(),
                                  ref_state.flips.numpy())
    if rng == "philox":
        with pytest.raises(ValueError, match="philox"):
            state_to_numpy(st0)
        return
    crossed = state_from_numpy(**state_to_numpy(st0), **CPU)
    assert isinstance(crossed, DSIMState)
    st2, rec2 = h.run_recorded(crossed, ea_schedule(16), [4, 8, 16],
                               sync_every=4)
    assert torch.equal(rec2.energies, ref.energies)
    assert (state_to_numpy(st2)["m"] == state_to_numpy(ref_state)["m"]).all()


def test_guards():
    prob = problem("regular", 4)
    for kw in (dict(precision="int8", rng="philox"),
               dict(precision="bitplane", rng="lfsr", mode="cmft")):
        with pytest.raises(ValueError, match="needs rng='lfsr'"):
            DistDSIMEngine(prob, **kw, **CPU)
    for kw, what in ((dict(mode="x"), "mode"), (dict(rng="x"), "rng"),
                     (dict(precision="x"), "precision")):
        with pytest.raises(ValueError, match=what):
            DistDSIMEngine(prob, **kw, **CPU)
    with pytest.raises(ValueError, match="mesh axis size 2 != K=4"):
        DistDSIMEngine(prob, mesh=make_mesh((2,), ("data",)), **CPU)
    with pytest.raises(ValueError, match="no axis"):
        DistDSIMEngine(prob, mesh=make_mesh((4,), ("x",)), **CPU)
    with pytest.raises(ValueError, match="mode='dsim'"):
        t_make("dsim_dist", prob, mode="cmft", degrade="stale_hold", **CPU)
    # the degraded mesh is ported (queue A item 9): one source per
    # partition
    assert t_make("dsim_dist", prob, degrade="stale_hold",
                  **CPU).eng.health.report()["staleness"] == [0] * prob.K
    with pytest.raises(ValueError, match="mesh engines"):
        t_make("dsim", prob, degrade="fail_fast", **CPU)
    with pytest.raises(ValueError, match="bitplane"):
        t_make("dsim_dist", prob, precision="bitplane", replicas=257,
               rng="lfsr", **CPU)
    h = t_make("dsim_dist", prob, rng="lfsr", precision="int8",
               replicas=2, **CPU)
    with pytest.raises(NotImplementedError, match="one tenant"):
        h.init_state_packed([1, 2])
    # couplings that quantize beyond one sign bit stay on int8
    g = t_graph.random_regular(48, 4, seed=3, **CPU)
    g.w.mul_(torch.where(torch.arange(4) == 0, 2.0, 1.0))
    weighted = build_partitioned(g, greedy_coloring(g.idx, g.w),
                                 greedy_partition(g.idx, g.w, 2, seed=0), 2)
    with pytest.raises(ValueError, match="precision='int8'"):
        t_make("dsim_dist", weighted, rng="lfsr", precision="bitplane",
               **CPU)


def test_make_engine_defaults_and_exchange_probe():
    """make_engine("dsim_dist", graph): K=4 greedy partitions, the
    in-process mesh; the exchange-only closure returns the ghosts a run
    ends with (sync 4) and is dropped by shard_state."""
    g = t_graph.random_regular(48, 4, seed=3, **CPU)
    h = t_make("dsim_dist", g, rng="lfsr", precision="int8", replicas=2,
               **CPU)
    assert h.eng.p.K == 4 and h.eng.group is None
    assert h.eng.mesh.shape == {"data": 4}
    np.testing.assert_array_equal(h.eng.p.labels,
                                  greedy_partition(g.idx, g.w, 4, seed=0))
    st, _ = h.run_recorded(h.init_state(seed=3), ea_schedule(8), [8],
                           sync_every=4)
    fn = h.eng.boundary_exchange_fn()
    assert torch.equal(fn(st), st.ghosts)
    h.eng.shard_state(st)
    assert h.eng.boundary_exchange_fn() is not fn
    assert h.global_spins(st).shape == (2, 48)
    assert torch.equal(h.energy(st), h.eng.energy(st))
