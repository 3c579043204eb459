"""The port's partitioned DSIM/CMFT engine against the JAX package.

``precision="int8"`` (the hardware pipeline: LFSR draws against a
threshold LUT, integer fields) is held **bitwise** over a grid of
partition counts, exchange cadences (``sync_every``), replica counts and
starts: spins, ghosts, window accumulators, LFSR states, per-replica
flips and record-point energies.  The graph is a random regular one cut
by the greedy partitioner, so partitions hold different numbers of sites
of a colour and the padded slot entries are exercised (the reference's
scatter lets them rewrite a partition's slot 0; the port writes the same
values).  ``precision="f32"`` in dsim and cmft modes: LFSR states and
ghosts bitwise, the fields as the partitions see them bitwise (cmft at
S = 4 and 8, where the window mean is exact), spins equal except near
tanh ties (at most 1% differ; with none differing everything else is
bitwise).  Philox is held statistically (mean annealed energy within
10% of LFSR's).
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import graph as j_graph
from repro.core.annealing import ea_schedule as j_ea
from repro.core.annealing import sat_schedule as j_sat_schedule
from repro.core.coloring import greedy_coloring as j_greedy
from repro.core.coloring import lattice3d_coloring as j_lat_col
from repro.core.dsim import DSIMEngine as JDSIM
from repro.core.dsim import build_partitioned as j_build
from repro.core.partition import brick_partition as j_brick
from repro.core.partition import greedy_partition as j_greedy_part
from repro.core.pbit import S43 as J_S43
from repro.engines.base import spawn_seeds, stack_states
from repro.problems import sat as j_sat
from repro_torch import S43, make_engine as t_make
from repro_torch.core import graph as t_graph
from repro_torch.core.annealing import ea_schedule, sat_schedule
from repro_torch.core.coloring import Coloring, greedy_coloring
from repro_torch.core.dsim import DSIMEngine, DSIMState, build_partitioned
from repro_torch.core.partition import greedy_partition
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.problems import sat as t_sat

CPU = dict(device="cpu")
FIELDS = ("m", "ghosts", "macc", "rng", "sweep", "flips")
SYNCS = ["phase", 1, 4, None]


@functools.lru_cache(maxsize=None)
def problems(kind: str, K: int):
    """(reference problem, port problem) of a random regular graph cut by
    the greedy partitioner, or an L=4 EA3D lattice cut into bricks."""
    if kind == "regular":
        jg = j_graph.random_regular(48, 4, seed=3)
        tg = t_graph.random_regular(48, 4, seed=3, **CPU)
        col = j_greedy(np.asarray(jg.idx), np.asarray(jg.w))
        labels = j_greedy_part(np.asarray(jg.idx), np.asarray(jg.w), K,
                               seed=0)
    else:
        jg, tg = j_graph.ea3d(4, seed=1), t_graph.ea3d(4, seed=1, **CPU)
        col = j_lat_col(4)
        labels = j_brick((4, 4, 4), {2: (2, 1, 1), 4: (2, 2, 1)}[K])
    return (j_build(jg, col, labels, K),
            build_partitioned(tg, Coloring(col.colors), labels, K))


@functools.lru_cache(maxsize=None)
def engines(kind, K, precision="int8", mode="dsim", rng="lfsr"):
    jp, tp = problems(kind, K)
    return (JDSIM(jp, rng=rng, mode=mode, precision=precision),
            DSIMEngine(tp, rng=rng, mode=mode, precision=precision, **CPU))


def assert_state_equal(js, ts, fields=FIELDS):
    t = state_to_numpy(ts)
    for f in fields:
        a = np.asarray(getattr(js, f))
        assert a.dtype == t[f].dtype and a.shape == t[f].shape, f
        np.testing.assert_array_equal(a, t[f], err_msg=f)


def starts(je, te, R, m0_kind, seed=4):
    """Equal (reference, port) states: from one given m0, or from the
    port's own numpy spins (the reference built from them per replica)."""
    reps = None if R == 1 else R
    if m0_kind == "given":
        m0 = np.random.default_rng(8).choice(np.array([-1, 1], np.int8),
                                             size=te.p.n)
        return je.init_state(seed, m0=m0, replicas=reps), \
            te.init_state(seed, m0=m0, replicas=reps)
    ts = te.init_state(seed, replicas=reps)
    spins = te.global_spins(ts).numpy()
    if R == 1:
        return je.init_state(seed, m0=spins), ts
    return stack_states([je.init_state(s, m0=spins[r])
                         for r, s in enumerate(spawn_seeds(seed, R))]), ts


@pytest.mark.parametrize("m0_kind", ["given", "init"])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("sync", SYNCS)
@pytest.mark.parametrize("K", [2, 4])
def test_dsim_int8_matches_jax_bitwise(K, sync, R, m0_kind):
    je, te = engines("regular", K)
    assert any(c.lost is not None for c in te._colors)
    js, ts = starts(je, te, R, m0_kind)
    assert_state_equal(js, ts)
    js, jrec = je.run_recorded(js, j_ea(16), [8, 16], sync_every=sync)
    ts, trec = te.run_recorded(ts, ea_schedule(16), [8, 16],
                               sync_every=sync)
    assert_state_equal(js, ts)
    np.testing.assert_array_equal(jrec.times, trec.times)
    np.testing.assert_array_equal(np.asarray(jrec.energies),
                                  trec.energies.numpy())
    assert jrec.flips == trec.flips > 0
    np.testing.assert_array_equal(
        np.asarray(je.global_spins(js)), te.global_spins(ts).numpy())
    np.testing.assert_array_equal(np.asarray(je.energy(js)),
                                  te.energy(ts).numpy())


@pytest.mark.parametrize("mode,sync", [("dsim", "phase"), ("dsim", 1),
                                       ("dsim", 4), ("cmft", 4),
                                       ("cmft", 8)])
@pytest.mark.parametrize("kind,K", [("regular", 4), ("ea3d", 2)])
def test_dsim_f32_matches_jax(kind, K, mode, sync):
    je, te = engines(kind, K, precision="f32", mode=mode)
    js, ts = starts(je, te, 3, "given")
    js, jrec = je.run_recorded(js, j_ea(32), [16, 32], sync_every=sync)
    ts, trec = te.run_recorded(ts, ea_schedule(32), [16, 32],
                               sync_every=sync)
    assert_state_equal(js, ts, ("rng", "sweep", "macc"))
    t = state_to_numpy(ts)
    differ = np.asarray(js.m) != t["m"]
    assert differ.mean() <= 0.01
    if differ.any():
        return
    assert_state_equal(js, ts)
    np.testing.assert_array_equal(np.asarray(jrec.energies),
                                  trec.energies.numpy())
    assert jrec.flips == trec.flips
    # the fields the partitions see (fractional ghosts in cmft), bitwise
    for r in range(3):
        jr = type(js)(**{f: getattr(js, f)[r] for f in FIELDS})
        tr = DSIMState(**{f: getattr(ts, f)[r] for f in FIELDS})
        np.testing.assert_array_equal(np.asarray(je.local_fields_check(jr)),
                                      te.local_fields_check(tr).numpy())
    if mode == "cmft":
        assert ((t["ghosts"] != 1) & (t["ghosts"] != -1)).any()


def test_dsim_int8_needs_lfsr_and_dsim_mode():
    _, tp = problems("regular", 2)
    for kw in (dict(rng="philox"), dict(rng="lfsr", mode="cmft")):
        with pytest.raises(ValueError, match="int8"):
            DSIMEngine(tp, precision="int8", **kw, **CPU)
    for kw, what in ((dict(mode="x"), "mode"), (dict(rng="x"), "rng"),
                     (dict(precision="bitplane"), "precision")):
        with pytest.raises(ValueError, match=what):
            DSIMEngine(tp, **kw, **CPU)


def test_dsim_philox_statistics_match_lfsr():
    """Philox (a torch.Generator per replica) against LFSR on the same
    problem at sync 'phase' and 4: mean energy after ea_schedule(200)
    over three chains within 10%."""
    _, tp = problems("ea3d", 2)
    out = {}
    for rng in ("philox", "lfsr"):
        te = DSIMEngine(tp, rng=rng, **CPU)
        for sync in ("phase", 4):
            st, rec = te.run_recorded(te.init_state(seed=1, replicas=3),
                                      ea_schedule(200), [200],
                                      sync_every=sync)
            out[rng, sync] = float(rec.energies[-1].mean())
    for sync in ("phase", 4):
        a, b = out["philox", sync], out["lfsr", sync]
        assert a < 0 and abs(a - b) / abs(b) < 0.1


@pytest.mark.parametrize("precision,rng", [("int8", "lfsr"),
                                           ("f32", "philox")])
def test_dsim_handle_packed_snapshot_and_checkpoint_resume(precision, rng):
    """make_engine("dsim"): defaults (K=4, greedy partition), energies
    (P, R), init_state_packed, and a snapshot restored and a mid-run
    checkpoint resumed in a fresh cursor give the uninterrupted run
    bitwise."""
    g = t_graph.random_regular(48, 4, seed=3, **CPU)
    h = t_make("dsim", g, rng=rng, precision=precision, replicas=2, **CPU)
    assert h.name == "dsim" and h.eng.p.K == 4 and h.precision == precision
    np.testing.assert_array_equal(
        h.eng.p.labels, greedy_partition(g.idx, g.w, 4, seed=0))
    np.testing.assert_array_equal(
        h.eng.p.labels, j_greedy_part(g.idx.numpy(), g.w.numpy(), 4,
                                      seed=0))
    st0 = h.init_state(seed=5)
    ref_state, ref = h.run_recorded(st0, ea_schedule(32), [8, 16, 32],
                                    sync_every=4)
    assert ref.energies.shape == (3, 2) and ref.flips > 0
    assert h.global_spins(ref_state).shape == (2, 48)
    st1, rec1 = h.run_recorded(h.restore(h.snapshot(st0)), ea_schedule(32),
                               [8, 16, 32], sync_every=4)
    assert torch.equal(rec1.energies, ref.energies) and \
        rec1.flips == ref.flips
    cur = h.start_recorded(st0, ea_schedule(32), [8, 16, 32], sync_every=4)
    cur.advance(2)
    assert cur.S == 4
    ck = cur.checkpoint()
    fresh = h.start_recorded(h.init_state(seed=1), ea_schedule(32),
                             [8, 16, 32], sync_every=4)
    fresh.restore_checkpoint(ck)
    while not fresh.done:
        fresh.advance(1)
    rec2 = fresh.record()
    assert torch.equal(rec2.energies, ref.energies) and \
        rec2.flips == ref.flips
    for f in ("m", "ghosts", "macc", "sweep", "flips"):
        assert torch.equal(getattr(fresh.state, f), getattr(ref_state, f))
    np.testing.assert_array_equal(fresh.flips_per_replica(),
                                  ref_state.flips.numpy())
    a = h.init_state_packed([3, 4])
    b = h.init_state_packed([9, 4])
    a, _ = h.run_recorded(a, ea_schedule(8), [8], sync_every=2)
    b, _ = h.run_recorded(b, ea_schedule(8), [8], sync_every=2)
    assert torch.equal(a.m[1], b.m[1]) and not torch.equal(a.m[0], b.m[0])
    # a prebuilt problem passes straight through
    h2 = t_make("dsim", h.eng.p, rng=rng, precision=precision, **CPU)
    assert h2.eng.p is h.eng.p


def test_dsim_init_packed_matches_jax():
    je, te = engines("regular", 4)
    ts = te.init_state(seeds=[7, 1, 3])
    spins = te.global_spins(ts).numpy()
    js = stack_states([je.init_state(s, m0=spins[r])
                       for r, s in enumerate([7, 1, 3])])
    assert_state_equal(js, ts)


def test_dsim_interop_crosses_lfsr_and_refuses_philox():
    je, te = engines("regular", 2)
    js, _ = je.run_recorded(je.init_state(seed=2), j_ea(8), [8],
                            sync_every=4)
    ts = state_from_numpy(**{f: np.asarray(getattr(js, f)) for f in FIELDS},
                          **CPU)
    assert isinstance(ts, DSIMState)
    assert_state_equal(js, ts)
    js, _ = je.run_recorded(js, j_ea(8), [8], sync_every=2)
    ts, _ = te.run_recorded(ts, ea_schedule(8), [8], sync_every=2)
    assert_state_equal(js, ts)
    pj = JDSIM(je.p, rng="philox")
    with pytest.raises(ValueError, match="philox"):
        state_from_numpy(**{f: np.asarray(getattr(pj.init_state(seed=1), f))
                            for f in FIELDS}, **CPU)
    with pytest.raises(TypeError, match="fields"):
        state_from_numpy(m=np.zeros(3, np.int8), rng=np.zeros(3, np.uint32),
                         **CPU)


def test_sat_pipeline_matches_jax():
    """examples/sat3_invertible.py at a small size through the port: the
    same encoding, colouring and partition; DSIM lfsr at s{4}{3}, a fresh
    anneal to each point at sync_every=4; every satisfied count the port
    reaches lies in the range of the reference's over the same points."""
    n_vars = 20
    m_cl = int(round(n_vars * 4.26))
    clauses = t_sat.random_3sat(n_vars, m_cl, seed=426)
    te_enc = t_sat.encode_3sat(clauses, n_vars, **CPU)
    je_enc = j_sat.encode_3sat(clauses, n_vars)
    g, jg = te_enc.graph, je_enc.graph
    col = greedy_coloring(g.idx, g.w)
    labels = greedy_partition(g.idx, g.w, 4, seed=0)
    te = DSIMEngine(build_partitioned(g, col, labels, 4), rng="lfsr",
                    fmt=S43, **CPU)
    je = JDSIM(j_build(jg, j_greedy(np.asarray(jg.idx), np.asarray(jg.w)),
                       labels, 4), rng="lfsr", fmt=J_S43)
    counts = {"port": [], "jax": []}
    for p in (64, 256, 1024):
        ts = te.init_state(seed=0)
        js = je.init_state(seed=0, m0=te.global_spins(ts).numpy())
        ts, _ = te.run_recorded(ts, sat_schedule(p), [p], sync_every=4)
        js, _ = je.run_recorded(js, j_sat_schedule(p), [p], sync_every=4)
        counts["port"].append(t_sat.count_satisfied(
            clauses, t_sat.decode_assignment(te_enc, te.global_spins(ts))))
        counts["jax"].append(j_sat.count_satisfied(
            clauses, j_sat.decode_assignment(je_enc,
                                             np.asarray(je.global_spins(js)))))
    lo, hi = min(counts["jax"]), max(counts["jax"])
    assert all(lo <= c <= hi for c in counts["port"]), counts
    assert max(counts["port"]) >= 0.9 * m_cl
