"""Shared-driver edge cases on the port: chunk planning, record-point
quantization, flip-cap bounds, and the resumable RecordedCursor surface.

The port of ``tests/test_driver_edges.py``, case by case, on the CPU.
The host planners are held equal to the reference's on the same inputs;
the cursor runs are held to the reference's engine started from the
port's state (``interop.state_to_numpy``; gibbs ``rng="lfsr"``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.engines import base as jbase
from repro.engines import make_engine as j_make
from repro.core.annealing import ea_schedule as j_ea
from repro.core.coloring import lattice3d_coloring as j_lat_col
from repro.core.graph import ea3d as j_ea3d
from repro_torch.core.annealing import constant_schedule, ea_schedule
from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.graph import ea3d
from repro_torch.engines import make_engine
from repro_torch.engines.base import (RecordedCursor, chunk_plan,
                                      flips_chunk_cap,
                                      quantize_record_points,
                                      run_recorded_driver)
from repro_torch.interop import state_to_numpy

CPU = dict(device="cpu")


def ref_state(template, port_state):
    """The reference's state with the port's field values."""
    import jax.numpy as jnp
    return dataclasses.replace(template, **{
        k: tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
        else jnp.asarray(v) for k, v in state_to_numpy(port_state).items()})


# -- chunk_plan ----------------------------------------------------------------

def test_chunk_plan_point_zero_is_empty():
    assert chunk_plan([0]) == [] == jbase.chunk_plan([0])
    assert chunk_plan([0, 0]) == [] == jbase.chunk_plan([0, 0])


def test_chunk_plan_duplicate_points():
    plan = chunk_plan([4, 4, 8])
    assert plan == jbase.chunk_plan([4, 4, 8])
    assert sum(plan) == 8
    acc, seen = 0, set()
    for c in plan:
        acc += c
        seen.add(acc)
    assert {4, 8} <= seen


def test_chunk_plan_unsorted_rejected():
    with pytest.raises(ValueError, match="nondecreasing"):
        chunk_plan([8, 4])


def test_chunk_plan_non_pow2_max_chunk_rejected():
    for bad in (3, 6, 0, -4):
        with pytest.raises(ValueError, match="power of two"):
            chunk_plan([4], max_chunk=bad)


def test_chunk_plan_max_chunk_one():
    assert chunk_plan([5], max_chunk=1) == [1] * 5
    assert jbase.chunk_plan([5], max_chunk=1) == [1] * 5


def test_chunk_plan_covers_every_point():
    pts = [1, 7, 8, 21, 64]
    plan = chunk_plan(pts, max_chunk=16)
    assert plan == jbase.chunk_plan(pts, max_chunk=16)
    acc, seen = 0, set()
    for c in plan:
        assert c & (c - 1) == 0 and 1 <= c <= 16
        acc += c
        seen.add(acc)
    assert set(pts) <= seen


# -- quantize_record_points ----------------------------------------------------

QUANTIZE = [
    (([0],), dict(S=4), [4]),
    (([2, 16],), dict(S=8), [8, 16]),
    (([1, 2, 3],), dict(S=8), [8]),
    (([8, 4, 4, 8],), dict(S=4), [4, 8]),
    (([9, 6, 6],), dict(S=4), [8]),
]


def test_quantize_point_zero_snaps_to_S():
    assert quantize_record_points([0], S=4) == [4]
    assert jbase.quantize_record_points([0], S=4) == [4]


def test_quantize_S_larger_than_first_point():
    # S > p: every point clamps up to at least one exchange period
    for args, kw, want in QUANTIZE[1:3]:
        assert quantize_record_points(*args, **kw) == want
        assert jbase.quantize_record_points(*args, **kw) == want


def test_quantize_duplicates_and_unsorted():
    for args, kw, want in QUANTIZE[3:]:
        assert quantize_record_points(*args, **kw) == want
        assert jbase.quantize_record_points(*args, **kw) == want


def test_quantize_clamps_rounding_past_limit():
    # round-to-nearest can overshoot the schedule (1000 -> 1001 with S=7);
    # with limit= the point clamps to the last reachable boundary
    cases = [(([1000], 7), {}, [1001]),
             (([1000], 7), dict(limit=1000), [994]),
             (([20], 7), dict(limit=20), [14]),
             (([16], 4), dict(limit=16), [16])]          # no-op in range
    for args, kw, want in cases:
        assert quantize_record_points(*args, **kw) == want
        assert jbase.quantize_record_points(*args, **kw) == want


def test_driver_survives_awkward_sync_near_schedule_end():
    _, rec = run_recorded_driver(
        state={}, schedule=constant_schedule(1.0, 20), record_points=[20],
        chunk_fn=_noop_chunk, record_fn=lambda st: torch.zeros(()),
        sync_every=7)
    assert list(rec.times) == [14]           # last reachable boundary


# -- flips_chunk_cap -----------------------------------------------------------

def test_flips_chunk_cap_bounds_and_pow2():
    for fps, spi in [(1, 1), (125, 4), (1 << 20, 1), (7, 3)]:
        cap = flips_chunk_cap(fps, spi)
        assert cap == jbase.flips_chunk_cap(fps, spi)
        assert cap >= 1 and cap & (cap - 1) == 0
        assert cap * fps * spi < (1 << 31)


def test_flips_chunk_cap_degenerate_inputs():
    assert flips_chunk_cap(0) == 1 << 30          # clamped to >= 1 flip
    assert flips_chunk_cap(1, 0) == 1 << 30
    assert flips_chunk_cap(1 << 40) == 1          # never below one iter


# -- driver guards -------------------------------------------------------------

def _noop_chunk(state, betas2d, iters, S):
    return state


def test_driver_empty_record_points_rejected():
    with pytest.raises(ValueError, match="non-empty"):
        run_recorded_driver(
            state={}, schedule=constant_schedule(1.0, 8), record_points=[],
            chunk_fn=_noop_chunk, record_fn=lambda st: torch.zeros(()))
    with pytest.raises(ValueError, match="non-empty"):
        RecordedCursor(
            state={}, schedule=constant_schedule(1.0, 8), record_points=[],
            chunk_fn=_noop_chunk, record_fn=lambda st: torch.zeros(()))


def test_driver_schedule_too_short_rejected():
    with pytest.raises(ValueError, match="shorter"):
        run_recorded_driver(
            state={}, schedule=constant_schedule(1.0, 8), record_points=[16],
            chunk_fn=_noop_chunk, record_fn=lambda st: torch.zeros(()))


def test_driver_quantizes_S_above_first_point():
    seen = []

    def chunk(state, betas2d, iters, S):
        seen.append((iters, S))
        return state

    _, rec = run_recorded_driver(
        state={}, schedule=constant_schedule(1.0, 32), record_points=[2],
        chunk_fn=chunk, record_fn=lambda st: torch.zeros(()), sync_every=8)
    assert list(rec.times) == [8]            # 2 snapped up to one period
    assert all(S == 8 for _, S in seen)


# -- the resumable cursor ------------------------------------------------------

L = 4
SW = 32


@pytest.fixture(scope="module")
def gibbs_handle():
    g = ea3d(L, seed=5, **CPU)
    return g, make_engine("gibbs", g, coloring=lattice3d_coloring(L),
                          rng="lfsr", replicas=2, **CPU)


@pytest.fixture(scope="module")
def ref_handle():
    return j_make("gibbs", j_ea3d(L, seed=5), coloring=j_lat_col(L),
                  rng="lfsr", replicas=2)


def test_cursor_matches_one_shot_bitwise(gibbs_handle, ref_handle):
    g, h = gibbs_handle
    sch = ea_schedule(SW)
    pts = [SW // 4, SW // 2, SW]
    st0 = h.init_state(seed=3)
    st1, rec1 = h.run_recorded(st0, sch, pts)
    cur = h.start_recorded(h.init_state(seed=3), sch, pts)
    steps = 0
    while not cur.done:
        assert cur.advance(1) == 1
        steps += 1
    assert cur.advance(1) == 0               # done cursors are inert
    rec2 = cur.record()
    assert steps >= len(pts)
    assert np.array_equal(np.asarray(rec1.energies),
                          np.asarray(rec2.energies))
    assert np.array_equal(rec1.times, rec2.times)
    assert rec1.flips == rec2.flips
    assert np.array_equal(h.global_spins(st1).numpy(),
                          h.global_spins(cur.state).numpy())
    # the reference's cursor from the same state takes the same steps
    js = ref_state(ref_handle.init_state(seed=3), st0)
    jcur = ref_handle.start_recorded(js, j_ea(SW), pts)
    while not jcur.done:
        jcur.advance(1)
    jrec = jcur.record()
    assert np.array_equal(np.asarray(jrec.energies), rec2.energies)
    assert list(jrec.times) == list(rec2.times) and jrec.flips == rec2.flips


def test_cursor_partial_records_stream(gibbs_handle):
    g, h = gibbs_handle
    pts = [8, 16, 24, 32]
    cur = h.start_recorded(h.init_state(seed=1), ea_schedule(SW), pts)
    seen_pts, seen_flips = [0], [0]
    while not cur.done:
        cur.advance(1)
        rec = cur.record()
        assert len(rec.times) >= seen_pts[-1]
        assert rec.flips >= seen_flips[-1]   # exact and monotone mid-run
        if len(rec.times):
            assert rec.energies.shape == (len(rec.times), 2)
        seen_pts.append(len(rec.times))
        seen_flips.append(rec.flips)
    assert cur.sweeps_done == cur.total_sweeps == SW
    assert seen_pts[-1] == len(pts)
    per_rep = cur.flips_per_replica()
    assert per_rep.shape == (2,) and int(per_rep.sum()) == cur.flips > 0


def test_cursor_warm_does_not_advance(gibbs_handle):
    g, h = gibbs_handle
    sch = ea_schedule(SW)
    cur = h.start_recorded(h.init_state(seed=2), sch, [SW])
    cur.warm()
    assert cur.sweeps_done == 0 and not cur.done
    cur.advance(1000)
    ref = h.start_recorded(h.init_state(seed=2), sch, [SW])
    ref.advance(1000)
    assert np.array_equal(np.asarray(cur.record().energies),
                          np.asarray(ref.record().energies))
    assert cur.record().flips == ref.record().flips


def test_cursor_empty_partial_record(gibbs_handle):
    g, h = gibbs_handle
    cur = h.start_recorded(h.init_state(seed=0), ea_schedule(SW), [SW])
    rec = cur.record()                       # before any advance
    assert len(rec.times) == 0 and rec.flips == 0


# -- snapshot / restore --------------------------------------------------------

def test_snapshot_pickles_and_resumes_bitwise(gibbs_handle):
    import pickle
    from repro_torch.core.snapshot import snapshot_nbytes
    g, h = gibbs_handle
    sch = ea_schedule(SW)
    st = h.init_state(seed=4)
    st, _ = h.run_recorded(st, sch, [SW])    # mid-trajectory state
    snap = h.snapshot(st)
    assert snapshot_nbytes(snap) > 0
    restored = h.restore(pickle.loads(pickle.dumps(snap)))
    a, ra = h.run_recorded(st, sch, [SW])
    b, rb = h.run_recorded(restored, sch, [SW])
    assert np.array_equal(np.asarray(ra.energies), np.asarray(rb.energies))
    assert ra.flips == rb.flips
    assert np.array_equal(h.global_spins(a).numpy(),
                          h.global_spins(b).numpy())


def test_snapshot_restore_lattice_resharded():
    import pickle
    hl = make_engine("lattice", L=4, seed=2, replicas=2, **CPU)
    sch = ea_schedule(16)
    st = hl.init_state(seed=0)
    st, _ = hl.run_recorded(st, sch, [16], sync_every=4)
    restored = hl.restore(pickle.loads(pickle.dumps(hl.snapshot(st))))
    a, _ = hl.run_recorded(st, sch, [16], sync_every=4)
    b, _ = hl.run_recorded(restored, sch, [16], sync_every=4)
    assert torch.equal(a.m, b.m)
    assert torch.equal(a.s.view(torch.int32), b.s.view(torch.int32))
    # the reference's lattice from the same state lands on the same bits
    jl = j_make("lattice", L=4, seed=2, replicas=2)
    jb, _ = jl.run_recorded(ref_state(jl.init_state(seed=0), restored),
                            j_ea(16), [16], sync_every=4)
    assert np.array_equal(np.asarray(jb.m), a.m.numpy())
    assert np.array_equal(np.asarray(jb.s), state_to_numpy(a)["s"])
