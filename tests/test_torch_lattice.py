"""Engine parity: the port's one-brick lattice engine against the JAX one.

``repro_torch.make_engine("lattice", ..., device="cpu")`` (the plain
PyTorch kernels) is held to ``repro.engines.registry.make_engine(...,
impl="ref")`` at small L: spins, LFSR states, halos, per-replica flip
odometers, exact flip totals and record-point energies bitwise, on the
int8 and bit-plane paths.  The JAX bit-plane path compiles slowly at
``sync_every=8``; there the port's bit-plane lanes are held to its int8
replicas, which are held to JAX.
"""

import pickle

import numpy as np
import pytest
import torch

from repro.core.annealing import ea_schedule as j_ea_schedule
from repro.core.annealing import replica_beta_arrays as j_fan
from repro.core.lattice import build_ea3d_lattice as j_build
from repro.core.pbit import S41 as J_S41
from repro.engines.registry import make_engine as j_make
from repro_torch import make_engine as t_make
from repro_torch.core.annealing import ea_schedule, replica_beta_arrays
from repro_torch.core.lattice_dsim import BitplaneLatticeState, LatticeState
from repro_torch.core.mesh import make_mesh
from repro_torch.core.packing import unpack_lanes
from repro_torch.core.pbit import S41
from repro_torch.core.snapshot import restore_state, snapshot_state
from repro_torch.interop import (problem_from_numpy, state_from_numpy,
                                 state_to_numpy)
import repro_torch.core.device as t_device

FIELDS = ("m", "s", "sweep", "flips")


def jax_state(st) -> dict:
    d = {f: np.asarray(getattr(st, f)) for f in FIELDS}
    d["halos"] = tuple(np.asarray(h) for h in st.halos)
    return d


def assert_states_equal(jst, tst):
    a, b = jax_state(jst), state_to_numpy(tst)
    for f in FIELDS:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert len(a["halos"]) == len(b["halos"]) == 6
    for x, y in zip(a["halos"], b["halos"]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg="halos")


def assert_records_equal(jrec, trec):
    np.testing.assert_array_equal(np.asarray(jrec.times), trec.times)
    np.testing.assert_array_equal(np.asarray(jrec.energies),
                                  trec.energies.numpy())
    assert jrec.flips == trec.flips


def pair(prec, L, R, fmt=None, seed=0):
    jh = j_make("lattice", L=L, seed=seed, replicas=R, precision=prec,
                impl="ref", fmt=None if fmt is None else J_S41)
    th = t_make("lattice", L=L, seed=seed, replicas=R, precision=prec,
                device="cpu", fmt=None if fmt is None else S41)
    return jh, th


def run_pair(prec, L, R, sync, sweeps=16, points=(8, 16), fmt=None,
             fan=False, init_seed=3):
    jh, th = pair(prec, L, R, fmt=fmt)
    jst, tst = jh.init_state(seed=init_seed), th.init_state(seed=init_seed)
    assert_states_equal(jst, tst)
    if fan:
        jb = j_fan(j_ea_schedule(sweeps), R, spread=0.3)
        tb = replica_beta_arrays(ea_schedule(sweeps), R, spread=0.3)
        jst, jrec = jh.eng.run_recorded_full(
            jst, j_ea_schedule(sweeps), list(points), sync_every=sync,
            betas_R=jb)
        tst, trec = th.eng.run_recorded_full(
            tst, ea_schedule(sweeps), list(points), sync_every=sync,
            betas_R=tb)
    else:
        jst, jrec = jh.run_recorded(jst, j_ea_schedule(sweeps), list(points),
                                    sync_every=sync)
        tst, trec = th.run_recorded(tst, ea_schedule(sweeps), list(points),
                                    sync_every=sync)
    assert_states_equal(jst, tst)
    assert_records_equal(jrec, trec)
    np.testing.assert_array_equal(np.asarray(jh.global_spins(jst)),
                                  th.global_spins(tst).numpy())
    return th, tst, trec


@pytest.mark.parametrize("L,R,sync", [(4, 1, 1), (5, 8, 4), (6, 33, 8)])
def test_int8_engine_matches_jax(L, R, sync):
    th, tst, trec = run_pair("int8", L, R, sync)
    assert th.kernel_path == "fused" and isinstance(tst, LatticeState)
    assert trec.energies.shape == (2, R) and trec.flips > 0


@pytest.mark.parametrize("L,R,sync", [(4, 1, 1), (5, 32, 1), (6, 33, 4),
                                      (4, 64, 1)])
def test_bitplane_engine_matches_jax(L, R, sync):
    th, tst, trec = run_pair("bitplane", L, R, sync)
    assert th.kernel_path == "bitplane"
    assert isinstance(tst, BitplaneLatticeState)
    assert tst.m.shape[0] == (R + 31) // 32 and tst.m.dtype == torch.uint32


@pytest.mark.parametrize("prec,L,R,sync", [("int8", 5, 4, 4),
                                           ("bitplane", 4, 5, 1)])
def test_per_replica_beta_fans_match_jax(prec, L, R, sync):
    _, _, trec = run_pair(prec, L, R, sync, fan=True)
    # the fan differentiates the replicas
    assert len(np.unique(trec.energies[-1].numpy())) > 1


def test_fixed_point_format_matches_jax():
    th, _, _ = run_pair("int8", 4, 2, 2, fmt="S41")
    assert th.eng.fmt == S41


def test_interop_state_carries_on_like_jax():
    """A JAX problem and mid-run JAX state, passed across as numpy arrays,
    continue in the port exactly as they continue in JAX."""
    for prec in ("int8", "bitplane"):
        jp = j_build(5, seed=2)
        tp = problem_from_numpy(
            L=jp.L, dims=jp.dims, seed=jp.seed, n_colors=jp.n_colors,
            h=np.asarray(jp.h), w6=[np.asarray(w) for w in jp.w6],
            masks=np.asarray(jp.masks), active=np.asarray(jp.active),
            device="cpu")
        jh = j_make("lattice", lattice=jp, replicas=3, precision=prec,
                    impl="ref")
        th = t_make("lattice", lattice=tp, replicas=3, precision=prec,
                    device="cpu")
        jst, _ = jh.run_recorded(jh.init_state(seed=5), j_ea_schedule(16),
                                 [8], sync_every=2)
        tst = state_from_numpy(**jax_state(jst), device="cpu")
        assert_states_equal(jst, tst)
        jst, jrec = jh.run_recorded(jst, j_ea_schedule(16), [8, 16],
                                    sync_every=2)
        tst, trec = th.run_recorded(tst, ea_schedule(16), [8, 16],
                                    sync_every=2)
        assert_states_equal(jst, tst)
        assert_records_equal(jrec, trec)


def test_explicit_seeds_and_single_replica_seed_rule():
    for prec in ("int8", "bitplane"):
        jh, th = pair(prec, 4, 3)
        seeds = [7, 1, 123456]
        assert_states_equal(jh.init_state_packed(seeds),
                            th.init_state_packed(seeds))
        with pytest.raises(ValueError, match="exactly R=3"):
            th.init_state_packed([1, 2])
        # R == 1 seeds the replica with the seed itself, not spawn_seeds
        jh1, th1 = pair(prec, 4, 1)
        a, b = jh1.init_state(seed=9), th1.init_state(seed=9)
        assert_states_equal(a, b)
        assert float(th1.eng.energy(b)) == float(jh1.eng.energy(a))
        assert th1.eng.energy(b).dim() == 0


def test_bitplane_lanes_equal_int8_replicas_at_sync_8():
    """Lane (w, b) == int8 replica w*32+b through the whole engine, at the
    exchange period the JAX bit-plane parity grid leaves out."""
    R = 33
    ti = t_make("lattice", L=5, seed=1, replicas=R, precision="int8",
                device="cpu")
    tb = t_make("lattice", L=5, seed=1, replicas=R, precision="bitplane",
                device="cpu")
    a, ra = ti.run_recorded(ti.init_state(seed=4), ea_schedule(32),
                            [8, 16, 32], sync_every=8)
    b, rb = tb.run_recorded(tb.init_state(seed=4), ea_schedule(32),
                            [8, 16, 32], sync_every=8)
    assert torch.equal(unpack_lanes(b.m, R), a.m)
    assert torch.equal(b.s.view(torch.int32), a.s.view(torch.int32))
    assert torch.equal(b.flips, a.flips)
    assert torch.equal(ra.energies, rb.energies) and ra.flips == rb.flips
    # the z ring carries spins; the open x/y faces are empty in both forms
    for hb, ha in zip(b.halos[4:], a.halos[4:]):
        assert torch.equal(unpack_lanes(hb, R), ha)


@pytest.mark.parametrize("prec", ["int8", "bitplane"])
def test_cursor_checkpoint_resume_is_bitwise(prec):
    th = t_make("lattice", L=4, seed=0, replicas=33, precision=prec,
                device="cpu")
    sch, pts = ea_schedule(32), [4, 12, 32]
    whole, rec = th.run_recorded(th.init_state(seed=2), sch, pts,
                                 sync_every=2)
    cur = th.start_recorded(th.init_state(seed=2), sch, pts, sync_every=2)
    assert cur.S == 2 and cur.total_sweeps == 32
    cur.advance(1)
    part = cur.record()
    assert part.energies.shape == (1, 33) and cur.points_recorded == 1
    ck = pickle.loads(pickle.dumps(cur.checkpoint()))
    fresh = th.start_recorded(th.init_state(seed=0), sch, pts, sync_every=2)
    fresh.restore_checkpoint(ck)
    while not fresh.done:
        fresh.advance(1)
    got = fresh.record()
    assert torch.equal(got.energies, rec.energies) and got.flips == rec.flips
    assert (fresh.flips_per_replica() ==
            whole.flips.numpy().astype(np.int64)).all()
    assert torch.equal(fresh.state.m.view(torch.int32) if prec == "bitplane"
                       else fresh.state.m,
                       whole.m.view(torch.int32) if prec == "bitplane"
                       else whole.m)
    with pytest.raises(ValueError, match="plan mismatch"):
        th.start_recorded(th.init_state(seed=2), sch, [32],
                          sync_every=2).restore_checkpoint(ck)


def test_cursor_warm_and_chunk_timer_leave_the_run_unchanged():
    th = t_make("lattice", L=4, seed=0, replicas=2, precision="int8",
                device="cpu")
    _, want = th.run_recorded(th.init_state(seed=1), ea_schedule(24),
                              [8, 24], sync_every=4)
    cur = th.start_recorded(th.init_state(seed=1), ea_schedule(24),
                            [8, 24], sync_every=4)
    cur.warm()
    assert cur.sweeps_done == 0 and cur.points_recorded == 0
    timed = []
    cur.chunk_timer = lambda sweeps, sec: timed.append((sweeps, sec))
    assert cur.chunk_timer is not None
    while not cur.done:
        cur.advance(1)
    assert [sw for sw, _ in timed] == [8, 16]
    assert all(sec >= 0 for _, sec in timed)
    got = cur.record()
    assert torch.equal(got.energies, want.energies)
    assert got.flips == want.flips and cur.flips == want.flips


@pytest.mark.parametrize("prec", ["int8", "bitplane"])
def test_snapshot_restore_resumes_bitwise(prec):
    th = t_make("lattice", L=4, seed=0, replicas=4, precision=prec,
                device="cpu")
    st, _ = th.run_recorded(th.init_state(seed=2), ea_schedule(16), [8],
                            sync_every=4)
    snap = pickle.loads(pickle.dumps(th.snapshot(st)))
    assert isinstance(snap.m, np.ndarray)
    st2 = th.restore(snap)
    assert type(st2) is type(st) and st2.s.dtype == torch.uint32
    a, ra = th.run_recorded(st, ea_schedule(16), [8], sync_every=4)
    b, rb = th.run_recorded(st2, ea_schedule(16), [8], sync_every=4)
    assert state_to_numpy(a).keys() == state_to_numpy(b).keys()
    for f in FIELDS:
        np.testing.assert_array_equal(state_to_numpy(a)[f],
                                      state_to_numpy(b)[f])
    assert torch.equal(ra.energies, rb.energies)
    # the module-level pair is the same round trip
    again = restore_state(snapshot_state(st), "cpu")
    np.testing.assert_array_equal(state_to_numpy(again)["s"],
                                  state_to_numpy(st)["s"])


def test_make_engine_raises_for_what_this_slice_does_not_port():
    kw = dict(L=4, device="cpu")
    # f32 (the default), fused=False and kernel_bx are ported: they build
    h = t_make("lattice", **kw)
    assert (h.precision, h.kernel_path, h.fallback_reason) == \
        ("f32", "fused", None)
    h = t_make("lattice", precision="int8", fused=False, **kw)
    assert (h.kernel_path, h.fused_requested, h.fallback_reason) == \
        ("per_phase", False, None)
    h = t_make("lattice", precision="f32", kernel_bx=2, **kw)
    assert (h.kernel_path, h.fused_requested, h.fallback_reason) == \
        ("per_phase", True, "kernel_bx")
    assert t_make("lattice", precision="bitplane", fused=False,
                  **kw).kernel_path == "bitplane"
    with pytest.raises(ValueError, match="kernel_bx.*bitplane"):
        t_make("lattice", precision="bitplane", kernel_bx=2, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 9"):
        t_make("lattice", precision="int8", degrade="fail_fast", **kw)
    # the mesh is ported (ROADMAP queue A item 5): it needs dim_axes, as
    # in the reference, and then builds
    mesh = make_mesh((2, 1, 1), ("x", "y", "z"))
    with pytest.raises(ValueError, match="dim_axes"):
        t_make("lattice", precision="int8", mesh=mesh, **kw)
    assert t_make("lattice", precision="int8", mesh=mesh,
                  dim_axes=("x", "y", "z"), **kw).eng.nb == (2, 1, 1)
    # gibbs, dsim and dsim_dist are ported (queue A item 7): they take a
    # graph, as in the reference
    with pytest.raises(ValueError, match="IsingGraph"):
        t_make("dsim_dist", precision="int8", **kw)
    with pytest.raises(ValueError, match="not supported on engine 'gibbs'"):
        t_make("gibbs", precision="int8", **kw)
    with pytest.raises(ValueError, match="IsingGraph"):
        t_make("dsim", precision="int8", **kw)
    with pytest.raises(ValueError, match="unknown engine"):
        t_make("potts", **kw)
    with pytest.raises(ValueError, match="VMEM"):
        t_make("lattice", precision="int8", vmem_budget_bytes=1 << 20, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        t_make("lattice", precision="int8", impl="cuda", **kw)
    with pytest.raises(ValueError, match=r"\[1, 256\]"):
        t_make("lattice", precision="bitplane", replicas=257, **kw)
    with pytest.raises(ValueError, match="lattice= or L="):
        t_make("lattice", precision="int8", device="cpu")
    with pytest.raises(ValueError, match="betas_R"):
        h = t_make("lattice", precision="int8", replicas=2, **kw)
        h.eng.run_recorded_full(h.init_state(), ea_schedule(8), [8],
                                betas_R=np.ones((8, 3), np.float32))


def test_bitplane_rejects_multibit_couplings_like_jax():
    jp = j_build(4, seed=0)
    w6 = [np.asarray(w) * np.where(np.arange(4)[:, None, None] == 1, 2.0,
                                   1.0).astype(np.float32) for w in jp.w6]
    fields = dict(L=jp.L, dims=jp.dims, seed=jp.seed, n_colors=jp.n_colors,
                  h=np.asarray(jp.h), w6=w6, masks=np.asarray(jp.masks),
                  active=np.asarray(jp.active))
    with pytest.raises(ValueError, match="precision='int8'"):
        t_make("lattice", lattice=problem_from_numpy(**fields, device="cpu"),
               precision="bitplane", device="cpu")
    # the int8 path takes the same problem
    h = t_make("lattice", lattice=problem_from_numpy(**fields, device="cpu"),
               precision="int8", device="cpu")
    assert h.eng.f_max > 6


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_make("lattice", L=4, precision="int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_device.resolve_device(None)
    assert t_device.resolve_device("cpu") == torch.device("cpu")
