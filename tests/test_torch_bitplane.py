"""The port's bit-plane replica engine: multi-spin-coded sweeps over the
multi-word lane fabric (32 lanes per uint32 word plane, W = ceil(R/32)
stacked planes), its guards and its serving.

The port of ``tests/test_bitplane.py``, case by case, on the CPU.  Where
the reference case compares numbers, the port's are held to the
reference's on the same inputs (numpy, from a seed): the carry-save count
bitwise to the reference's op, the bit-plane engine's energies, flips and
spins bitwise to the reference's bit-plane run (the lattice's seed
expansion is host numpy in both), and the scheduler's packing decisions
to the reference scheduler's on the same jobs.

Not mirrored here: ``test_bitplane_oracle_matches_int8_per_lane``,
``test_bitplane_kernel_matches_oracle``,
``test_bitplane_kernel_per_lane_rows`` and
``test_bitplane_engine_matches_int8_all_32_lanes`` are held in
``tests/test_torch_kernels.py`` and ``tests/test_torch_lattice.py``, and
``test_bitplane_multi_device_halo_exchange`` in
``tests/test_torch_mesh.py``; JAX-only (the Pallas interpreter and the
TPU's VMEM model; ROADMAP section C) are
``test_engine_ref_vs_interpret_bitexact``,
``test_bitplane_working_set_per_lane_beats_int8`` and
``test_bitplane_over_budget_warns_not_falls_back``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as j_packing
from repro.core.annealing import ea_schedule as j_ea
from repro.core.pbit import bitplane_planes as j_planes
from repro.engines import make_engine as j_make
from repro.kernels import ref as j_ref
from repro_torch import make_engine
from repro_torch.core.annealing import ea_schedule, replica_beta_arrays
from repro_torch.core.lattice import build_ea3d_lattice
from repro_torch.core.lattice_dsim import BitplaneLatticeState, LatticeDSIM
from repro_torch.core.packing import (LANE_WIDTH, MAX_LANE_WORDS,
                                      pack_lanes, unpack_lanes)
from repro_torch.core.pbit import bitplane_planes, quantize_couplings
from repro_torch.engines.base import check_precision, lanes_of
from repro_torch.kernels.ref import bitplane_ones_count_ref

CPU = dict(device="cpu")
RNG = np.random.default_rng(23)


def i64(a) -> torch.Tensor:
    """uint32 words (numpy) as the port's int64-carried words."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def lattice(prec, L, R, seed=7, **kw):
    return make_engine("lattice", L=L, seed=seed, impl="ref", replicas=R,
                       precision=prec, **kw, **CPU)


def ref_lattice(prec, L, R, seed=7):
    return j_make("lattice", L=L, seed=seed, impl="ref", replicas=R,
                  precision=prec)


# -- the carry-save count ------------------------------------------------------

def test_bitplane_ones_count_matches_popcount():
    """The carry-save adder tree's 3 bit-slices equal the per-lane sum of
    contribution bits, for every lane of every site, and the reference's
    slices bitwise."""
    R, shape = LANE_WIDTH, (4, 3, 3)
    Bx, By, Bz = shape
    m = RNG.choice([-1, 1], size=(R,) + shape).astype(np.int8)
    w6 = [RNG.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
          for _ in range(6)]
    halos = [RNG.choice([-1, 1], (R,) + sh).astype(np.int8) for sh in
             [(By, Bz), (By, Bz), (Bx, Bz), (Bx, Bz), (Bx, By), (Bx, By)]]
    h_q, w6_q, _ = quantize_couplings(np.zeros(shape, np.float32), w6)
    signs6, nz6, _, _ = bitplane_planes(h_q, w6_q)
    # the CSA tree is a ONE-WORD primitive: feed it word plane 0
    mw = pack_lanes(torch.from_numpy(m))[0]
    hw = [pack_lanes(torch.from_numpy(h))[0] for h in halos]
    b0, b1, b2 = bitplane_ones_count_ref(
        i64(mw.view(torch.int32).numpy().view(np.uint32)),
        [i64(s) for s in signs6], [i64(z) for z in nz6],
        [i64(h.view(torch.int32).numpy().view(np.uint32)) for h in hw])

    def lanes(b):
        return (unpack_lanes(b.to(torch.int32).view(torch.uint32)[None], R)
                .numpy() > 0).astype(np.int64)
    cnt = lanes(b0) + 2 * lanes(b1) + 4 * lanes(b2)
    # direct recount from the unpacked layout
    want = np.zeros((R,) + shape, np.int64)
    for r in range(R):
        nbs = j_ref._shifted_int(jnp.asarray(m[r]),
                                 tuple(jnp.asarray(hh[r]) for hh in halos))
        for nb, w in zip(nbs, w6_q):
            wq = np.asarray(w, np.int64)
            want[r] += ((np.asarray(nb, np.int64) * wq > 0) & (wq != 0))
    np.testing.assert_array_equal(cnt, want)
    js, jn, _, _ = j_planes(h_q, w6_q)
    jb = j_ref.bitplane_ones_count_ref(
        j_packing.pack_lanes(jnp.asarray(m))[0], js, jn,
        tuple(j_packing.pack_lanes(jnp.asarray(h))[0] for h in halos))
    for got, ref in zip((b0, b1, b2), jb):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref).astype(np.int64))


# -- engine layer -------------------------------------------------------------

def test_bitplane_engine_matches_int8_at_two_words():
    """The W=2 acceptance gate: at R=64 every lane of the stacked word
    planes is bit-identical to its int8 replica — spins, energies, and
    flip totals — and the reference's bit-plane run."""
    R, SW = 2 * LANE_WIDTH, 48
    res = {}
    for prec in ("int8", "bitplane"):
        h = lattice(prec, 4, R)
        st = h.init_state(seed=1)
        st, rec = h.run_recorded(st, ea_schedule(SW), [24, 48],
                                 sync_every=4)
        res[prec] = (rec.energies.numpy(), rec.flips,
                     h.global_spins(st).numpy())
    e_bp, fl_bp, spins_bp = res["bitplane"]
    e_i8, fl_i8, spins_i8 = res["int8"]
    assert e_bp.shape == (2, R)
    np.testing.assert_array_equal(e_bp, e_i8)
    assert fl_bp == fl_i8
    np.testing.assert_array_equal(spins_bp, spins_i8)
    jh = ref_lattice("bitplane", 4, R)
    js, jrec = jh.run_recorded(jh.init_state(seed=1), j_ea(SW), [24, 48],
                               sync_every=4)
    np.testing.assert_array_equal(e_bp, np.asarray(jrec.energies))
    assert fl_bp == jrec.flips
    np.testing.assert_array_equal(spins_bp, np.asarray(jh.global_spins(js)))


def test_lane_prefix_stability():
    """Replica r of (seed, R) equals replica r of (seed, R') — growing the
    packed batch never reshuffles existing lanes — in the bit index AND
    across word-plane boundaries (R=33 vs R=64)."""
    e = {}
    for R in (8, 32, 33, 64):
        h = lattice("bitplane", 4, R, seed=0)
        st = h.init_state(seed=9)
        st, rec = h.run_recorded(st, ea_schedule(16), [16], sync_every=4)
        e[R] = rec.energies[-1].numpy()
    np.testing.assert_array_equal(e[8], e[32][:8])
    np.testing.assert_array_equal(e[32], e[64][:32])
    np.testing.assert_array_equal(e[33], e[64][:33])


def test_packed_lane_depends_only_on_its_seed():
    """init_state_packed: a lane's trajectory is bitwise independent of
    its batch-mates (the replica-packing contract on the word layout),
    and the reference's."""
    seeds = [11, 222, 3333]
    h3 = lattice("bitplane", 4, 3, seed=0)
    st = h3.init_state_packed(seeds)
    st, rec3 = h3.run_recorded(st, ea_schedule(16), [16], sync_every=4)
    h1 = lattice("bitplane", 4, 1, seed=0)
    s1 = h1.init_state_packed([seeds[1]])
    s1, rec1 = h1.run_recorded(s1, ea_schedule(16), [16], sync_every=4)
    assert float(rec3.energies[-1][1]) == float(rec1.energies[-1][0])
    jh = ref_lattice("bitplane", 4, 3, seed=0)
    _, jrec = jh.run_recorded(jh.init_state_packed(seeds), j_ea(16), [16],
                              sync_every=4)
    np.testing.assert_array_equal(rec3.energies.numpy(),
                                  np.asarray(jrec.energies))


def test_per_replica_staircase_fan_rides_bitplane():
    R = 4
    sch = ea_schedule(48)
    bR = replica_beta_arrays(sch, R, spread=0.3)
    outs = {}
    for prec in ("int8", "bitplane"):
        h = lattice(prec, 6, R)
        st = h.init_state(seed=0)
        st, rec = h.eng.run_recorded_full(st, sch, [48], sync_every=4,
                                          betas_R=bR)
        outs[prec] = rec.energies[-1].numpy()
    assert outs["bitplane"].shape == (R,)
    assert len(np.unique(outs["bitplane"])) > 1     # the fan differentiates
    np.testing.assert_array_equal(outs["bitplane"], outs["int8"])
    jh = ref_lattice("bitplane", 6, R)
    _, jrec = jh.eng.run_recorded_full(jh.init_state(seed=0), j_ea(48), [48],
                                       sync_every=4, betas_R=bR)
    np.testing.assert_array_equal(outs["bitplane"],
                                  np.asarray(jrec.energies[-1]))


def test_snapshot_restore_bitwise_resume():
    h = lattice("bitplane", 4, 4, seed=0)
    st = h.init_state(seed=2)
    st, _ = h.run_recorded(st, ea_schedule(16), [8], sync_every=4)
    st2 = h.restore(h.snapshot(st))
    assert isinstance(st2, BitplaneLatticeState)
    a, ra = h.run_recorded(st, ea_schedule(16), [8], sync_every=4)
    b, rb = h.run_recorded(st2, ea_schedule(16), [8], sync_every=4)
    assert torch.equal(a.m.view(torch.int32), b.m.view(torch.int32))
    np.testing.assert_array_equal(ra.energies.numpy(), rb.energies.numpy())


# -- guards -------------------------------------------------------------------

def test_registry_guards():
    from repro_torch.core.coloring import lattice3d_coloring
    from repro_torch.core.graph import ea3d
    g = ea3d(4, seed=0, **CPU)
    col = lattice3d_coloring(4)
    for eng_name in ("gibbs", "dsim"):
        with pytest.raises(ValueError, match="lattice/dsim_dist path"):
            make_engine(eng_name, g, coloring=col, K=2,
                        labels=np.zeros(g.n, np.int32),
                        precision="bitplane", **CPU)
    cap = MAX_LANE_WORDS * LANE_WIDTH
    assert cap == j_packing.MAX_LANE_WORDS * j_packing.LANE_WIDTH
    with pytest.raises(ValueError, match=rf"\[1, {cap}\]"):
        make_engine("lattice", L=4, precision="bitplane", replicas=cap + 1,
                    **CPU)
    # word-straddling replica counts are legal (the multi-word fabric)
    h = make_engine("lattice", L=4, precision="bitplane", replicas=33,
                    impl="ref", **CPU)
    assert h.eng.words == 2
    with pytest.raises(ValueError, match="kernel_bx"):
        make_engine("lattice", L=4, precision="bitplane", kernel_bx=2,
                    **CPU)
    assert lanes_of("bitplane") == LANE_WIDTH and lanes_of("int8") == 1
    check_precision("lattice", "bitplane")          # allowed


def test_non_sign_couplings_rejected():
    """Problems whose couplings don't quantize to +-1/0 have no sign plane
    — a clear init error pointing at int8, not a packing shape error —
    on one brick and on a mesh, as the reference's."""
    from repro_torch.core.mesh import make_mesh
    base = build_ea3d_lattice(4, seed=0, **CPU)
    wide = dataclasses.replace(base, h=torch.from_numpy(
        RNG.normal(0, 1.0, base.dims).astype(np.float32)))
    with pytest.raises(ValueError, match="int8"):
        LatticeDSIM(wide, precision="bitplane", impl="ref", **CPU)
    with pytest.raises(ValueError, match="int8"):
        LatticeDSIM(wide, precision="bitplane", impl="ref",
                    mesh=make_mesh((1,), ("data",)),
                    dim_axes=("data", None, None), **CPU)


# -- serving layer ------------------------------------------------------------

def _jobs(mod_jobs, sch, fp):
    def job(seq, replicas, precision):
        spec = mod_jobs.JobSpec(problem="p", engine="lattice", sweeps=32,
                                replicas=replicas, precision=precision)
        return mod_jobs.Job(f"j{seq}", seq, spec, "lat:L=6:seed=0", sch, fp,
                            0.0)
    return job


def test_scheduler_clamps_bitplane_to_lane_multiples():
    from repro.serve import jobs as j_jobs
    from repro.serve.scheduler import ReplicaPackingScheduler as JSched
    from repro_torch.serve import jobs as t_jobs
    from repro_torch.serve.scheduler import ReplicaPackingScheduler
    sch = ea_schedule(32)
    job = _jobs(t_jobs, sch, t_jobs.schedule_fingerprint(sch))
    jsch = j_ea(32)
    jjob = _jobs(j_jobs, jsch, j_jobs.schedule_fingerprint(jsch))
    assert t_jobs.schedule_fingerprint(sch) == \
        j_jobs.schedule_fingerprint(jsch)

    def batch(s, js, pairs):
        a = s.next_batch([job(i, r, p) for i, (r, p) in enumerate(pairs)])
        b = js.next_batch([jjob(i, r, p) for i, (r, p) in enumerate(pairs)])
        assert (len(a.jobs), a.r_exec) == (len(b.jobs), b.r_exec)
        return a

    s, js = ReplicaPackingScheduler(max_replicas_per_call=64), \
        JSched(max_replicas_per_call=64)
    # two bitplane jobs coalesce and execute at the full 32-lane word
    b = batch(s, js, [(4, "bitplane"), (8, "bitplane")])
    assert len(b.jobs) == 2 and b.r_exec == 32
    # a word-straddling pack clamps to the next word multiple, not pow2
    b = batch(s, js, [(20, "bitplane"), (20, "bitplane")])
    assert len(b.jobs) == 2 and b.r_exec == 64       # W=2, not one word
    # the budget still bounds the pack (cap 64 here -> at most two words)
    b = batch(s, js, [(40, "bitplane"), (40, "bitplane")])
    assert len(b.jobs) == 1 and b.r_exec == 64
    assert s.replica_budget("bitplane") == 64
    wide = ReplicaPackingScheduler(max_replicas_per_call=1024)
    assert wide.replica_budget("bitplane") == 32 * MAX_LANE_WORDS
    # bitplane never packs with int8 (precision is in the pack key)
    b = batch(s, js, [(4, "bitplane"), (4, "int8")])
    assert len(b.jobs) == 1
    # prewarm bucketing agrees with batch formation: word multiples,
    # R=33 and R=64 bucket to the SAME W=2 executable
    jwide = JSched(max_replicas_per_call=1024)
    for sc, jsc, r, p, want in ((s, js, 4, "bitplane", 32),
                                (s, js, 33, "bitplane", 64),
                                (s, js, 64, "bitplane", 64),
                                (wide, jwide, 65, "bitplane", 96),
                                (s, js, 4, "int8", 4)):
        assert sc.r_exec_for("lattice", r, p) == want == \
            jsc.r_exec_for("lattice", r, p)
    # a cap below the word width just runs unpadded
    tight = ReplicaPackingScheduler(max_replicas_per_call=16)
    b = tight.next_batch([job(0, 3, "bitplane")])
    assert b.r_exec == 4                             # pow2 pad only


def test_server_bitplane_jobs_pack_and_guard():
    from repro_torch.core.coloring import lattice3d_coloring
    from repro_torch.core.graph import ea3d
    from repro_torch.core.partition import slab_partition
    from repro_torch.serve.server import SampleServer
    srv = SampleServer(pack=True, warm_compile=False, **CPU)
    srv.register_problem("lat6", L=6, seed=0, impl="ref")
    g = ea3d(4, seed=0, **CPU)
    srv.register_problem("g4", graph=g, coloring=lattice3d_coloring(4), K=2,
                         labels=slab_partition(4, 2), rng="lfsr")
    # unsupported engine/precision pair: clear error at submit, not a
    # failed job (let alone a packing shape error)
    with pytest.raises(ValueError, match="lattice/dsim_dist path"):
        srv.submit("g4", engine="dsim", precision="bitplane", sweeps=16)
    # the admission cap is the scheduler budget: min(per-call cap 64,
    # MAX_LANE_WORDS words); word-straddling counts (e.g. 40) are legal
    with pytest.raises(ValueError, match=r"\[1, 64\]"):
        srv.submit("lat6", engine="lattice", precision="bitplane",
                   replicas=100, sweeps=16)
    a = srv.submit("lat6", engine="lattice", precision="bitplane",
                   replicas=4, sweeps=32, sync_every=4, seed=1)
    b = srv.submit("lat6", engine="lattice", precision="bitplane",
                   replicas=8, sweeps=32, sync_every=4, seed=2)
    ra, rb = srv.result(a), srv.result(b)
    assert ra["status"] == "done" and rb["status"] == "done"
    assert ra["packed_with"] == 1 and rb["packed_with"] == 1
    assert ra["energies"].shape[1] == 4 and rb["energies"].shape[1] == 8
    assert ra["best_energy"] < 0 and rb["best_energy"] < 0
    assert ra["flips"] > 0 and rb["flips"] > 0
    # a solo bitplane job of the same spec reproduces its packed lanes
    solo = srv.submit("lat6", engine="lattice", precision="bitplane",
                      replicas=4, sweeps=32, sync_every=4, seed=1)
    rs = srv.result(solo)
    np.testing.assert_array_equal(np.asarray(rs["energies"]),
                                  np.asarray(ra["energies"]))


def test_server_pool_keys_bitplane_by_word_count():
    """R=33 and R=64 submissions both clamp to the W=2 (64-lane) executed
    width, so they share ONE pooled engine: the second is a pool hit.
    ``prewarm_words=2`` builds that same bucket at register time."""
    from repro_torch.serve.server import SampleServer
    srv = SampleServer(pack=True, warm_compile=False, **CPU)
    srv.register_problem("lat4", L=4, seed=0, impl="ref")
    a = srv.submit("lat4", engine="lattice", precision="bitplane",
                   replicas=33, sweeps=16, sync_every=4, seed=1)
    ra = srv.result(a)
    assert ra["status"] == "done" and ra["cold_start"] is True
    assert ra["energies"].shape[1] == 33         # own lanes only
    b = srv.submit("lat4", engine="lattice", precision="bitplane",
                   replicas=64, sweeps=16, sync_every=4, seed=2)
    rb = srv.result(b)
    assert rb["status"] == "done"
    assert rb["cold_start"] is False             # same W=2 pool key
    assert rb["energies"].shape[1] == 64
    # register-time prewarm of the W=2 bucket serves the first tenant warm
    srv2 = SampleServer(pack=True, warm_compile=False, **CPU)
    srv2.register_problem("lat4", L=4, seed=0, impl="ref",
                          prewarm_bitplane=True, prewarm_words=2)
    srv2.prewarm_threads[0].join(timeout=400)
    assert not srv2.prewarm_threads[0].is_alive()
    c = srv2.submit("lat4", engine="lattice", precision="bitplane",
                    replicas=40, sweeps=16, sync_every=4, seed=3)
    rc = srv2.result(c)
    assert rc["status"] == "done" and rc["cold_start"] is False
    with pytest.raises(ValueError, match="prewarm_words"):
        srv2.register_problem("bad", L=4, prewarm_words=0)
