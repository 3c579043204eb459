"""The port's fixed-point p-bit pipeline: quantization, threshold LUTs, the
staircase's row indices and the ``precision="int8"`` engine paths.

The port of ``tests/test_quantized.py``, case by case, on the CPU.  Where
the reference case compares numbers, the port's are held to the
reference's on the same inputs (numpy, from a seed): quantized planes,
scales, LUTs, accepts and row indices exactly; the int8 engines bitwise
(the integer pipeline reproduces on any device), so each statistical
int8-vs-f32 case also checks that the port's int8 run equals the
reference's, from the port's initial state where the reference draws its
own with ``jax.random``.

Not mirrored, JAX-only (the Pallas interpreter and the TPU's 16 MiB VMEM
model, which the port does not have; ROADMAP section C):
``test_int_engine_ref_vs_interpret_bitexact``,
``test_fused_fallback_warns_and_is_exposed``,
``test_fused_decision_default_budget_and_handle_exposure``,
``test_int8_raises_fused_brick_ceiling`` and
``test_wide_lut_rejected_on_pallas_impl``.  The kernel cases
``test_int_update_kernel_matches_ref`` and
``test_int_sweep_kernel_matches_ref_and_per_phase`` are held in
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import annealing as j_ann
from repro.core import pbit as j_pbit
from repro.core.lattice import build_ea3d_lattice as j_build
from repro.engines import make_engine as j_make
from repro_torch import make_engine
from repro_torch.core.annealing import (ArraySchedule, beta_row_indices,
                                        beta_table, constant_schedule,
                                        ea_schedule, replica_beta_arrays)
from repro_torch.core.lattice import build_ea3d_lattice
from repro_torch.core.pbit import (S41, LFSR_UNIFORM_BITS, field_bound,
                                   lut_accept, quantize_couplings,
                                   threshold_lut)

CPU = dict(device="cpu")
RNG = np.random.default_rng(11)
HALF = 1 << (LFSR_UNIFORM_BITS - 1)


def lattice_runs(prec, L, seed, R, schedule, points, init_seed, ref=False,
                 **kw):
    """The port's ``make_engine("lattice")`` run: (handle, state, record);
    with ``ref`` also the reference's run from the same initial state
    (the lattice's seed expansion is host numpy in both)."""
    h = make_engine("lattice", L=L, seed=seed, impl="ref", replicas=R,
                    precision=prec, **CPU)
    st0 = h.init_state(seed=init_seed)
    st, rec = h.eng.run_recorded_full(st0, schedule, points, sync_every=4,
                                      **kw)
    if not ref:
        return h, st, rec
    jh = j_make("lattice", L=L, seed=seed, impl="ref", replicas=R,
                precision=prec)
    js0 = jh.init_state(seed=init_seed)
    np.testing.assert_array_equal(np.asarray(js0.m), st0.m.numpy())
    js, jrec = jh.eng.run_recorded_full(js0, j_ann.ArraySchedule(
        schedule.beta_array()), points, sync_every=4, **kw)
    return h, st, rec, js, jrec


# -- quantization -------------------------------------------------------------

def test_quantize_pm_j_exact():
    """+-J couplings quantize exactly, GCD-reduced to +-1 (scale folds it)."""
    p = build_ea3d_lattice(6, seed=0, **CPU)
    h_q, w6_q, scale = quantize_couplings(p.h, p.w6)
    assert scale == 1.0
    for w, wq in zip(p.w6, w6_q):
        assert set(np.unique(wq)) <= {-1, 0, 1}
        np.testing.assert_array_equal(wq * scale, w.numpy())
    assert field_bound(h_q, w6_q) == 6
    jp = j_build(6, seed=0)
    jh, jw, js = j_pbit.quantize_couplings(jp.h, jp.w6)
    assert js == scale
    np.testing.assert_array_equal(h_q, np.asarray(jh))
    for a, b in zip(w6_q, jw):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_quantize_generic_error_bound():
    shape = (4, 4, 4)
    h = RNG.normal(0, 0.3, shape).astype(np.float32)
    w6 = [RNG.normal(0, 1.0, shape).astype(np.float32) for _ in range(6)]
    h_q, w6_q, scale = quantize_couplings(torch.from_numpy(h),
                                          [torch.from_numpy(w) for w in w6])
    for orig, q in zip([h] + w6, [h_q] + list(w6_q)):
        q = np.asarray(q, np.float64)
        assert np.abs(q).max() <= 127
        assert np.abs(q * scale - orig).max() <= scale / 2 + 1e-12
    jh, jw, js = j_pbit.quantize_couplings(h, w6)
    assert js == scale
    for a, b in zip([h_q] + list(w6_q), [jh] + list(jw)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert field_bound(h_q, w6_q) == j_pbit.field_bound(jh, jw)


# -- threshold LUT structure --------------------------------------------------

def test_lut_monotone_in_beta():
    """Down the staircase (beta rising): thresholds fall for positive
    fields, rise for negative fields, and the zero-field column is the
    exact coin flip 2^23."""
    betas = np.arange(0.5, 5.01, 0.5)
    f_max = 6
    lut = threshold_lut(betas, 1.0, f_max).astype(np.int64)
    center = f_max
    assert (lut[:, center] == HALF).all()
    pos = lut[:, center + 1:]
    neg = lut[:, :center]
    assert (np.diff(pos, axis=0) <= 0).all()
    assert (np.diff(neg, axis=0) >= 0).all()
    assert lut.min() >= 0 and lut.max() <= (1 << LFSR_UNIFORM_BITS)
    np.testing.assert_array_equal(lut, j_pbit.threshold_lut(betas, 1.0,
                                                            f_max))


def test_lut_monotone_in_field_rowwise():
    """Each row nonincreasing in the field — the rank-count invariant."""
    betas = np.arange(0.5, 5.01, 0.5)
    lut = threshold_lut(betas, 0.03, 50, fmt=S41).astype(np.int64)
    assert (np.diff(lut, axis=1) <= 0).all()
    np.testing.assert_array_equal(
        lut, j_pbit.threshold_lut(betas, 0.03, 50, fmt=j_pbit.S41))


def test_lut_rejects_negative_beta():
    with pytest.raises(ValueError):
        threshold_lut([-0.5, 1.0], 1.0, 4)
    with pytest.raises(ValueError):
        j_pbit.threshold_lut([-0.5, 1.0], 1.0, 4)


@pytest.mark.parametrize("width", [13, 201])
def test_lut_accept_equals_direct_lookup(width):
    """The port's accept (a direct lookup at any width) equals the
    definition u >= thr[field + f_off] and the reference's rank-count
    (narrow) or gather (wide) accept."""
    f_max = (width - 1) // 2
    thr = threshold_lut([1.3], 1.0 / max(f_max, 1), f_max)[0]
    field = RNG.integers(-f_max, f_max + 1, size=(9, 7)).astype(np.int32)
    u = RNG.integers(0, 1 << LFSR_UNIFORM_BITS, size=(9, 7),
                     dtype=np.uint32)
    got = lut_accept(torch.from_numpy(thr.astype(np.int64)),
                     torch.from_numpy(field), f_max,
                     torch.from_numpy(u.astype(np.int64))).numpy()
    want = u >= thr[field + f_max]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(j_pbit.lut_accept(thr, field, f_max, u)))


# -- staircase -> row indices -------------------------------------------------

def test_beta_row_indices_round_trip():
    sch = ea_schedule(100)
    arr = sch.beta_array()
    table = beta_table(arr)
    rows = beta_row_indices(arr, table)
    np.testing.assert_array_equal(table[rows], arr)
    np.testing.assert_array_equal(rows, j_ann.beta_row_indices(
        arr, j_ann.beta_table(arr)))
    # per-replica fans map elementwise, any shape
    bR = replica_beta_arrays(sch, 4, spread=0.25)
    tR = beta_table(bR)
    rR = beta_row_indices(bR, tR)
    assert rR.shape == bR.shape and rR.dtype == np.int32
    np.testing.assert_array_equal(tR[rR], bR)
    jbR = j_ann.replica_beta_arrays(j_ann.ea_schedule(100), 4, spread=0.25)
    np.testing.assert_array_equal(bR, jbR)
    np.testing.assert_array_equal(rR, j_ann.beta_row_indices(
        jbR, j_ann.beta_table(jbR)))


def test_beta_row_indices_unknown_beta_rejected():
    with pytest.raises(ValueError):
        beta_row_indices(np.array([0.5, 0.7]), np.array([0.5, 1.0]))


def test_array_schedule_preserves_dtype_and_shape():
    rows = np.arange(12, dtype=np.int32).reshape(6, 2)
    sched = ArraySchedule(rows)
    assert sched.total_sweeps == 6
    assert sched.beta_array().dtype == np.int32
    np.testing.assert_array_equal(sched.beta_array(),
                                  j_ann.ArraySchedule(rows).beta_array())


# -- statistical equivalence int8 vs f32 --------------------------------------

def test_int8_statistically_matches_f32_ea3d():
    """Same EA3D instance, same schedule, R independent replicas per
    precision: mean final (annealed) energy and aggregate flip probability
    must agree within ensemble tolerance; the int8 run is the
    reference's, bitwise."""
    R, SW = 6, 240
    res = {}
    for prec in ("f32", "int8"):
        out = lattice_runs(prec, 6, 7, R, ea_schedule(SW), [SW], 1,
                           ref=prec == "int8")
        rec = out[2]
        res[prec] = (float(rec.energies[-1].numpy().mean()), rec.flips)
        if prec == "int8":
            np.testing.assert_array_equal(rec.energies.numpy(),
                                          np.asarray(out[4].energies))
            assert rec.flips == out[4].flips
    e_f32, fl_f32 = res["f32"]
    e_i8, fl_i8 = res["int8"]
    assert e_f32 < 0 and e_i8 < 0
    assert abs(e_i8 - e_f32) / abs(e_f32) < 0.05
    assert abs(fl_i8 - fl_f32) / fl_f32 < 0.10


def test_int8_flip_probability_matches_f32_at_fixed_beta():
    """Per-site flip probability over many sweeps at constant beta; the
    int8 flips are the reference's."""
    R, SW, L = 4, 200, 6
    prob = {}
    for prec in ("f32", "int8"):
        out = lattice_runs(prec, L, 3, R, constant_schedule(1.0, SW), [SW],
                           2, ref=prec == "int8")
        prob[prec] = out[2].flips / (L ** 3 * R * SW)
        if prec == "int8":
            assert out[2].flips == out[4].flips
    assert 0.02 < prob["f32"] < 0.95
    assert abs(prob["int8"] - prob["f32"]) < 0.02


def test_dsim_int8_statistically_matches_f32():
    """The partitioned engine at int8 and f32; its int8 run from the
    port's initial spins is the reference's, bitwise."""
    from repro.core.coloring import lattice3d_coloring as j_col
    from repro.core.graph import ea3d as j_ea3d
    from repro.engines.base import spawn_seeds as j_spawn, stack_states
    from repro_torch.core.coloring import lattice3d_coloring
    from repro_torch.core.graph import ea3d
    from repro_torch.core.partition import slab_partition
    g = ea3d(6, seed=7, **CPU)
    col = lattice3d_coloring(6)
    labels = slab_partition(6, 2)
    means = {}
    for prec in ("f32", "int8"):
        h = make_engine("dsim", g, coloring=col, K=2, labels=labels,
                        rng="lfsr", precision=prec, replicas=4, **CPU)
        st0 = h.init_state(seed=0)
        st, rec = h.run_recorded(st0, ea_schedule(200), [200], sync_every=4)
        means[prec] = float(rec.energies[-1].numpy().mean())
        if prec == "int8":
            jh = j_make("dsim", j_ea3d(6, seed=7), coloring=j_col(6), K=2,
                        labels=labels, rng="lfsr", precision=prec,
                        replicas=4)
            m0 = h.eng.global_spins(st0).numpy()
            js0 = stack_states([jh.eng.init_state(s, m0=m0[r]) for r, s in
                                enumerate(j_spawn(0, 4))])
            js, jrec = jh.run_recorded(js0, j_ann.ea_schedule(200), [200],
                                       sync_every=4)
            np.testing.assert_array_equal(rec.energies.numpy(),
                                          np.asarray(jrec.energies))
    assert means["int8"] < 0
    assert abs(means["int8"] - means["f32"]) / abs(means["f32"]) < 0.05


# -- per-replica staircases on the integer path -------------------------------

def test_per_replica_staircase_rides_int8_path():
    R = 3
    sch = ea_schedule(48)
    bR = replica_beta_arrays(sch, R, spread=0.3)
    outs = {}
    for prec in ("f32", "int8"):
        out = lattice_runs(prec, 6, 7, R, sch, [48], 0, ref=prec == "int8",
                           betas_R=bR)
        outs[prec] = out[2].energies[-1].numpy()
        if prec == "int8":
            np.testing.assert_array_equal(outs[prec],
                                          np.asarray(out[4].energies[-1]))
    assert outs["int8"].shape == (R,)
    # the annealing-rate fan actually differentiates the replicas
    assert len(np.unique(outs["int8"])) > 1
    # and the fanned ensembles agree across precisions
    assert abs(outs["int8"].mean() - outs["f32"].mean()) \
        / abs(outs["f32"].mean()) < 0.05


# -- registry guards ----------------------------------------------------------

def test_registry_precision_guards():
    from repro_torch.core.coloring import lattice3d_coloring
    from repro_torch.core.graph import ea3d
    g = ea3d(4, seed=0, **CPU)
    col = lattice3d_coloring(4)
    with pytest.raises(ValueError):
        make_engine("gibbs", g, coloring=col, precision="int8", **CPU)
    with pytest.raises(ValueError):
        make_engine("lattice", L=4, precision="fp4", **CPU)
    with pytest.raises(ValueError):
        make_engine("dsim", g, coloring=col, K=2,
                    labels=np.zeros(g.n, np.int32), rng="philox",
                    precision="int8", **CPU)
