"""Host-side foundations of the PyTorch port against the JAX package.

Everything that seeds or shapes the fixed-point dynamics is computed on the
host (numpy, f64 for the threshold LUT), so the port must reproduce the
reference array for array, bit for bit, at several lattice sizes and seeds.
"""

import numpy as np
import pytest
import torch

import repro.core.annealing as j_ann
import repro.core.coloring as j_col
import repro.core.graph as j_graph
import repro.core.lattice as j_lat
import repro.core.packing as j_pack
import repro.core.pbit as j_pbit
import repro.engines.base as j_base
import repro_torch.core.annealing as t_ann
import repro_torch.core.coloring as t_col
import repro_torch.core.graph as t_graph
import repro_torch.core.lattice as t_lat
import repro_torch.core.packing as t_pack
import repro_torch.core.pbit as t_pbit
import repro_torch.engines.base as t_base
from repro_torch.core.bits import (i64_to_u32, u32_from_numpy, u32_to_i64,
                                   u32_to_numpy)

LS = (4, 5, 6, 7)
SEEDS = (0, 3, 11)


def np_of(x):
    """numpy view of a tensor (uint32 kept as uint32) or a jax array."""
    if isinstance(x, torch.Tensor):
        return u32_to_numpy(x) if x.dtype == torch.uint32 else x.numpy()
    return np.asarray(x)


def assert_same(a, b):
    a, b = np_of(a), np_of(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def problem_pair(L, seed):
    return (j_lat.build_ea3d_lattice(L, seed=seed),
            t_lat.build_ea3d_lattice(L, seed=seed, device="cpu"))


@pytest.mark.parametrize("seed", SEEDS + (2 ** 31 - 1,))
def test_lfsr_init_bitwise(seed):
    assert_same(j_pbit.lfsr_init(1000, seed), t_pbit.lfsr_init(1000, seed))


@pytest.mark.parametrize("L", LS)
def test_ea3d_edges_and_coloring(L):
    for seed in SEEDS:
        for a, b in zip(j_graph.ea3d_edges(L, seed),
                        t_graph.ea3d_edges(L, seed)):
            assert_same(a, b)
    ca, cb = j_col.lattice3d_coloring(L), t_col.lattice3d_coloring(L)
    assert ca.n_colors == cb.n_colors == (3 if L % 2 else 2)
    assert_same(ca.colors, cb.colors)
    for ga, gb in zip(ca.groups, cb.groups):
        assert_same(ga, gb)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("seed", SEEDS)
def test_build_ea3d_lattice_bitwise(L, seed):
    jp, tp = problem_pair(L, seed)
    assert (jp.L, jp.dims, jp.seed, jp.n_colors, jp.n_active) == \
        (tp.L, tp.dims, tp.seed, tp.n_colors, tp.n_active)
    for a, b in zip((jp.h, jp.masks, jp.active) + tuple(jp.w6),
                    (tp.h, tp.masks, tp.active) + tuple(tp.w6)):
        assert_same(a, b)


def test_build_ea3d_lattice_padded_and_guards():
    jp = j_lat.build_ea3d_lattice(5, seed=1, pad_xy=(7, 6))
    tp = t_lat.build_ea3d_lattice(5, seed=1, pad_xy=(7, 6), device="cpu")
    assert tp.dims == jp.dims == (7, 6, 5)
    for a, b in zip((jp.masks, jp.active) + tuple(jp.w6),
                    (tp.masks, tp.active) + tuple(tp.w6)):
        assert_same(a, b)
    with pytest.raises(ValueError, match="shrink"):
        t_lat.build_ea3d_lattice(5, pad_xy=(4, 5), device="cpu")


def general_problem(rng, shape, hscale=0.3):
    h = rng.normal(0, hscale, shape).astype(np.float32)
    w6 = [rng.normal(0, 1.0, shape).astype(np.float32) for _ in range(6)]
    return h, w6


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("fmt", [None, "S41"])
def test_quantize_and_threshold_lut_bitwise(L, fmt):
    jfmt = None if fmt is None else j_pbit.S41
    tfmt = None if fmt is None else t_pbit.S41
    betas = j_ann.beta_table(j_ann.ea_schedule(64).beta_array())
    rng = np.random.default_rng(L)
    jp, tp = problem_pair(L, seed=L)
    cases = [((jp.h, jp.w6), (tp.h, tp.w6)),
             (general_problem(rng, jp.dims),) * 2]
    for (jh, jw), (th, tw) in cases:
        jq = j_pbit.quantize_couplings(jh, jw)
        tq = t_pbit.quantize_couplings(th, tw)
        assert jq[2] == tq[2]
        for a, b in zip((jq[0],) + tuple(jq[1]), (tq[0],) + tuple(tq[1])):
            assert_same(a, b)
        fa = j_pbit.field_bound(jq[0], jq[1])
        assert fa == t_pbit.field_bound(tq[0], tq[1])
        assert_same(j_pbit.threshold_lut(betas, jq[2], fa, fmt=jfmt),
                    t_pbit.threshold_lut(betas, tq[2], fa, fmt=tfmt))
    # +-J quantizes exactly onto +-1 (the LUT stays 13 wide)
    assert fa > 6 and t_pbit.field_bound(*t_pbit.quantize_couplings(
        tp.h, tp.w6)[:2]) == 6


def test_threshold_lut_cached_and_guards():
    cache = {}
    table = np.asarray([0.5, 1.0, 2.5], np.float32)
    a = t_pbit.threshold_lut_cached(cache, table, 1.0, 6, device="cpu")
    b = t_pbit.threshold_lut_cached(cache, table, 1.0, 6, device="cpu")
    assert a is b and a.dtype == torch.uint32 and len(cache) == 1
    assert_same(a, j_pbit.threshold_lut(table, 1.0, 6))
    t_pbit.threshold_lut_cached(cache, table, 1.0, 6, fmt=t_pbit.S41,
                                device="cpu")
    assert len(cache) == 2
    for mod in (j_pbit, t_pbit):
        with pytest.raises(ValueError, match="beta >= 0"):
            mod.threshold_lut([-1.0], 1.0, 6)


@pytest.mark.parametrize("L", LS)
def test_bitplane_planes_bitwise_and_guard(L):
    jp, tp = problem_pair(L, seed=1)
    jq = j_pbit.quantize_couplings(jp.h, jp.w6)
    tq = t_pbit.quantize_couplings(tp.h, tp.w6)
    ja, ta = j_pbit.bitplane_planes(*jq[:2]), t_pbit.bitplane_planes(*tq[:2])
    assert ja[3] == ta[3]
    for a, b in zip(tuple(ja[0]) + tuple(ja[1]) + (ja[2],),
                    tuple(ta[0]) + tuple(ta[1]) + (ta[2],)):
        assert_same(a, b)
    # multi-bit couplings fail the same way in both packages
    h, w6 = general_problem(np.random.default_rng(L), jp.dims)
    msgs = []
    for mod in (j_pbit, t_pbit):
        q = mod.quantize_couplings(h, w6)
        with pytest.raises(ValueError, match="precision='int8'") as e:
            mod.bitplane_planes(*q[:2])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("R", [1, 20, 32, 33, 64, 256])
def test_pack_unpack_lanes_bitwise(R):
    x = np.random.default_rng(R).choice(np.array([-1, 1], np.int8),
                                        size=(R, 3, 4, 5))
    jw = j_pack.pack_lanes(x)
    tw = t_pack.pack_lanes(torch.from_numpy(x))
    assert_same(jw, tw)
    assert_same(j_pack.unpack_lanes(jw, R), t_pack.unpack_lanes(tw, R))
    assert_same(t_pack.unpack_lanes(tw, R), x)
    assert t_pack.lane_words(R) == j_pack.lane_words(R)
    assert (t_pack.LANE_WIDTH, t_pack.MAX_LANE_WORDS) == \
        (j_pack.LANE_WIDTH, j_pack.MAX_LANE_WORDS)


def test_lane_guards():
    for bad in (0, 8 * 32 + 1):
        with pytest.raises(ValueError, match="n_lanes"):
            t_pack.lane_words(bad)
    with pytest.raises(ValueError, match="word planes"):
        t_pack.unpack_lanes(t_pack.pack_lanes(torch.ones(33, 2, 2)), 32)


def test_u32_carriers_round_trip():
    a = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 0x9E3779B9], np.uint32)
    t = u32_from_numpy(a, "cpu")
    assert t.dtype == torch.uint32
    assert_same(u32_to_numpy(i64_to_u32(u32_to_i64(t))), a)
    assert u32_to_i64(t).tolist() == [int(v) for v in a]


@pytest.mark.parametrize("sweeps", [16, 100, 256])
def test_schedules_and_row_indices_bitwise(sweeps):
    ja, ta = j_ann.ea_schedule(sweeps), t_ann.ea_schedule(sweeps)
    assert_same(ja.beta_array(), ta.beta_array())
    assert_same(ja.bounds, ta.bounds)
    table = t_ann.beta_table(ta.beta_array())
    assert_same(j_ann.beta_table(ja.beta_array()), table)
    for spread in (0.0, 0.3):
        jb = j_ann.replica_beta_arrays(ja, 5, spread=spread)
        tb = t_ann.replica_beta_arrays(ta, 5, spread=spread)
        assert_same(jb, tb)
        jt = j_ann.beta_table(jb)
        assert_same(j_ann.beta_row_indices(jb, jt),
                    t_ann.beta_row_indices(tb, t_ann.beta_table(tb)))
    with pytest.raises(ValueError, match="not in the LUT"):
        t_ann.beta_row_indices([0.75], table)
    rows = t_ann.ArraySchedule(t_ann.beta_row_indices(ta.beta_array(),
                                                      table))
    assert rows.beta_array().dtype == np.int32
    assert rows.total_sweeps == sweeps


@pytest.mark.parametrize("points,cap", [
    ([8, 16], None), ([3, 10, 17, 64], None), ([5, 5, 9], 2),
    ([100, 257, 1000], 16), ([], None)])
def test_chunk_plan_bitwise(points, cap):
    assert j_base.chunk_plan(points, max_chunk=cap) == \
        t_base.chunk_plan(points, max_chunk=cap)


def test_chunk_plan_guards_and_caps():
    for mod in (j_base, t_base):
        with pytest.raises(ValueError, match="power of two"):
            mod.chunk_plan([4], max_chunk=3)
        with pytest.raises(ValueError, match="nondecreasing"):
            mod.chunk_plan([4, 2])
    for fps, S in [(10 ** 6, 8), (64 * 10 ** 6, 8), (1, 1), (0, 0),
                   (3 * 10 ** 9, 1)]:
        assert j_base.flips_chunk_cap(fps, S) == t_base.flips_chunk_cap(fps,
                                                                         S)
    for pts, S, lim in [([7, 16, 33], 8, None), ([3], 4, 2), ([100], 8, 64),
                        ([1, 2, 3], 1, None)]:
        assert j_base.quantize_record_points(pts, S, lim) == \
            t_base.quantize_record_points(pts, S, lim)


@pytest.mark.parametrize("seed", SEEDS)
def test_spawn_seeds_bitwise(seed):
    for R in (1, 2, 33, 64):
        assert j_base.spawn_seeds(seed, R) == t_base.spawn_seeds(seed, R)
    # replica r of (seed, R) equals replica r of (seed, R')
    assert t_base.spawn_seeds(seed, 64)[:33] == t_base.spawn_seeds(seed, 33)


def test_precision_and_lane_checks_match():
    assert t_base.PRECISIONS == j_base.PRECISIONS
    for prec, R in [("int8", 5), ("bitplane", 1), ("bitplane", 33),
                    ("bitplane", 256), ("f32", 7)]:
        assert t_base.check_lanes(prec, R) == j_base.check_lanes(prec, R)
    for mod in (j_base, t_base):
        with pytest.raises(ValueError, match=r"\[1, 256\]"):
            mod.check_lanes("bitplane", 257)
        with pytest.raises(ValueError, match=">= 1"):
            mod.check_lanes("int8", 0)
        with pytest.raises(ValueError, match="not supported on engine"):
            mod.check_precision("gibbs", "int8")
        with pytest.raises(ValueError, match="unknown precision"):
            mod.check_precision("lattice", "fp4")


def test_flips_publish_is_uint32_modular():
    import jax.numpy as jnp
    odo = np.array([0, 5, 2 ** 31 - 1, -1, -2 ** 31], np.int32)
    delta = np.array([3, 2 ** 32 - 5, 2, 1, 7], np.uint32)
    want = np.asarray(j_pbit.flips_publish(jnp.asarray(odo),
                                           jnp.asarray(delta)))
    got = t_pbit.flips_publish(torch.from_numpy(odo),
                               u32_from_numpy(delta, "cpu"))
    assert got.dtype == torch.int32
    assert_same(want, got)
    # an int64 delta (the engine's per-chunk accumulator) folds the same
    got64 = t_pbit.flips_publish(torch.from_numpy(odo),
                                 torch.from_numpy(delta.astype(np.int64)))
    assert_same(want, got64)
