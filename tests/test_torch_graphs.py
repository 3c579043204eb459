"""The port's graph-side host pieces against the JAX package.

Graphs, colourings, partitions, the partitioned problem, the Potts
partitioner, the communication costs, the analysis of residual-energy
traces, the schedules and the four problem builders are host numpy code
copied from the reference (the port may not import it): on the same
seeds they must give the same arrays, bit for bit.  The device-side
observables (energies, local fields, cut values) are held exactly on
+-J and integer couplings, where every partial sum is an exact integer
in f32.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import repro.core.analysis as j_an
import repro.core.annealing as j_ann
import repro.core.coloring as j_col
import repro.core.commcost as j_cc
import repro.core.energy as j_en
import repro.core.graph as j_graph
import repro.core.partition as j_part
import repro.core.pbit as j_pbit
import repro.core.potts_partition as j_potts
import repro.problems.ea3d as j_ea
import repro.problems.maxcut as j_mc
import repro.problems.planting as j_plant
import repro.problems.sat as j_sat
from repro.core.dsim import build_partitioned as j_build
import repro_torch.core.analysis as t_an
import repro_torch.core.annealing as t_ann
import repro_torch.core.coloring as t_col
import repro_torch.core.commcost as t_cc
import repro_torch.core.energy as t_en
import repro_torch.core.graph as t_graph
import repro_torch.core.partition as t_part
import repro_torch.core.pbit as t_pbit
import repro_torch.core.potts_partition as t_potts
import repro_torch.problems.ea3d as t_ea
import repro_torch.problems.maxcut as t_mc
import repro_torch.problems.planting as t_plant
import repro_torch.problems.sat as t_sat
from repro_torch.core.dsim import PartitionedProblem
from repro_torch.core.dsim import build_partitioned as t_build
from repro_torch.interop import graph_from_numpy

CPU = dict(device="cpu")


def assert_graph_equal(jg, tg):
    for f in ("idx", "w", "h"):
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)
    assert jg.meta == tg.meta
    assert (jg.n, jg.max_degree, jg.num_edges) == \
        (tg.n, tg.max_degree, tg.num_edges)


# (reference builder, port builder, args) of every graph family
GRAPHS = {
    "ea3d L=2": ("ea3d", (2,), dict(seed=1)),
    "ea3d L=4": ("ea3d", (4,), dict(seed=0)),
    "ea3d L=5": ("ea3d", (5,), dict(seed=7)),
    "toroidal pm1": ("toroidal_grid", (6, 8), dict(seed=2)),
    "toroidal ones": ("toroidal_grid", (4, 5), dict(seed=0, weights="ones")),
    "random regular d=3": ("random_regular", (40, 3), dict(seed=1)),
    "random regular d=6": ("random_regular", (30, 6), dict(seed=4)),
}


def graphs(name):
    fn, args, kw = GRAPHS[name]
    return (getattr(j_graph, fn)(*args, **kw),
            getattr(t_graph, fn)(*args, **kw, **CPU))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_builders_match_jax(name):
    jg, tg = graphs(name)
    assert_graph_equal(jg, tg)
    for a, b in zip(j_graph.edges_from_ell(jg), t_graph.edges_from_ell(tg)):
        np.testing.assert_array_equal(a, b)


def test_from_edges_with_biases_and_its_checks():
    rng = np.random.default_rng(3)
    ei, ej = np.array([0, 1, 2, 0]), np.array([1, 2, 3, 3])
    ew = rng.normal(size=4).astype(np.float32)
    h = rng.normal(size=5).astype(np.float32)
    assert_graph_equal(j_graph.from_edges(5, ei, ej, ew, h=h, meta={"a": 1}),
                       t_graph.from_edges(5, ei, ej, ew, h=h, meta={"a": 1},
                                          **CPU))
    for bad, what in (((ei, ej, ew[:3]), "equal length"),
                      ((ei, ej + 2, ew), "out of range"),
                      ((ei, ei, ew), "self loops")):
        with pytest.raises(ValueError, match=what):
            t_graph.from_edges(5, *bad, **CPU)
    with pytest.raises(ValueError, match="even"):
        t_graph.random_regular(5, 3, **CPU)
    # the graph moves between devices and crosses from numpy unchanged
    jg = j_graph.ea3d(3, seed=2)
    tg = graph_from_numpy(np.asarray(jg.idx), np.asarray(jg.w),
                          np.asarray(jg.h), meta=jg.meta, **CPU)
    assert_graph_equal(jg, tg)
    assert tg.to("cpu") is tg and tg.device == torch.device("cpu")


@pytest.mark.parametrize("name", list(GRAPHS))
def test_colorings_match_jax(name):
    jg, tg = graphs(name)
    jc = j_col.greedy_coloring(np.asarray(jg.idx), np.asarray(jg.w))
    tc = t_col.greedy_coloring(tg.idx, tg.w)
    np.testing.assert_array_equal(jc.colors, tc.colors)
    assert jc.n_colors == tc.n_colors and repr(jc) == repr(tc)
    for a, b in zip(j_col.color_groups(jc.colors),
                    t_col.color_groups(tc.colors)):
        np.testing.assert_array_equal(a, b)
    assert t_col.validate_coloring(tg.idx, tg.w, tc.colors)
    bad = tc.colors.copy()
    bad[:] = 0
    assert t_col.validate_coloring(tg.idx, tg.w, bad) == \
        j_col.validate_coloring(np.asarray(jg.idx), np.asarray(jg.w), bad)


@pytest.mark.parametrize("name", ["ea3d L=5", "toroidal pm1",
                                  "random regular d=6", "gaussian"])
@pytest.mark.parametrize("R", [None, 3])
def test_energy_fields_and_cut_match_jax(name, R):
    """Exact on +-J; on Gaussian couplings within 1e-6 of the energy's
    scale (the sum of |terms|), the summation order being another."""
    if name == "gaussian":
        rng = np.random.default_rng(5)
        ei, ej = np.triu_indices(12, 1)
        keep = rng.random(len(ei)) < 0.3
        ew = rng.normal(size=keep.sum()).astype(np.float32)
        h = rng.normal(size=12).astype(np.float32)
        jg = j_graph.from_edges(12, ei[keep], ej[keep], ew, h=h)
        tg = t_graph.from_edges(12, ei[keep], ej[keep], ew, h=h, **CPU)
    else:
        jg, tg = graphs(name)
    rng = np.random.default_rng(0)
    shape = (tg.n,) if R is None else (R, tg.n)
    m = rng.choice(np.array([-1, 1], np.int8), size=shape)
    tm = torch.from_numpy(m)
    for fn in ("local_fields", "energy", "cut_value"):
        jfn = getattr(j_en, fn)
        want = np.asarray(jfn(jg, m)) if R is None else \
            np.stack([np.asarray(jfn(jg, mr)) for mr in m])
        got = getattr(t_en, fn)(tg, tm).numpy()
        assert got.shape == want.shape
        if name == "gaussian":
            scale = np.abs(np.asarray(jg.w)).sum() + np.abs(
                np.asarray(jg.h)).sum()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
        else:
            np.testing.assert_array_equal(got, want)
    assert t_en.residual_energy(-90.0, -100.0, 10) == \
        j_en.residual_energy(-90.0, -100.0, 10)


def test_partitions_match_jax():
    for L, K, axis in ((6, 3, 0), (8, 4, 2), (5, 2, 1)):
        np.testing.assert_array_equal(j_part.slab_partition(L, K, axis),
                                      t_part.slab_partition(L, K, axis))
    for dims, bricks in (((4, 4, 4), (2, 2, 1)), ((6, 4, 8), (3, 1, 2))):
        np.testing.assert_array_equal(j_part.brick_partition(dims, bricks),
                                      t_part.brick_partition(dims, bricks))
    for name, K in (("ea3d L=4", 3), ("random regular d=3", 4),
                    ("toroidal pm1", 2)):
        jg, tg = graphs(name)
        idx, w = np.asarray(jg.idx), np.asarray(jg.w)
        for seed in (0, 5):
            jl = j_part.greedy_partition(idx, w, K, seed=seed)
            tl = t_part.greedy_partition(tg.idx, tg.w, K, seed=seed)
            np.testing.assert_array_equal(jl, tl)
            np.testing.assert_array_equal(
                j_part.refine_partition(idx, w, jl, K, passes=2),
                t_part.refine_partition(tg.idx, tg.w, tl, K, passes=2))
            assert j_part.cut_edges(idx, w, jl) == \
                t_part.cut_edges(tg.idx, tg.w, tl)
            np.testing.assert_array_equal(j_part.partition_sizes(jl, K),
                                          t_part.partition_sizes(tl, K))


def test_potts_partition_matches_jax():
    jg, tg = graphs("ea3d L=4")
    idx, w = np.asarray(jg.idx), np.asarray(jg.w)
    for K, kw in ((4, dict(seed=1, steps=20)),
                  (3, dict(seed=2, steps=15, lam=0.5, frac=0.3)),
                  (2, dict(init=np.arange(64) % 2, steps=10))):
        jl = j_potts.potts_partition(idx, w, K, **kw)
        tl = t_potts.potts_partition(tg.idx, tg.w, K, **kw)
        np.testing.assert_array_equal(jl, tl)
        assert j_potts.potts_energy(idx, w, jl, K, lam=0.1) == \
            t_potts.potts_energy(tg.idx, tg.w, tl, K, lam=0.1)


def test_commcost_matches_jax():
    jg, tg = graphs("ea3d L=4")
    idx, w = np.asarray(jg.idx), np.asarray(jg.w)
    for K, labels in ((4, j_part.slab_partition(4, 4)),
                      (9, np.arange(64) % 9)):
        jb = j_cc.boundary_matrix(idx, w, labels, K)
        tb = t_cc.boundary_matrix(tg.idx, tg.w, labels, K)
        np.testing.assert_array_equal(jb, tb)
        pins = list(range(1, K))
        for jt, tt in ((j_cc.ChainTopology(pins), t_cc.ChainTopology(pins)),
                       (j_cc.RingTopology(K, 3), t_cc.RingTopology(K, 3))):
            jc, tc = j_cc.comm_cost(jb, jt), t_cc.comm_cost(tb, tt)
            assert (jc.c_tot, jc.c_max, jc.worst_pair, jc.per_pair) == \
                (tc.c_tot, tc.c_max, tc.worst_pair, tc.per_pair)
        for obj in ("c_tot", "c_max"):
            jo, js = j_cc.best_chain_permutation(
                jb, j_cc.ChainTopology(pins), obj)
            to, ts = t_cc.best_chain_permutation(
                tb, t_cc.ChainTopology(pins), obj)
            np.testing.assert_array_equal(jo, to)
            assert js == ts
        np.testing.assert_array_equal(
            j_cc.cut_distance_histogram(idx, w, labels, K=K),
            t_cc.cut_distance_histogram(tg.idx, tg.w, labels, K=K))
    assert j_cc.eta_threshold(2, 7.5) == t_cc.eta_threshold(2, 7.5)


def test_analysis_matches_jax():
    rng = np.random.default_rng(4)
    t = np.unique(np.geomspace(1, 1000, 24).astype(int))
    rho = 0.5 * t ** -0.3 * np.exp(rng.normal(0, 0.05, len(t)))
    runs = rho[None] * np.exp(rng.normal(0, 0.1, (7, len(t))))
    for window in (None, (4, 500)):
        assert dataclasses.astuple(j_an.fit_kappa(t, rho, window)) == \
            dataclasses.astuple(t_an.fit_kappa(t, rho, window))
        assert j_an.bootstrap_kappa(t, runs, window, n_boot=50, seed=3) == \
            t_an.bootstrap_kappa(t, runs, window, n_boot=50, seed=3)
    assert np.isnan(t_an.fit_kappa(t[:1], rho[:1]).kappa)
    for samples in (runs[:, 0], runs):
        assert j_an.bootstrap_ci(samples, n_boot=40, seed=1) == \
            t_an.bootstrap_ci(samples, n_boot=40, seed=1)
    for target in (rho[0] * 2, rho[5], 1e-9):
        assert j_an.time_to_target(t, rho, target) == \
            t_an.time_to_target(t, rho, target)
    for sync in ("phase", None, 1, 8):
        assert j_an.eta_from_sync(sync, 2, 3.0) == \
            t_an.eta_from_sync(sync, 2, 3.0)


@pytest.mark.parametrize("which", ["sat", "geometric", "constant"])
def test_schedules_match_jax(which):
    args = {"sat": (100,), "geometric": (0.1, 3.0, 7, 50),
            "constant": (1.5, 9)}[which]
    jfn = getattr(j_ann, f"{which}_schedule")
    tfn = getattr(t_ann, f"{which}_schedule")
    np.testing.assert_array_equal(jfn(*args).beta_array(),
                                  tfn(*args).beta_array())


@pytest.mark.parametrize("width", [13, 91])
def test_lut_accept_direct_lookup_matches_rank_count(width):
    """The port's direct lookup and the reference's rank count (narrow
    rows) or clipped gather (wide rows) give the same bits, fields below
    and above the row's ends included (the clip)."""
    f_max = (width - 1) // 2
    lut = j_pbit.threshold_lut(np.array([0.3, 1.7], np.float32), 0.25, f_max)
    rng = np.random.default_rng(width)
    field = rng.integers(-f_max - 9, f_max + 10, size=4000).astype(np.int32)
    u = rng.integers(0, 1 << 24, size=4000).astype(np.uint32)
    u[:50] = lut[1][np.clip(field[:50] + f_max, 0, width - 1)]   # at T
    for row in lut:
        want = np.asarray(j_pbit.lut_accept(row, field, f_max, u))
        got = t_pbit.lut_accept(torch.from_numpy(row.astype(np.int64)),
                                torch.from_numpy(field), f_max,
                                torch.from_numpy(u.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want)


def sat_graphs():
    clauses = j_sat.random_3sat(20, 85, seed=426)
    np.testing.assert_array_equal(clauses, t_sat.random_3sat(20, 85, 426))
    je = j_sat.encode_3sat(clauses, 20)
    te = t_sat.encode_3sat(clauses, 20, **CPU)
    return clauses, je, te


# (label, graph maker, coloring, labels maker, K) for build_partitioned
PARTITIONED = {
    "ea3d slab": (lambda: graphs("ea3d L=4"),
                  lambda g: j_col.lattice3d_coloring(4),
                  lambda g: j_part.slab_partition(4, 2), 2),
    "ea3d L=5 brick": (lambda: graphs("ea3d L=5"),
                       lambda g: j_col.lattice3d_coloring(5),
                       lambda g: j_part.brick_partition((5, 5, 5),
                                                        (2, 2, 1)), 4),
    "random regular greedy": (
        lambda: graphs("random regular d=3"),
        lambda g: j_col.greedy_coloring(np.asarray(g.idx), np.asarray(g.w)),
        lambda g: j_part.greedy_partition(np.asarray(g.idx),
                                          np.asarray(g.w), 3, seed=0), 3),
    "toroidal one part": (
        lambda: graphs("toroidal pm1"),
        lambda g: j_col.greedy_coloring(np.asarray(g.idx), np.asarray(g.w)),
        lambda g: np.zeros(g.n, np.int32), 1),
    "sat greedy": (
        lambda: sat_graphs()[1:],
        lambda g: j_col.greedy_coloring(np.asarray(g.idx), np.asarray(g.w)),
        lambda g: j_part.greedy_partition(np.asarray(g.idx),
                                          np.asarray(g.w), 4, seed=0), 4),
}


@pytest.mark.parametrize("label", list(PARTITIONED))
def test_build_partitioned_matches_jax_field_by_field(label):
    make, color, part, K = PARTITIONED[label]
    jg, tg = make()
    if hasattr(jg, "graph"):          # a SAT encoding
        jg, tg = jg.graph, tg.graph
    col = color(jg)
    labels = part(jg)
    jp = j_build(jg, col, labels, K)
    tp = t_build(tg, t_col.Coloring(col.colors), labels, K)
    for f in ("K", "n", "n_max", "g_max", "b_max"):
        assert getattr(jp, f) == getattr(tp, f), f
    for f in ("local_idx", "local_w", "local_h", "valid", "ghost_src",
              "global_ids", "bnd_slots", "bnd_mask", "ghost_src_packed"):
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(jp.color_slots) == len(tp.color_slots)
    for name in ("color_slots", "color_mask"):
        for a, b in zip(getattr(jp, name), getattr(tp, name)):
            assert np.asarray(a).dtype == b.numpy().dtype
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(jp.labels, tp.labels)
    # the padding rows the phase gathers rely on
    gid = tp.global_ids.numpy()
    assert ((gid == tp.n) == ~tp.valid.numpy()).all()
    assert isinstance(tp, PartitionedProblem)
    assert tp.to("cpu") is tp
    with pytest.raises(ValueError, match="labels shape"):
        t_build(tg, t_col.Coloring(col.colors), labels[:-1], K)


def test_ea3d_problems_match_jax(tmp_path):
    for jg, tg in zip(j_ea.instance_set(3, 3, seed0=5),
                      t_ea.instance_set(3, 3, seed0=5, **CPU)):
        assert_graph_equal(jg, tg)
    path = str(tmp_path / "g" / "grounds.json")
    js, ts = j_ea.GroundStore(path + ".j"), t_ea.GroundStore(path)
    for L, seed, e in ((4, 1, -90.0), (4, 1, -95.0), (4, 1, -80.0),
                       (5, 2, -200.0)):
        assert js.update(L, seed, e) == ts.update(L, seed, e)
    assert ts.key(4, 1) == j_ea.GroundStore.key(4, 1)
    assert t_ea.GroundStore(path).get(4, 1) == -95.0
    with open(path) as f, open(path + ".j") as g:
        assert json.load(f) == json.load(g)
    # the grounds come from the port's Gibbs engine (philox, so only
    # statistically the reference's): an anneal of a +-J L=4 instance ends
    # between its energy's floor (-3 per spin) and a random state's (0)
    store = t_ea.GroundStore(str(tmp_path / "t.json"))
    g = t_ea.instance_set(4, 1, seed0=0, **CPU)
    (e,) = t_ea.establish_grounds(g, store, sweeps=64, runs=2, **CPU)
    assert -3 * 64 < e < -1.2 * 64 and store.get(4, 0) == e


def test_maxcut_matches_jax():
    jg = j_mc.gset_like_toroidal(6, 10, seed=3)
    tg = t_mc.gset_like_toroidal(6, 10, seed=3, **CPU)
    assert_graph_equal(jg, tg)
    assert_graph_equal(j_mc.maxcut_to_ising(jg), t_mc.maxcut_to_ising(tg))
    text = "5 4\n1 2 1\n2 3 -1\n3 4 2\n1 5 1\n"
    assert_graph_equal(j_mc.parse_gset(text), t_mc.parse_gset(text, **CPU))
    assert_graph_equal(j_mc.parse_gset(io.StringIO(text)),
                       t_mc.parse_gset(io.StringIO(text), **CPU))
    rng = np.random.default_rng(1)
    for _ in range(3):
        m = rng.choice(np.array([-1, 1], np.int8), size=tg.n)
        assert j_mc.cut_of(jg, m) == t_mc.cut_of(tg, m) == \
            t_mc.cut_of(tg, torch.from_numpy(m))
        hx = j_mc.spins_to_hex(m)
        assert t_mc.spins_to_hex(m) == hx
        np.testing.assert_array_equal(t_mc.hex_to_spins(hx, tg.n), m)


def test_sat_encoding_matches_jax():
    clauses, je, te = sat_graphs()
    assert_graph_equal(je.graph, te.graph)
    assert (je.n_vars, je.n_aux) == (te.n_vars, te.n_aux)
    np.testing.assert_array_equal(je.clauses, te.clauses)
    for a, b in zip(je.copies_of, te.copies_of):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    for _ in range(3):
        m = rng.choice(np.array([-1, 1], np.int8), size=te.graph.n)
        ja = j_sat.decode_assignment(je, m)
        ta = t_sat.decode_assignment(te, torch.from_numpy(m))
        np.testing.assert_array_equal(ja, ta)
        assert j_sat.count_satisfied(clauses, ja) == \
            t_sat.count_satisfied(clauses, ta)


def test_planting_matches_jax():
    for host, n_loops, seed in (("toroidal pm1", 12, 0),
                                ("random regular d=3", 6, 3)):
        jh, th = graphs(host)
        jp = j_plant.plant_frustrated_loops(jh, n_loops, seed=seed)
        tp = t_plant.plant_frustrated_loops(th, n_loops, seed=seed)
        assert_graph_equal(jp.graph, tp.graph)
        np.testing.assert_array_equal(jp.ground_state, tp.ground_state)
        assert jp.ground_energy == tp.ground_energy
        # the planted state is a ground state by construction
        e = float(t_en.energy(tp.graph, torch.from_numpy(tp.ground_state)))
        assert e == tp.ground_energy
