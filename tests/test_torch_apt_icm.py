"""The port's APT+ICM (``repro_torch.core.apt_icm``) against the JAX package.

The reference draws its exchange acceptances, ICM seed scores and f32
uniforms from ``jax.random``, which PyTorch cannot reproduce.  To hold the
port to it bitwise, both take the same values from two ``HostDraws`` of
one seed: the port through its ``draws=`` source, the reference through a
patched ``jax.random.uniform`` with its step run eagerly (a jitted step
would freeze the patch at trace time).  The reference's state is built
from the port's initial spins and LFSR states.  ``rng="lfsr"`` and
``packed=True`` are then bitwise: spins, energies, LFSR states, swap and
ICM counters and the best-energy trace.  ``rng="philox"`` takes ``tanh``
from PyTorch here and from XLA there: at most 1% of the spins may differ
(ties), and where none does everything is bitwise.  On +-J couplings every
energy is an exact integer in f32, in any summation order.

Then the reference's own APT tests (``tests/test_problems.py``) on the
port, the lane operations against the reference's, packed against
unpacked with the port's own generator, snapshot and resume of the
generator, and the state crossing between the packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as j_graph
from repro.core import packing as j_packing
from repro.core.apt_icm import APTICM as JAPT
from repro.core.apt_icm import APTState as JState
from repro.core.coloring import greedy_coloring as j_greedy
from repro.core.coloring import lattice3d_coloring as j_lat_col
from repro.core.pbit import lfsr_init as j_lfsr_init
from repro_torch.core import graph as t_graph
from repro_torch.core import packing as t_packing
from repro_torch.core.annealing import ea_schedule
from repro_torch.core.apt_icm import APTICM, APTState, HostDraws, adapt_ladder
from repro_torch.core.bits import u32_from_numpy, u32_to_numpy
from repro_torch.core.coloring import Coloring, lattice3d_coloring
from repro_torch.core.energy import energy
from repro_torch.core.gibbs import GibbsEngine
from repro_torch.core.pbit import LUT_SELECT_MAX_WIDTH
from repro_torch.core.snapshot import restore_state, snapshot_state
from repro_torch.interop import state_from_numpy, state_to_numpy

CPU = dict(device="cpu")
DRAW_SEED = 11


def ea(L, seed):
    return t_graph.ea3d(L, seed=seed, **CPU), lattice3d_coloring(L)


def run_ref(apt, st, monkeypatch, sweeps, icm_every, record_every,
            draw_seed=DRAW_SEED):
    """The reference's run with its uniforms from HostDraws(draw_seed)."""
    hd = HostDraws(draw_seed)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(hd.sample(shape, minval, maxval))

    monkeypatch.setattr(jax.random, "uniform", uniform)
    apt._step = apt._step_impl
    try:
        return apt.run(st, sweeps, icm_every=icm_every,
                       record_every=record_every)
    finally:
        monkeypatch.undo()


def ref_state(d) -> JState:
    """The reference's APTState from the port's fields (numpy); its key
    is unused, every uniform comes from the patched draw."""
    return JState(m=jnp.asarray(d["m"]), E=jnp.asarray(d["E"]),
                  key=jax.random.PRNGKey(0), sweep=jnp.asarray(d["sweep"]),
                  swaps=jnp.asarray(d["swaps"]), icms=jnp.asarray(d["icms"]),
                  lfsr=None if d["lfsr"] is None else jnp.asarray(d["lfsr"]))


def ref_fields(st: JState) -> dict:
    return {f.name: None if getattr(st, f.name) is None
            else np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st) if f.name != "key"}


GRAPHS = {
    "ea3d L=4": lambda mod, **kw: mod.ea3d(4, seed=1, **kw),
    "maxcut torus 6x8": lambda mod, **kw: mod.toroidal_grid(
        6, 8, seed=81, weights="pm1", **kw),
}


def build_pair(name, betas, **kw):
    """(reference engine, port engine with HostDraws) on one graph."""
    jg = GRAPHS[name](j_graph)
    tg = GRAPHS[name](t_graph, **CPU)
    if name.startswith("maxcut"):
        jg = dataclasses.replace(jg, w=-jg.w)
        tg = dataclasses.replace(tg, w=-tg.w)
    col = j_lat_col(4) if name.startswith("ea3d") else \
        j_greedy(np.asarray(jg.idx), np.asarray(jg.w))
    return (JAPT(jg, col, betas, **kw),
            APTICM(tg, Coloring(col.colors), betas,
                   draws=HostDraws(DRAW_SEED), **kw, **CPU))


# -- the port against the reference, the same draws --------------------------

BITWISE = [
    # (graph, chains, temperatures, packed): W = 1, 1, 2, 4 word planes
    ("ea3d L=4", 4, 8, False),
    ("ea3d L=4", 4, 8, True),
    ("maxcut torus 6x8", 4, 10, True),
    ("maxcut torus 6x8", 2, 64, True),
    ("maxcut torus 6x8", 2, 64, False),
]


@pytest.mark.parametrize("name,chains,T,packed", BITWISE)
def test_apt_lfsr_bitwise_matches_jax(name, chains, T, packed, monkeypatch):
    betas = np.linspace(0.2, 3.0, T)
    je, te = build_pair(name, betas, chains=chains, rng="lfsr",
                        packed=packed)
    assert te.words == je.words
    ts = te.init_state(seed=2)
    d = state_to_numpy(ts)
    np.testing.assert_array_equal(d["lfsr"].reshape(-1),
                                  np.asarray(j_lfsr_init(te.L * te.n, 2)))
    js, (jt, jb) = run_ref(je, ref_state(d), monkeypatch, 12, 4, 4)
    ts, (tt, tb) = te.run(ts, 12, icm_every=4, record_every=4)
    got, want = state_to_numpy(ts), ref_fields(js)
    for f in ("m", "E", "lfsr", "sweep", "swaps", "icms"):
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tb, jb)
    assert int(want["swaps"]) > 0 and int(want["icms"]) > 0
    np.testing.assert_array_equal(te.spins(ts).numpy(),
                                  np.asarray(je.spins(js)))
    assert te.best_config(ts)[1] == je.best_config(js)[1]


@pytest.mark.parametrize("fmt", [None, "S46"])
def test_apt_philox_matches_jax_to_tanh_ties(fmt, monkeypatch):
    """f32 with the same uniforms: at most 1% of the spins differ; with
    none differing, energies, counters and trace are bitwise."""
    from repro.core import pbit as j_pbit
    from repro_torch.core import pbit as t_pbit
    betas = np.linspace(0.3, 3.0, 6)
    jg, tg = j_graph.ea3d(4, seed=5), t_graph.ea3d(4, seed=5, **CPU)
    je = JAPT(jg, j_lat_col(4), betas, chains=4,
              fmt=None if fmt is None else getattr(j_pbit, fmt))
    te = APTICM(tg, lattice3d_coloring(4), betas, chains=4,
                fmt=None if fmt is None else getattr(t_pbit, fmt),
                draws=HostDraws(DRAW_SEED), **CPU)
    ts = te.init_state(seed=4)
    js, (_, jb) = run_ref(je, ref_state(state_to_numpy(ts)), monkeypatch,
                          10, 5, 5)
    ts, (_, tb) = te.run(ts, 10, icm_every=5, record_every=5)
    got, want = state_to_numpy(ts), ref_fields(js)
    differ = got["m"] != want["m"]
    assert differ.mean() <= 0.01
    # the tracked energies are exact on +-J on both sides
    assert torch.equal(ts.E, energy(te.g, ts.m))
    if differ.any():
        return
    for f in ("E", "sweep", "swaps", "icms"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(tb, jb)


# -- the reference's APT tests (tests/test_problems.py) on the port ----------

def test_apt_icm_invariants():
    g, col = ea(5, 1)
    betas = adapt_ladder(g, col, 0.3, 3.0, 5, pilot_sweeps=50, **CPU)
    assert (np.diff(betas) > 0).all()
    apt = APTICM(g, col, betas, chains=2, **CPU)
    st = apt.init_state(seed=0)
    st2, (ts, best) = apt.run(st, 40, icm_every=5, record_every=10)
    # incremental energies stay exact through swaps + ICM
    assert float((energy(g, st2.m) - st2.E).abs().max()) == 0.0
    assert int(st2.swaps) > 0
    # ICM preserves the pair-sum exactly
    draw, _ = apt._drawer(st2.key)
    m, E, icms = apt._icm(st2.m.clone(), st2.E, st2.icms, draw)
    before = st2.E.numpy()[0] + st2.E.numpy()[1]
    after = E.numpy()[0] + E.numpy()[1]
    np.testing.assert_allclose(before, after, atol=1e-3)


def test_apt_packed_guards():
    g, col = ea(4, 0)
    betas = np.linspace(0.5, 3.0, 8)
    with pytest.raises(ValueError, match="rng='lfsr'"):
        APTICM(g, col, betas, chains=4, packed=True, **CPU)
    with pytest.raises(ValueError, match="bit lanes"):
        # chains * temperatures = 288 > 8 words * 32 lanes
        APTICM(g, col, np.linspace(0.5, 3.0, 36), chains=8, rng="lfsr",
               packed=True, **CPU)
    # word-straddling grids: 4 * 10 = 40 lanes -> W = 2
    assert APTICM(g, col, np.linspace(0.5, 3.0, 10), chains=4, rng="lfsr",
                  packed=True, **CPU).words == 2
    with pytest.raises(ValueError, match="unknown rng"):
        APTICM(g, col, betas, chains=4, rng="pcg", **CPU)
    with pytest.raises(ValueError, match="even"):
        APTICM(g, col, betas, chains=3, **CPU)


@pytest.mark.parametrize("T,betas_lo,betas_hi,seed,words", [
    (8, 0.5, 3.0, 0, 1), (10, 0.4, 2.8, 2, 2)])
def test_apt_packed_bitwise_matches_unpacked_lfsr(T, betas_lo, betas_hi,
                                                  seed, words):
    """Packed (4 chains x T temperatures, W word planes) is bitwise the
    unpacked fixed-point run with the port's own generator: spins,
    energies, trace, swap and ICM counters, LFSR states, generator
    state."""
    g, col = ea(4, 1)
    betas = np.linspace(betas_lo, betas_hi, T)
    un = APTICM(g, col, betas, chains=4, rng="lfsr", **CPU)
    pk = APTICM(g, col, betas, chains=4, rng="lfsr", packed=True, **CPU)
    assert pk.words == words
    su, sp = un.init_state(seed=seed), pk.init_state(seed=seed)
    assert torch.equal(un.spins(su), pk.spins(sp))
    su, (_, bu) = un.run(su, 12, icm_every=4, record_every=4)
    sp, (_, bp) = pk.run(sp, 12, icm_every=4, record_every=4)
    np.testing.assert_array_equal(bu, bp)
    assert torch.equal(un.spins(su), pk.spins(sp))
    assert torch.equal(su.E, sp.E)
    assert torch.equal(su.key, sp.key)
    assert torch.equal(su.lfsr.view(torch.int32).reshape(-1),
                       sp.lfsr.view(torch.int32).reshape(-1))
    assert int(su.swaps) == int(sp.swaps) > 0
    assert int(su.icms) == int(sp.icms) > 0
    cu, eu = un.best_config(su)
    cp, ep = pk.best_config(sp)
    assert eu == ep
    np.testing.assert_array_equal(cu, cp)


def test_apt_packed_t64_ladder_end_to_end():
    """A G81-class T=64 ladder (2 chains -> 128 lanes, W=4) runs packed
    end to end with exact incremental energies."""
    g, col = ea(4, 3)
    pk = APTICM(g, col, np.linspace(0.2, 3.0, 64), chains=2, rng="lfsr",
                packed=True, **CPU)
    assert pk.words == 4
    st = pk.init_state(seed=1)
    st, (ts, best) = pk.run(st, 8, icm_every=4, record_every=4)
    assert int(st.swaps) > 0
    assert float((energy(g, pk.spins(st)) - st.E).abs().max()) == 0.0


def test_apt_packed_incremental_energy_exact():
    g, col = ea(4, 2)
    pk = APTICM(g, col, np.linspace(0.4, 2.5, 8), chains=4, rng="lfsr",
                packed=True, **CPU)
    st = pk.init_state(seed=3)
    st, _ = pk.run(st, 10, icm_every=3, record_every=5)
    assert float((energy(g, pk.spins(st)) - st.E).abs().max()) == 0.0


@pytest.mark.parametrize("f_max", [6, 70])
def test_apt_accept_rows_narrow_and_wide_agree_with_gather(f_max):
    """The accept ``u >= thr[field + f_max]`` on rows narrower and wider
    than the reference's rank-count cap, against a numpy gather and the
    reference's ``_accept_rows`` (both of its branches)."""
    g, col = ea(4, 0)
    apt = APTICM(g, col, np.linspace(0.5, 2.0, 4), chains=2, rng="lfsr",
                 **CPU)
    ref = JAPT(j_graph.ea3d(4, seed=0), j_lat_col(4),
               np.linspace(0.5, 2.0, 4), chains=2, rng="lfsr")
    rng = np.random.default_rng(7)
    lw = 2 * f_max + 1
    assert (lw <= LUT_SELECT_MAX_WIDTH) == (f_max == 6)
    rows = np.sort(rng.integers(0, 1 << 24, size=(4, lw)),
                   axis=-1)[:, ::-1].astype(np.uint32)
    field = rng.integers(-f_max - 2, f_max + 3, size=(3, 4, 10))
    u = rng.integers(0, 1 << 24, size=(3, 4, 10)).astype(np.uint32)
    apt.f_max = ref.f_max = f_max
    got = apt._accept_rows(torch.from_numpy(rows.astype(np.int64))
                           [None, :, None, :], torch.from_numpy(field),
                           torch.from_numpy(u.astype(np.int64))).numpy()
    idx = np.clip(field + f_max, 0, lw - 1)
    want = u >= np.take_along_axis(
        np.broadcast_to(rows[None, :, None, :], (3, 4, 10, lw)),
        idx[..., None], axis=-1)[..., 0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(ref._accept_rows(
        jnp.asarray(rows[None, :, None, :]),
        jnp.asarray(field, jnp.int32), jnp.asarray(u))))


@pytest.mark.parametrize("packed", [False, True])
def test_apt_icm_move_invariants(packed):
    """The Houdayer flip (a) touches the same sites in both chains of a
    pair, (b) stays inside the pair's disagreement set, (c) keeps E1 + E2
    per (pair, temperature); the counter advances by the pairs with any
    disagreement."""
    g, col = ea(4, 3)
    kw = dict(rng="lfsr", packed=True) if packed else {}
    apt = APTICM(g, col, np.linspace(0.5, 3.0, 8), chains=4, **kw, **CPU)
    st = apt.init_state(seed=1)
    st, _ = apt.run(st, 6, icm_every=0, record_every=6)   # decorrelate
    m0 = apt.spins(st).numpy()
    E0 = st.E.numpy()
    draw, _ = apt._drawer(st.key)
    if packed:
        m, E, icms = apt._icm_packed(st.m, st.E, st.icms, draw)
    else:
        m, E, icms = apt._icm(st.m.clone(), st.E, st.icms, draw)
    m1 = apt.spins(dataclasses.replace(st, m=m)).numpy()
    flipped = m0 != m1
    disagree = m0[0::2] != m0[1::2]
    np.testing.assert_array_equal(flipped[0::2], flipped[1::2])
    assert not (flipped[0::2] & ~disagree).any()
    np.testing.assert_allclose(E.numpy()[0::2] + E.numpy()[1::2],
                               E0[0::2] + E0[1::2], atol=1e-3)
    assert int(icms) - int(st.icms) == int(disagree.any(axis=-1).sum())
    assert int(icms) > int(st.icms)
    assert apt.icm_calls == 1 and apt.icm_syncs >= 1


def test_apt_beats_plain_annealing_on_hard_instance():
    g, col = ea(5, 9)
    apt = APTICM(g, col, np.linspace(0.5, 4.0, 6), chains=2, **CPU)
    st = apt.init_state(seed=0)
    st, (ts, best) = apt.run(st, 150, icm_every=10, record_every=50)
    _, E_apt = apt.best_config(st)
    eng = GibbsEngine(g, col, **CPU)
    s2 = eng.init_state(seed=0)
    s2, (Etr, _) = eng.run_dense(s2, ea_schedule(150).beta_array())
    assert E_apt <= float(Etr.min()) + 4.0


# -- lane operations against the reference's ---------------------------------

@pytest.mark.parametrize("L", [7, 32, 40, 128])
def test_lane_permute_and_swap_match_jax(L):
    rng = np.random.default_rng(L)
    W = (L + 31) // 32
    words = rng.integers(0, 2 ** 32, size=(W, 5, 3), dtype=np.uint32)
    tw = u32_from_numpy(words, "cpu")
    perm = rng.permutation(L)
    np.testing.assert_array_equal(
        u32_to_numpy(t_packing.lane_permute(tw, torch.from_numpy(perm))),
        np.asarray(j_packing.lane_permute(jnp.asarray(words), perm)))
    for i, j in [(0, L - 1), (L // 2, L // 3), (1, 1)]:
        acc = rng.random((5, 3)) < 0.5
        for a in (None, acc):
            got = t_packing.lane_swap(
                tw, i, j, None if a is None else torch.from_numpy(a))
            want = j_packing.lane_swap(jnp.asarray(words), i, j,
                                       None if a is None else jnp.asarray(a))
            np.testing.assert_array_equal(u32_to_numpy(got),
                                          np.asarray(want))
    assert torch.equal(tw.view(torch.int32),
                       u32_from_numpy(words, "cpu").view(torch.int32))


@pytest.mark.parametrize("n", [1, 5, 32])
def test_lane_shifts_match_jax(n):
    got = t_packing.lane_shifts(n, 2)
    want = np.asarray(j_packing.lane_shifts(n, 2))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    with pytest.raises(ValueError):
        t_packing.lane_shifts(33, 1)


# -- the port's own generator -------------------------------------------------

@pytest.mark.parametrize("rng,packed", [("philox", False), ("lfsr", False),
                                        ("lfsr", True)])
def test_apt_snapshot_resume_is_exact(rng, packed):
    """6 + 6 sweeps through a host snapshot equal 12 in one run, generator
    state included; a different generator seed gives another run."""
    g, col = ea(4, 2)
    betas = np.linspace(0.3, 2.5, 8)
    apt = APTICM(g, col, betas, chains=4, rng=rng, packed=packed, **CPU)
    st0 = apt.init_state(seed=5)
    full, (_, b_full) = apt.run(st0, 12, icm_every=3, record_every=6)
    half, _ = apt.run(st0, 6, icm_every=3, record_every=6)
    snap = snapshot_state(half)
    assert snap.key.dtype == np.uint8
    resumed, (_, b_res) = apt.run(restore_state(snap, "cpu"), 6,
                                  icm_every=3, record_every=6)
    for f in dataclasses.fields(APTState):
        a, b = getattr(full, f.name), getattr(resumed, f.name)
        if a is None:
            assert b is None
            continue
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f.name
    assert b_res[-1] == b_full[-1]
    other = apt.init_state(seed=5)
    other = dataclasses.replace(other, key=apt.init_state(seed=6).key)
    other, _ = apt.run(other, 12, icm_every=3, record_every=6)
    assert not torch.equal(other.key, full.key)


# -- the state across the packages ---------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
def test_apt_state_crosses_both_ways(packed, monkeypatch):
    """Port -> numpy -> port is exact; the reference's state after a run
    of its own (its jax.random draws) becomes the port's with the port's
    key, and both then go on bitwise with the same draws."""
    betas = np.linspace(0.3, 2.5, 8)
    je, te = build_pair("ea3d L=4", betas, chains=4, rng="lfsr",
                        packed=packed)
    ts = te.init_state(seed=1)
    d = state_to_numpy(ts)
    back = state_from_numpy(**d, **CPU)
    for f in dataclasses.fields(APTState):
        a, b = getattr(ts, f.name), getattr(back, f.name)
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    # the reference runs 6 sweeps with its own key, from the port's start
    js = je.init_state(seed=0)
    js = dataclasses.replace(ref_state(d), key=js.key)
    js, _ = je.run(js, 6, icm_every=3, record_every=6)
    fields = ref_fields(js)
    with pytest.raises(ValueError, match="key"):
        state_from_numpy(**fields, key=np.asarray(js.key), **CPU)
    ts = state_from_numpy(**fields, key=d["key"], **CPU)
    assert torch.equal(te.spins(ts).to(torch.int8),
                       torch.from_numpy(np.array(je.spins(js))))
    assert torch.equal(energy(te.g, te.spins(ts)), ts.E)
    js, (_, jb) = run_ref(je, js, monkeypatch, 6, 3, 3)
    ts, (_, tb) = te.run(ts, 6, icm_every=3, record_every=3)
    got, want = state_to_numpy(ts), ref_fields(js)
    for f in ("m", "E", "lfsr", "sweep", "swaps", "icms"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("p_dis", [0.3, 0.6, 0.9])
def test_apt_cluster_equals_the_reference_growth(p_dis):
    """The port's labelling finds the cluster the reference grows shell by
    shell, on a graph with padded rows (zero couplings) and some zero
    edge weights, seeds inside and outside the disagreement set."""
    rng = np.random.default_rng(17)
    ei, ej = np.triu_indices(40, 1)
    keep = rng.random(len(ei)) < 0.08
    ew = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), size=keep.sum(),
                    p=[0.45, 0.1, 0.45])
    jg = j_graph.from_edges(40, ei[keep], ej[keep], ew)
    tg = t_graph.from_edges(40, ei[keep], ej[keep], ew, **CPU)
    col = j_greedy(np.asarray(jg.idx), np.asarray(jg.w))
    betas = np.linspace(0.5, 2.0, 6)
    je = JAPT(jg, col, betas, chains=4)
    te = APTICM(tg, Coloring(col.colors), betas, chains=4, **CPU)
    disagree = rng.random((2, 6, 40)) < p_dis
    seed = rng.integers(0, 40, size=(2, 6))
    got = te._grow_cluster(torch.from_numpy(seed), torch.from_numpy(disagree))
    one_hot = np.zeros_like(disagree)
    np.put_along_axis(one_hot, seed[..., None], True, axis=-1)
    want = np.asarray(je._grow_cluster(jnp.asarray(one_hot & disagree),
                                       jnp.asarray(disagree)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert te.icm_syncs >= 1
