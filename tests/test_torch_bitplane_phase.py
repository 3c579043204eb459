"""The fused bit-plane colour phase (``kernels/bitplane_phase.py``), the
redesign of B7 with the per-lane tail, on the CPU.

(a) Its plain versions (``ops.bitplane_phase_op`` and
``ops.bitplane_phase_apt_op`` on CPU tensors) equal the composition the
engines ran before it bitwise (the gather-count's plain version, then the
per-lane tail of ``DistDSIMEngine._phase_w`` and of the packed APT sweep,
kept below as they were): words, LFSR states, flips and APT energies, over
K x D x R with padded partitions, lost entries and slot 0 in and out of
the colour.  (b) A plain emulation of the CUDA kernel's dataflow (one
thread's work per colour entry, the threads in a random order on shared
arrays, the owner flag, words written where mask and not lost, flips
counted where mask, integer energy sums scaled once) equals (a)'s plain
version bitwise.  (c) No colour reads a slot of its own colour (the
kernel updates in place), on the L=100 brick partition and on a random
regular graph.  (d) One recorded chunk of ``make_engine("dsim_dist",
precision="bitplane")`` and of packed APT+ICM on the CPU through the new
ops, bitwise to the JAX reference on the same inputs (the padded K=4
bit-plane cases are in ``test_torch_dsim_dist.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.bits import (i64_to_i32, u32_from_numpy, u32_to_i64,
                                   u32_to_numpy)
from repro_torch.core.packing import LANE_WIDTH, lane_coords
from repro_torch.core.pbit import lfsr_next, lut_accept
from repro_torch.kernels import ops
from repro_torch.kernels.bitplane_phase import (LOST, MASK, OWNER,
                                                phase_sites)

ONES = np.uint32(0xFFFFFFFF)


# -- the composition the engines ran before the fused phase -------------------

def old_phase_w(mw, ghosts_w, s, slots, mask, lost, idx, signs, nz, base,
                thr, f_max, R):
    """DistDSIMEngine._phase_w as it was: (K, 1, nc)-shaped slots, mask,
    lost and base; returns the flips (R,)."""
    Kl, W = int(mw.shape[0]), int(mw.shape[1])
    nc = int(slots.shape[-1])
    wl, bl = lane_coords(R, 1, mw.device)
    bl = bl[None]
    mext = torch.cat([mw, ghosts_w], dim=2).view(torch.uint32)
    counts = ops.bitplane_gather_count_op(mext, idx, signs, nz)
    sidx = slots.expand(Kl, R, nc)
    sc = lfsr_next(torch.gather(s, 2, sidx))
    s.scatter_(2, sidx, sc)
    cnt = None
    for i, b in enumerate(counts):
        bit = ((b.view(torch.int32).index_select(1, wl) >> bl) & 1) << i
        cnt = bit if cnt is None else cnt + bit
    field = base - f_max + 2 * cnt
    accept = lut_accept(thr, field, f_max, sc >> 8)
    bits = accept.to(torch.int64) << bl
    if W * LANE_WIDTH > R:
        bits = torch.cat([bits, bits.new_zeros(
            (Kl, W * LANE_WIDTH - R, nc))], dim=1)
    upd = i64_to_i32(bits.reshape(Kl, W, LANE_WIDTH, nc).sum(2))
    widx = slots.expand(Kl, W, nc)
    old = torch.gather(mw, 2, widx)
    new = torch.where(mask, upd, old)
    flips = (((old ^ new).index_select(1, wl) >> bl) & 1).sum((0, 2))
    if lost is not None:
        new = torch.where(lost, old, new)
    mw.scatter_(2, widx, new)
    return flips


def old_apt_phase(mw, E, lfsr, nodes, idx32, signs, nz, base, thr_lanes,
                  f_max, scale):
    """One colour of APTICM._gibbs_sweep_packed as it was (thr_lanes
    (L, 1, lw)); returns (mw, E)."""
    L = int(lfsr.shape[0])
    wl, bl = lane_coords(L, 1, mw.device)
    counts = ops.bitplane_gather_count_op(mw[None], idx32, signs, nz)
    s = lfsr_next(lfsr.index_select(1, nodes))
    lfsr.index_copy_(1, nodes, s)
    cnt = torch.zeros(s.shape, dtype=torch.int64, device=s.device)
    for i, b in enumerate(counts):
        cnt += ((u32_to_i64(b[0])[wl] >> bl) & 1) << i
    field = base - f_max + 2 * cnt
    lw = int(thr_lanes.shape[-1])
    col = torch.clamp(field + f_max, 0, lw - 1)
    rows = thr_lanes.expand(*s.shape, lw)
    accept = (s >> 8) >= torch.gather(rows, -1, col[..., None].long())[..., 0]
    mwn = u32_to_i64(mw.index_select(1, nodes))
    old = torch.where(((mwn[wl] >> bl) & 1) != 0, 1, -1)
    new = torch.where(accept, 1, -1)
    E = E - ((new - old).to(torch.float32)
             * field.to(torch.float32)).sum(-1) * scale
    upd = torch.zeros_like(mwn).index_add_(0, wl, accept.long() << bl)
    mw = mw.view(torch.int32).index_copy(1, nodes, i64_to_i32(upd)).view(
        torch.uint32)
    return mw, E


# -- random operands of one colour ---------------------------------------------

def dist_case(K, D, R, slot0, seed):
    """One colour's operands on K partitions: n_max slots split into this
    colour's (even slots, plus slot 0 when ``slot0``) and the others (odd
    slots); partition k holds nc - k % 3 sites of the colour, so the
    narrower ones are padded with slot-0 entries; neighbours are slots of
    the other colour or ghosts, a fifth of them zero couplings pointing at
    slot 0 (as ``build_partitioned`` maps them)."""
    rng = np.random.default_rng(seed)
    W = -(-R // 32)
    n_max, g_max, nc = 40, 9, 12
    f_max = 3 + D
    own = np.arange(2 if not slot0 else 0, n_max, 2)
    others = np.arange(1, n_max, 2)
    slots = np.zeros((K, nc), np.int64)
    mask = np.zeros((K, nc), bool)
    for k in range(K):
        nk = nc - k % 3 if K > 1 else nc
        sel = np.sort(rng.choice(own, size=nk, replace=False))
        if slot0 and k % 2 == 0:
            sel = np.sort(np.concatenate([[0], sel[1:]]))
        slots[k, :nk] = sel
        mask[k, :nk] = True
    padded = ~mask.all(1, keepdims=True)
    lost = (slots == 0) & mask & padded
    pool = np.concatenate([others, n_max + np.arange(g_max)])
    idx = rng.choice(pool, size=(K, nc, D)).astype(np.int32)
    zero = rng.random((K, nc, D)) < 0.2
    idx[zero] = 0
    nz = np.where(zero, 0, ONES).astype(np.uint32)
    signs = np.where(rng.random((K, nc, D)) < 0.5, ONES, 0).astype(np.uint32)
    base = (rng.integers(-2, 3, (K, nc)) - (~zero).sum(-1) + f_max)
    lut = np.sort(rng.integers(0, 1 << 24, (3, 2 * f_max + 1)), axis=1)[
        :, ::-1].astype(np.int64)
    mw = rng.integers(0, 2 ** 32, (K, W, n_max), dtype=np.uint32)
    if R % 32:
        mw[:, -1] &= np.uint32((1 << (R % 32)) - 1)   # lanes >= R are 0
    ghosts = rng.integers(0, 2 ** 32, (K, W, g_max), dtype=np.uint32)
    s = rng.integers(1, 2 ** 32, (K, R, n_max)).astype(np.int64)
    return dict(mw=mw, ghosts=ghosts, s=s, slots=slots, mask=mask,
                lost=lost if lost.any() else None, idx=idx, signs=signs,
                nz=nz, base=base.astype(np.int64), lut=lut, f_max=f_max, R=R)


def as_tensors(c):
    i32 = lambda a: u32_from_numpy(a, "cpu").view(torch.int32)  # noqa: E731
    mw, gh = i32(c["mw"]), i32(c["ghosts"])
    s = torch.from_numpy(c["s"].copy())
    sites = phase_sites(torch.from_numpy(c["slots"]),
                        torch.from_numpy(c["mask"]),
                        None if c["lost"] is None else
                        torch.from_numpy(c["lost"]),
                        torch.from_numpy(c["idx"]),
                        u32_from_numpy(c["signs"], "cpu"),
                        u32_from_numpy(c["nz"], "cpu"),
                        torch.from_numpy(c["base"]))
    return mw, gh, s, sites, torch.from_numpy(c["lut"])


DIST_GRID = [(K, D, R, slot0) for K in (1, 8) for D in (3, 4, 6, 12)
             for R in (5, 40, 64) for slot0 in (False, True)
             if not (K == 1 and slot0)]


@pytest.mark.parametrize("K,D,R,slot0", DIST_GRID)
def test_plain_phase_equals_the_engines_composition(K, D, R, slot0):
    c = dist_case(K, D, R, slot0, seed=K * 1000 + D * 10 + R + slot0)
    if K == 8:
        assert c["lost"] is not None or not slot0
        assert (~c["mask"]).any()
    mw, gh, s, sites, lut = as_tensors(c)
    row, f_max = 1, c["f_max"]
    mw0, s0 = mw.clone(), s.clone()
    flips = torch.full((R,), 7, dtype=torch.int64)
    got = ops.bitplane_phase_op(mw, gh, s, sites, lut, row, f_max, flips)
    assert got is flips
    lane = lambda t: None if t is None else t[:, None]  # noqa: E731
    want = old_phase_w(mw0, gh, s0, lane(sites.slots), lane(sites.mask),
                       lane(sites.lost), sites.idx, sites.signs, sites.nz,
                       lane(sites.base), lut[row], f_max, R)
    assert torch.equal(mw, mw0) and torch.equal(s, s0)
    assert torch.equal(flips, want + 7)
    assert int(want.sum()) > 0


# -- (b) the kernel's dataflow, emulated -------------------------------------

def emulate_dist(c, row, seed, apt=None):
    """The CUDA kernel's work, one thread per colour entry (all its
    words), the threads in a random order on shared numpy arrays.
    ``apt`` = (E (L,) f32, scale f32, thr (L, lw)) switches to the packed
    APT entry point (K = 1, per-lane rows, energy sums)."""
    mw, gh = c["mw"].copy(), c["ghosts"]
    s = c["s"].copy()
    K, W, n_max = mw.shape
    R, f_max = c["R"], c["f_max"]
    nc, D = c["idx"].shape[1:]
    lw = 2 * f_max + 1
    if apt is None:
        flags = np.where(c["mask"], MASK, 0) | np.where(
            c["lost"] if c["lost"] is not None else False, LOST, 0)
        for k in range(K):
            first = np.unique(c["slots"][k], return_index=True)[1]
            flags[k, first] |= OWNER
        thr = np.broadcast_to(c["lut"][row], (R, lw))
    else:
        flags = np.full((K, nc), MASK | OWNER)
        thr = apt[2]
    flips = np.zeros(R, np.int64)
    esum = np.zeros(R, np.int64)
    order = np.random.default_rng(seed).permutation(K * nc)
    for t in order:
        k, i = divmod(int(t), nc)
        fl = int(flags[k, i])
        act, own, keep = fl & MASK, fl & OWNER, (fl & MASK) and not \
            (fl & LOST)
        slot = int(c["slots"][k, i])
        for w in range(W):
            live = min(32, R - 32 * w)
            lanes = 32 * w + np.arange(live)
            old = int(mw[k, w, slot]) if act else 0
            st = s[k, lanes, slot].copy() if own else None
            if own:
                st = st ^ ((st << 13) & 0xFFFFFFFF)
                st = st ^ (st >> 17)
                st = st ^ ((st << 5) & 0xFFFFFFFF)
                s[k, lanes, slot] = st
            if not act:
                continue
            cnt = np.zeros(live, np.int64)
            for d in range(D):
                q = int(c["idx"][k, i, d])
                word = int(mw[k, w, q]) if q < n_max else \
                    int(gh[k, w, q - n_max])
                plane = (word ^ int(c["signs"][k, i, d])) & int(
                    c["nz"][k, i, d])
                cnt += (plane >> np.arange(live)) & 1
            col = np.clip(c["base"][k, i] + 2 * cnt, 0, lw - 1)
            acc = (st >> 8) >= thr[lanes, col]
            new = int((acc.astype(np.int64) << np.arange(live)).sum())
            if keep:
                mw[k, w, slot] = new
            x = (old ^ new) & ((1 << live) - 1)
            bits = (x >> np.arange(live)) & 1
            flips[lanes] += bits
            field = c["base"][k, i] - f_max + 2 * cnt
            esum[lanes] += np.where(bits == 1, np.where(acc, 2, -2) * field,
                                    0)
    if apt is None:
        return mw, s, flips
    E, scale = apt[0], apt[1]
    return mw, s, (E - esum.astype(np.float32) * scale).astype(np.float32)


@pytest.mark.parametrize("K,D,R,slot0", [(8, 3, 40, True), (8, 6, 64, False),
                                         (8, 12, 5, True), (1, 4, 40, False)])
def test_kernel_dataflow_equals_the_plain_phase(K, D, R, slot0):
    c = dist_case(K, D, R, slot0, seed=7 + D)
    mw, gh, s, sites, lut = as_tensors(c)
    flips = torch.zeros(R, dtype=torch.int64)
    ops.bitplane_phase_op(mw, gh, s, sites, lut, 2, c["f_max"], flips)
    for seed in (0, 1):
        emw, es, ef = emulate_dist(c, 2, seed)
        np.testing.assert_array_equal(emw, u32_to_numpy(mw.view(
            torch.uint32)))
        np.testing.assert_array_equal(es, s.numpy())
        np.testing.assert_array_equal(ef, flips.numpy())


def apt_case(L, D, seed):
    """K=1 APT operands: N nodes, the colour's nc of them, neighbours among
    the rest; lane l's own LUT row; f32 energies and scale."""
    c = dist_case(1, D, L, False, seed)
    rng = np.random.default_rng(seed + 1)
    f_max = c["f_max"]
    c["thr"] = np.sort(rng.integers(0, 1 << 24, (L, 2 * f_max + 1)),
                       axis=1)[:, ::-1].astype(np.int64)
    # APT reads no ghosts: point those neighbours at the other slots
    n_max = c["mw"].shape[2]
    c["idx"] = np.where(c["idx"] >= n_max, 1, c["idx"]).astype(np.int32)
    c["E"] = rng.integers(-500, 500, L).astype(np.float32)
    c["scale"] = np.float32(0.37)
    return c


@pytest.mark.parametrize("L,D", [(5, 4), (40, 3), (128, 6)])
def test_apt_plain_phase_equals_composition_and_dataflow(L, D):
    c = apt_case(L, D, seed=L + D)
    mw = u32_from_numpy(c["mw"][0], "cpu")
    s = torch.from_numpy(c["s"][0].copy())
    nodes = torch.from_numpy(c["slots"][0])
    sites = phase_sites(nodes[None], torch.ones((1, nodes.numel()),
                                                dtype=torch.bool), None,
                        torch.from_numpy(c["idx"]),
                        u32_from_numpy(c["signs"], "cpu"),
                        u32_from_numpy(c["nz"], "cpu"),
                        torch.from_numpy(c["base"]))
    thr = torch.from_numpy(c["thr"])
    E = torch.from_numpy(c["E"].copy())
    mw0, s0 = mw.clone(), s.clone()
    got = ops.bitplane_phase_apt_op(mw, s, sites, thr, c["f_max"], E,
                                    float(c["scale"]))
    assert got is E
    want_mw, want_E = old_apt_phase(
        mw0, torch.from_numpy(c["E"].copy()), s0, nodes, sites.idx,
        sites.signs, sites.nz, sites.base[0], thr[:, None, :], c["f_max"],
        torch.tensor(c["scale"]))
    assert torch.equal(mw.view(torch.int32), want_mw.view(torch.int32))
    assert torch.equal(s, s0) and torch.equal(E, want_E)
    assert not torch.equal(E, torch.from_numpy(c["E"]))
    emw, es, eE = emulate_dist(c, 0, seed=3, apt=(c["E"], c["scale"],
                                                   c["thr"]))
    np.testing.assert_array_equal(emw[0], u32_to_numpy(mw))
    np.testing.assert_array_equal(es[0], s.numpy())
    np.testing.assert_array_equal(eE, E.numpy())


def test_phase_sites_flags_and_guards():
    c = dist_case(8, 4, 40, True, seed=1)
    _, _, _, sites, _ = as_tensors(c)
    fl = sites.flags.numpy()
    assert ((fl & MASK) != 0).tolist() == c["mask"].tolist()
    assert ((fl & LOST) != 0).tolist() == c["lost"].tolist()
    # every real entry owns its slot; one padding entry per padded row
    assert (((fl & OWNER) != 0) | ~c["mask"]).all()
    pad_owners = ((fl & OWNER) != 0) & ~c["mask"]
    slot0_real = ((c["slots"] == 0) & c["mask"]).any(1)
    assert pad_owners.sum(1).tolist() == [
        int(not c["mask"][k].all() and not slot0_real[k]) for k in range(8)]
    slots = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="shares its slot"):
        phase_sites(slots, torch.ones((1, 3), dtype=torch.bool), None,
                    sites.idx[:1, :3], sites.signs[:1, :3], sites.nz[:1, :3],
                    sites.base[:1, :3])
    with pytest.raises(ValueError, match="neighbours per site"):
        phase_sites(slots, torch.zeros((1, 3), dtype=torch.bool), None,
                    torch.zeros((1, 3, 32), dtype=torch.int32),
                    sites.signs[:1, :3], sites.nz[:1, :3], sites.base[:1, :3])


# -- (c) the in-place condition ---------------------------------------------

def assert_no_colour_reads_its_own(prob, colors):
    """For every colour: no nonzero-coupling neighbour of a real entry is
    a local slot of the same colour (zero couplings point at slot 0 and
    are masked by their nz plane; padding entries read nothing)."""
    idx = prob.local_idx.numpy()
    w = prob.local_w.numpy()
    gid = prob.global_ids.numpy()
    slot_col = np.where(gid < prob.n, colors[np.minimum(gid, prob.n - 1)],
                        -1)
    for c, (sl, ms) in enumerate(zip(prob.color_slots, prob.color_mask)):
        sl, ms = sl.numpy().astype(np.int64), ms.numpy()
        for k in range(prob.K):
            rows = idx[k, sl[k][ms[k]]]                       # (nk, D)
            live = (w[k, sl[k][ms[k]]] != 0) & (rows < prob.n_max)
            assert live.any()
            assert (slot_col[k, rows[live]] != c).all()


def test_no_colour_reads_its_own_slots():
    from repro_torch.core.coloring import greedy_coloring, lattice3d_coloring
    from repro_torch.core.dsim import build_partitioned
    from repro_torch.core.graph import ea3d, random_regular
    from repro_torch.core.partition import brick_partition, greedy_partition
    g = ea3d(100, seed=0, device="cpu")
    col = lattice3d_coloring(100)
    prob = build_partitioned(g, col, brick_partition((100,) * 3, (2, 2, 2)),
                             8)
    assert_no_colour_reads_its_own(prob, np.asarray(col.colors))
    g = random_regular(200, 5, seed=3, device="cpu")
    col = greedy_coloring(g.idx, g.w)
    prob = build_partitioned(g, col, greedy_partition(g.idx, g.w, 4, seed=0),
                             4)
    assert col.n_colors >= 3
    assert_no_colour_reads_its_own(prob, np.asarray(col.colors))


# -- (d) one recorded chunk through the new ops, against the reference --------

def count_calls(monkeypatch, module, name):
    calls = [0]
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


def test_dsim_dist_bitplane_chunk_through_the_op_matches_jax(monkeypatch):
    """As test_torch_dsim_dist.py's K=1 cases: the reference's K=1
    DistDSIMEngine from the port's initial state."""
    import jax.numpy as jnp
    from repro.compat import auto_axes, make_mesh as j_mesh
    from repro.core.annealing import ea_schedule as j_ea
    from repro.core.coloring import lattice3d_coloring as j_col
    from repro.core.dsim import DSIMState as JState
    from repro.core.dsim import build_partitioned as j_build
    from repro.core.dsim_dist import DistDSIMEngine as JDist
    from repro.core.graph import ea3d as j_ea3d
    from repro_torch import make_engine
    from repro_torch.core import dsim_dist
    from repro_torch.core.annealing import ea_schedule
    from repro_torch.core.coloring import lattice3d_coloring
    from repro_torch.core.dsim import build_partitioned
    from repro_torch.core.graph import ea3d
    from repro_torch.interop import state_to_numpy
    calls = count_calls(monkeypatch, dsim_dist, "bitplane_phase_op")
    g = ea3d(4, seed=7, device="cpu")
    prob = build_partitioned(g, lattice3d_coloring(4),
                             np.zeros(g.n, np.int32), 1)
    h = make_engine("dsim_dist", prob, rng="lfsr", precision="bitplane",
                    replicas=40, device="cpu")
    st0 = h.init_state(seed=5)
    st, rec = h.run_recorded(st0, ea_schedule(4), [4], sync_every=2)
    assert calls[0] == 4 * len(prob.color_slots)
    jg = j_ea3d(4, seed=7)
    je = JDist(j_build(jg, j_col(4), np.zeros(jg.n, np.int32), 1),
               j_mesh((1,), ("data",), axis_types=auto_axes(1)), rng="lfsr",
               precision="bitplane", replicas=40)
    js = je.shard_state(JState(**{k: jnp.asarray(v) for k, v in
                                  state_to_numpy(st0).items()}))
    js, jrec = je.run_recorded(js, j_ea(4), [4], sync_every=2)
    got = state_to_numpy(st)
    for f in ("m", "ghosts", "rng", "sweep", "flips"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(jrec.energies),
                                  rec.energies.numpy())
    assert jrec.flips == rec.flips > 0


def test_packed_apt_sweep_through_the_op_matches_jax(monkeypatch):
    """One packed sweep (every colour through ``ops.bitplane_phase_apt_op``;
    the sweep draws nothing) from the port's initial state against the
    reference's ``_gibbs_sweep_packed`` on the same state, W = 2 with a
    partial word."""
    import jax
    import jax.numpy as jnp
    from repro.core import graph as j_graph
    from repro.core.apt_icm import APTICM as JAPT
    from repro.core.coloring import greedy_coloring as j_greedy
    from repro_torch.core import apt_icm
    from repro_torch.core import graph as t_graph
    from repro_torch.core.coloring import Coloring
    jg = j_graph.toroidal_grid(6, 8, seed=81, weights="pm1")
    tg = t_graph.toroidal_grid(6, 8, seed=81, weights="pm1", device="cpu")
    col = j_greedy(np.asarray(jg.idx), np.asarray(jg.w))
    betas = np.linspace(0.2, 3.0, 20)
    je = JAPT(jg, col, betas, chains=2, rng="lfsr", packed=True)
    te = apt_icm.APTICM(tg, Coloring(col.colors), betas, chains=2,
                        rng="lfsr", packed=True, device="cpu")
    assert te.words == je.words == 2
    calls = count_calls(monkeypatch, apt_icm, "bitplane_phase_apt_op")
    st = te.init_state(seed=2)
    lfsr = u32_to_i64(st.lfsr)
    mw, E = te._gibbs_sweep_packed(st.m, st.E, lfsr)
    assert calls[0] == col.n_colors
    jm, jE, jl = jax.jit(je._gibbs_sweep_packed)(
        jnp.asarray(u32_to_numpy(st.m)), jnp.asarray(st.E.numpy()),
        jnp.asarray(u32_to_numpy(st.lfsr)))
    np.testing.assert_array_equal(u32_to_numpy(mw), np.asarray(jm))
    np.testing.assert_array_equal(E.numpy(), np.asarray(jE))
    np.testing.assert_array_equal(lfsr.numpy(), np.asarray(jl))
    assert not np.array_equal(E.numpy(), st.E.numpy())
