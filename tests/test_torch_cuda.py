"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a card (the
CUDA kernels have no CPU mode).  The file imports neither JAX nor the
reference package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The input builders below are numpy-only, made from a seed, and shared with
``test_torch_kernels.py``, which feeds the same inputs to the JAX kernels.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import coloring as t_coloring
from repro_torch.core import packing as t_pack
from repro_torch.core import pbit as t_pbit
from repro_torch.core.bits import u32_from_numpy, u32_to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.lattice_energy import (brick_energy,
                                                brick_energy_words)
from repro_torch.kernels import pbit_lattice
from repro_torch.kernels.pbit_bitplane import pbit_bitplane_sweep
from repro_torch.kernels.pbit_lattice import (pbit_brick_sweep,
                                              pbit_brick_sweep_int,
                                              pbit_brick_update,
                                              pbit_brick_update_int)
from repro_torch.kernels import ops
from test_torch_bitplane_phase import DIST_GRID, apt_case, as_tensors, \
    dist_case


def T(a):
    """numpy -> CPU tensor (uint32 kept)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return u32_from_numpy(a, "cpu")
    return torch.from_numpy(a.copy())


def N(x):
    if isinstance(x, torch.Tensor):
        return u32_to_numpy(x) if x.dtype == torch.uint32 else \
            x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bitwise(got, want):
    for g, w in zip(got, want):
        g, w = N(g), N(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w.astype(g.dtype))


def checkerboard(shape, n_colors=2):
    par = np.indices(shape).sum(0) % n_colors
    return np.stack([(par == c) for c in range(n_colors)]).astype(np.int8)


def int_inputs(seed, shape, R=None, multibit=False, n_betas=3):
    """Random brick for the int8 sweep: +-1 spins, LFSR states, int8
    couplings (+-1/0, or multi-bit), non-zero halos and the LUT."""
    rng = np.random.default_rng(seed)
    lead = () if R is None else (R,)
    Bx, By, Bz = shape
    m = rng.choice(np.array([-1, 1], np.int8), size=lead + shape)
    s = rng.integers(1, 2 ** 32, size=lead + shape, dtype=np.uint32)
    if multibit:
        h = rng.normal(0, 0.5, shape).astype(np.float32)
        w6 = [rng.normal(0, 1.0, shape).astype(np.float32) for _ in range(6)]
    else:
        h = rng.normal(0, 0.1, shape).astype(np.float32)
        w6 = [rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
              for _ in range(6)]
    h_q, w6_q, scale = t_pbit.quantize_couplings(h, w6)
    lut = t_pbit.threshold_lut(np.linspace(0.4, 4.0, n_betas), scale,
                               t_pbit.field_bound(h_q, w6_q))
    halos = tuple(rng.choice(np.array([-1, 1], np.int8), size=lead + sh)
                  for sh in [(By, Bz), (By, Bz), (Bx, Bz), (Bx, Bz),
                             (Bx, By), (Bx, By)])
    return dict(m=m, s=s, h_q=h_q, w6_q=w6_q, halos=halos, lut=lut,
                masks=checkerboard(shape), rng=rng)


def torch_int_args(d, rows):
    return (T(d["m"]), T(d["s"]), T(rows), T(d["masks"]), T(d["h_q"]),
            tuple(T(w) for w in d["w6_q"]), tuple(T(h) for h in d["halos"]),
            T(d["lut"]))


def f32_inputs(seed, shape, R=None, pm_j=True):
    """Random brick for the f32 kernels: +-1 spins, LFSR states, f32
    couplings (+-J with h in {-1, 0, 1}, or Gaussian), non-zero halos."""
    rng = np.random.default_rng(seed)
    lead = () if R is None else (R,)
    Bx, By, Bz = shape
    m = rng.choice(np.array([-1, 1], np.int8), size=lead + shape)
    s = rng.integers(1, 2 ** 32, size=lead + shape, dtype=np.uint32)
    if pm_j:
        h = rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
        w6 = [rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
              for _ in range(6)]
    else:
        h = rng.normal(0, 0.3, shape).astype(np.float32)
        w6 = [rng.normal(0, 1.0, shape).astype(np.float32) for _ in range(6)]
    halos = tuple(rng.choice(np.array([-1, 1], np.int8), size=lead + sh)
                  for sh in [(By, Bz), (By, Bz), (Bx, Bz), (Bx, Bz),
                             (Bx, By), (Bx, By)])
    return dict(m=m, s=s, h=h, w6=w6, halos=halos,
                masks=checkerboard(shape), rng=rng)


def torch_f32_args(d, betas):
    return (T(d["m"]), T(d["s"]), T(betas), T(d["masks"]), T(d["h"]),
            tuple(T(w) for w in d["w6"]), tuple(T(h) for h in d["halos"]))


def f32_boundary_sites(m, s, betas, masks, h, w6, halos, fmt=None,
                       ulps=8):
    """Sites that some phase of the plain f32 sweep decides within ``ulps``
    ulp of its boundary: the only sites where a tanh from another math
    library (within ``ulps`` ulp) may decide differently."""
    flagged = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
    for beta in torch.as_tensor(betas):
        for mask in masks:
            near = t_ref.decision_ulps_ref(m, s, beta, h, w6, halos,
                                           fmt) <= ulps
            flagged |= near & (mask != 0)
            m, s = t_ref.pbit_brick_update_ref(m, s, beta, mask, h, w6,
                                               halos, fmt)
    return flagged


def assert_f32_agrees(got, want, flagged):
    """LFSR states bitwise; spins equal except at ``flagged`` sites."""
    assert_bitwise(got[1:2], want[1:2])
    differ = N(got[0]) != N(want[0])
    assert not (differ & ~N(flagged)).any()
    if not differ.any() and len(got) > 2:
        assert_bitwise(got[2:], want[2:])


def lattice_masks(L, shape):
    """The repository's coloring of the L^3 lattice (3 colors at odd L)
    embedded in a brick ``shape`` >= (L, L, L): padding sites in no mask."""
    col = t_coloring.lattice3d_coloring(L)
    colors = col.colors.reshape(L, L, L)
    masks = np.zeros((col.n_colors,) + tuple(shape), np.int8)
    for c in range(col.n_colors):
        masks[c, :L, :L, :L] = colors == c
    return masks


def bitplane_inputs(seed, shape, R, n_betas=3, masks=None, fields=False,
                    betas=None):
    """One +-J-style brick in word layout (lane-masked color masks, random
    word halos) plus its int8 unpacked twin; ``masks`` (n_colors, *shape)
    int8 replaces the checkerboard; ``fields`` draws fields up to 120
    times the couplings (a LUT row of 267 entries); ``betas`` replaces the
    LUT's n_betas levels."""
    d = int_inputs(seed, shape, R=R, n_betas=n_betas)
    if masks is not None:
        d["masks"] = masks
    rng = d["rng"]
    h = rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
    if fields:
        h = rng.integers(-120, 121, size=shape).astype(np.float32)
    w6 = [rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
          for _ in range(6)]
    h_q, w6_q, scale = t_pbit.quantize_couplings(h, w6)
    signs6, nz6, base, f_max = t_pbit.bitplane_planes(h_q, w6_q)
    W = t_pack.lane_words(R)
    last = R - (W - 1) * 32
    lane_masks = np.full((W,), 0xFFFFFFFF, np.uint64)
    if last < 32:
        lane_masks[-1] = (1 << last) - 1
    masks_w = np.where(d["masks"][:, None] != 0,
                       lane_masks.astype(np.uint32)[None, :, None, None,
                                                    None], 0).astype(np.uint32)
    mw = N(t_pack.pack_lanes(T(d["m"])))
    halos_w = tuple(rng.integers(0, 2 ** 32, size=(W,) + hh.shape[1:],
                                 dtype=np.uint32) for hh in d["halos"])
    lut = t_pbit.threshold_lut(np.linspace(0.4, 4.0, n_betas)
                               if betas is None else betas, scale, f_max)
    return dict(mw=mw, s=d["s"], masks_w=masks_w, signs6=signs6, nz6=nz6,
                base=base, halos_w=halos_w, lut=lut, rng=rng, h_q=h_q,
                w6_q=w6_q, masks=d["masks"], W=W)


def bp_args(d, rows, conv):
    return (conv(d["mw"]), conv(d["s"]), conv(rows), conv(d["masks_w"]),
            tuple(conv(x) for x in d["signs6"]),
            tuple(conv(x) for x in d["nz6"]), conv(d["base"]),
            tuple(conv(x) for x in d["halos_w"]), conv(d["lut"]))


def energy_inputs(seed, shape, pm_j: bool, R=None):
    rng = np.random.default_rng(seed)
    lead = () if R is None else (R,)
    Bx, By, Bz = shape
    m = rng.choice(np.array([-1, 1], np.int8), size=lead + shape)
    if pm_j:
        h = rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
        w6 = [rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
              for _ in range(6)]
    else:
        h = rng.normal(0, 0.3, shape).astype(np.float32)
        w6 = [rng.normal(0, 1.0, shape).astype(np.float32) for _ in range(6)]
    active = (rng.random(shape) < 0.8).astype(np.int8)
    halos = tuple(rng.choice(np.array([-1, 1], np.int8), size=lead + sh)
                  for sh in [(By, Bz), (By, Bz), (Bx, Bz), (Bx, Bz),
                             (Bx, By), (Bx, By)])
    return m, active, h, w6, halos


# -- the energy kernel's dataflow, in plain PyTorch ---------------------------

ENERGY_RTOL = 1e-5


def assert_energy_close(got, want, args):
    """Energies summed in another order than the plain version's (Gaussian
    couplings): within ENERGY_RTOL of each replica's scale, the larger of
    |E| and the root sum of squares of its site terms (a replica whose
    terms cancel has an |E| far below the rounding its sum carries)."""
    sites = t_ref.brick_energy_sites_ref(*args).double()
    scale = torch.maximum(want.double().abs(),
                          sites.square().sum(dim=(-3, -2, -1)).sqrt())
    err = (got.double() - want.double()).abs()
    assert bool((err <= ENERGY_RTOL * scale).all()), \
        (N(err / scale).max(), N(got), N(want))

ENERGY_THREADS = 256      # threads per block of the energy kernels


def _warp_tree(v):
    """Lane 0's sum of a warp's 32 values (last axis) by the shuffle tree
    v[l] += v[l + o] for o = 16, 8, 4, 2, 1."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _block_sum(v):
    """A block's sum of its threads' values (last axis, 256): the warp
    trees, then the 8 warps in order from 0."""
    warps = _warp_tree(v.reshape(*v.shape[:-1], -1, 32))
    total = torch.zeros(warps.shape[:-1], dtype=torch.float32)
    for j in range(warps.shape[-1]):
        total = total + warps[..., j]
    return total


def energy_dataflow(m, active, h, w6, halos, kw):
    """The CUDA energy kernels' arithmetic and reduction order in plain
    PyTorch (CPU) on (R, X, Y, Z) spins: per site the Pallas kernel's
    order; per thread its kw consecutive z-sites summed in order from 0;
    blocks of 256 threads; per block the warp trees and the warps in order;
    per replica, thread t of the second pass sums block partials t, t+256,
    ... in order, then the same block sum.  Returns (R,) f32."""
    R = int(m.shape[0])
    f32 = torch.float32
    nb = t_ref._shifted(m, halos)
    pair = w6[0] * nb[0].to(f32)
    for d in range(1, 6):
        pair = pair + w6[d] * nb[d].to(f32)
    mc = m.to(f32)
    e = (-0.5 * (mc * pair) - h * mc) * active.to(f32)
    sites = e.reshape(R, -1, kw)
    thread = torch.zeros(sites.shape[:2], dtype=f32)
    for q in range(kw):
        thread = thread + sites[..., q]
    blocks = -(-thread.shape[1] // ENERGY_THREADS)
    pad = blocks * ENERGY_THREADS - thread.shape[1]
    thread = torch.cat([thread, torch.zeros(R, pad, dtype=f32)], 1)
    part = _block_sum(thread.reshape(R, blocks, ENERGY_THREADS))
    second = torch.zeros(R, ENERGY_THREADS, dtype=f32)
    for b0 in range(0, blocks, ENERGY_THREADS):
        chunk = part[:, b0:b0 + ENERGY_THREADS]
        second[:, :chunk.shape[1]] = second[:, :chunk.shape[1]] + chunk
    return _block_sum(second)


# -- on the card: each CUDA kernel against its plain version ---------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def to(dev, xs):
    if isinstance(xs, (tuple, list)):
        return type(xs)(to(dev, x) for x in xs)
    if xs.dtype == torch.uint32:
        return xs.view(torch.int32).to(dev).view(torch.uint32)
    return xs.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("per_replica,multibit", [
    (False, False), (True, False), (True, True)])
def test_cuda_int_sweep_matches_plain(cuda, per_replica, multibit):
    R, shape = 3, (12, 10, 7)
    d = int_inputs(11, shape, R=R, multibit=multibit)
    rows = d["rng"].integers(0, 3, size=(4, R)).astype(np.int32) \
        if per_replica else np.array([0, 2, 1, 2], np.int32)
    args = to(cuda, torch_int_args(d, rows))
    before = _build.launch_counts["pbit_brick_sweep_int"]
    got = pbit_brick_sweep_int(*args)
    assert _build.launch_counts["pbit_brick_sweep_int"] == before + 1
    assert_bitwise(got, t_ref.pbit_brick_sweep_int_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("R,case", [
    pytest.param(20, None, id="20"), pytest.param(32, None, id="32"),
    pytest.param(64, None, id="64"), pytest.param(1, None, id="R1"),
    pytest.param(31, None, id="R31"), pytest.param(96, None, id="R96"),
    pytest.param(256, None, id="R256"),
    pytest.param(64, "distinct_rows", id="distinct_rows"),
    pytest.param(33, "fields", id="fields_lut_global"),
    pytest.param(40, "small", id="brick_under_one_block"),
    pytest.param(64, "large_beta", id="thresholds_0_and_2_24"),
    pytest.param(64, "above_2_31", id="thresholds_above_2_31"),
    pytest.param(33, "fields_above_2_31", id="fields_thresholds_above_2_31"),
    pytest.param(64, "large", id="large_brick_R64"),
    pytest.param(33, "large", id="large_brick_R33"),
    pytest.param(40, "lane_masks", id="lane_subset_masks")])
def test_cuda_bitplane_sweep_matches_plain(cuda, R, case):
    """Per-lane rows, bitwise the plain version: R of one, a partial,
    three and eight word planes; every lane its own LUT row; fields wide
    enough that the LUT table passes the shared-memory budget (the global
    gather); a brick of 12 sites; a LUT row of thresholds 0 and 2^24
    (beta 10^4); LUT rows with thresholds above 2^31, which no draw
    meets, staged and gathered; a brick of 331,776 sites (649 blocks a
    phase);
    masks that hold a random subset of the lanes at each site (own mask
    words that differ between sites, and sites in no mask inside the
    brick).  Each launch is counted by where it reads the LUT, and by
    whether its grid splits the planes: every phase but the large
    brick's fills under one block an SM, so one of several planes
    splits."""
    shape = {"small": (3, 2, 2), "large": (72, 72, 64)}.get(case, (9, 6, 5))
    kw = {"distinct_rows": dict(n_betas=R), "fields": dict(fields=True),
          "fields_above_2_31": dict(fields=True),
          "large_beta": dict(betas=[0.0, 1e4, 3.0])}.get(case, {})
    d = bitplane_inputs(12, shape, R, **kw)
    n_rows = d["lut"].shape[0]
    if case == "distinct_rows":
        rows = np.stack([d["rng"].permutation(R) for _ in range(3)])
    else:
        rows = d["rng"].integers(0, n_rows, size=(3, R))
    if case == "large_beta":
        assert {0, 1 << 24} <= set(d["lut"][1].tolist())
    if case in ("above_2_31", "fields_above_2_31"):
        d["lut"][0] = 0xFFFFFFFF
        d["lut"][1, ::2] = 0x80000001
    if case == "lane_masks":
        d["masks_w"] &= d["rng"].integers(0, 2 ** 32, size=d["masks_w"].shape,
                                          dtype=np.uint32)
        d["masks_w"][..., 0, 0, :] = 0
    args = to(cuda, bp_args(d, rows.astype(np.int32), T))
    before = dict(_build.launch_counts)
    got = pbit_bitplane_sweep(*args)
    lut_in = ("lut_global" if case in ("fields", "fields_above_2_31")
              else "lut_shared")
    launched = {k: _build.launch_counts[f"pbit_bitplane_sweep{k}"] -
                before[f"pbit_bitplane_sweep{k}"]
                for k in ("", ":lut_shared", ":lut_global", ":plane_groups")}
    split = R > 32 and case != "large"
    assert launched == {"": 6, ":lut_shared": 6 * (lut_in == "lut_shared"),
                        ":lut_global": 6 * (lut_in == "lut_global"),
                        ":plane_groups": 6 * split}
    assert_bitwise(got, t_ref.pbit_bitplane_sweep_ref(*args))


@pytest.mark.cuda
def test_cuda_energy_matches_plain(cuda):
    m, active, h, w6, halos = energy_inputs(13, (10, 9, 8), True, R=3)
    args = to(cuda, (T(m), T(active), T(h), tuple(T(w) for w in w6),
                     tuple(T(x) for x in halos)))
    assert torch.equal(brick_energy(*args), t_ref.brick_energy_ref(*args))
    assert torch.equal(brick_energy(*args, bx=5), brick_energy(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("bx", [None, 2])
@pytest.mark.parametrize("per_replica", [False, True])
def test_cuda_int_update_matches_plain(cuda, per_replica, bx):
    R, shape = 3, (12, 10, 7)
    d = int_inputs(14, shape, R=R, multibit=per_replica)
    row = np.array([2, 0, 1], np.int32) if per_replica else 1
    m, s, _, masks, h_q, w6_q, halos, lut = to(
        cuda, torch_int_args(d, np.zeros(1, np.int32)))
    before = _build.launch_counts["pbit_brick_update_int"]
    got = pbit_brick_update_int(m, s, T(np.asarray(row)), masks[1], h_q,
                                w6_q, halos, lut, bx=bx)
    assert _build.launch_counts["pbit_brick_update_int"] == before + 1
    assert_bitwise(got, t_ref.pbit_brick_update_int_ref(
        m, s, row, masks[1], h_q, w6_q, halos, lut))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [None, t_pbit.S41])
@pytest.mark.parametrize("per_replica,pm_j", [
    (False, True), (True, True), (True, False)])
def test_cuda_f32_sweep_matches_plain(cuda, per_replica, pm_j, fmt):
    R, shape = 3, (12, 10, 7)
    d = f32_inputs(15, shape, R=R, pm_j=pm_j)
    betas = d["rng"].uniform(0.2, 3.0, size=(4, R)).astype(np.float32) \
        if per_replica else np.array([0.5, 1.5, 3.0, 0.9], np.float32)
    args = to(cuda, torch_f32_args(d, betas))
    before = _build.launch_counts["pbit_brick_sweep"]
    got = pbit_brick_sweep(*args, fmt=fmt)
    assert _build.launch_counts["pbit_brick_sweep"] == before + 1
    assert_f32_agrees(got, t_ref.pbit_brick_sweep_ref(*args, fmt=fmt),
                      f32_boundary_sites(*args, fmt=fmt))


@pytest.mark.cuda
@pytest.mark.parametrize("bx", [None, 2])
@pytest.mark.parametrize("fmt", [None, t_pbit.S41])
def test_cuda_f32_update_matches_plain(cuda, fmt, bx):
    R, shape = 3, (12, 10, 7)
    d = f32_inputs(16, shape, R=R, pm_j=False)
    m, s, _, masks, h, w6, halos = to(
        cuda, torch_f32_args(d, np.zeros(1, np.float32)))
    beta = torch.tensor([0.4, 1.1, 2.5], device=cuda)
    before = _build.launch_counts["pbit_brick_update"]
    got = pbit_brick_update(m, s, beta, masks[0], h, w6, halos, fmt=fmt,
                            bx=bx)
    assert _build.launch_counts["pbit_brick_update"] == before + 1
    assert_f32_agrees(got, t_ref.pbit_brick_update_ref(
        m, s, beta, masks[0], h, w6, halos, fmt),
        f32_boundary_sites(m, s, beta[None], masks[:1], h, w6, halos, fmt))


# -- the redesigned sweeps: color-major bit-plane, persistent f32 -----------

@pytest.mark.cuda
@pytest.mark.parametrize("L,pad,R", [
    (4, None, 33), (5, None, 64), (5, (6, 7), 33), (3, (4, 4), 64)])
def test_cuda_bitplane_color_major_matches_plain(cuda, L, pad, R):
    """Even and odd L (two and three colors), padding sites in no mask,
    R = 33 and 64 lanes, per-lane rows: bitwise the plain version, the
    LFSR columns permuted in and out once each; the color-major core on
    the gathered columns gives the gathered result and leaves its input
    as it was."""
    from repro_torch.kernels.pbit_bitplane import (color_layout,
                                                   pbit_bitplane_sweep_cm,
                                                   to_color_major)
    shape = (L, L, L) if pad is None else (pad[0], pad[1], L)
    d = bitplane_inputs(17, shape, R, masks=lattice_masks(L, shape))
    rows = d["rng"].integers(0, 3, size=(3, R)).astype(np.int32)
    args = to(cuda, bp_args(d, rows, T))
    before = dict(_build.launch_counts)
    got = pbit_bitplane_sweep(*args)
    n_colors = d["masks_w"].shape[0]
    assert _build.launch_counts["pbit_bitplane_sweep"] == \
        before["pbit_bitplane_sweep"] + 3 * n_colors
    assert _build.launch_counts["pbit_bitplane_sweep:lfsr_permute"] == \
        before["pbit_bitplane_sweep:lfsr_permute"] + 2
    assert_bitwise(got, t_ref.pbit_bitplane_sweep_ref(*args))
    assert int(N(got[2]).sum()) > 0
    order = color_layout(*args[3:7]).order
    s_cm = to_color_major(args[1], order)
    kept = s_cm.clone()
    before = dict(_build.launch_counts)
    cm = pbit_bitplane_sweep_cm(args[0], s_cm, *args[2:])
    assert _build.launch_counts["pbit_bitplane_sweep:lfsr_permute"] == \
        before["pbit_bitplane_sweep:lfsr_permute"]
    assert_bitwise((cm[0], cm[1], cm[2], s_cm),
                   (got[0], to_color_major(got[1], order), got[2], kept))


@pytest.mark.cuda
def test_cuda_bitplane_rejects_overlapping_masks(cuda):
    d = bitplane_inputs(18, (4, 4, 4), 32)
    d["masks_w"][1] |= d["masks_w"][0]
    rows = np.array([0, 1], np.int32)
    with pytest.raises(ValueError, match="two phases"):
        pbit_bitplane_sweep(*to(cuda, bp_args(d, rows, T)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lfsr_smem", "lfsr_global"])
@pytest.mark.parametrize("fmt", [None, t_pbit.S41])
@pytest.mark.parametrize("per_replica", [False, True])
def test_cuda_f32_persistent_modes_match_plain(cuda, monkeypatch, mode, fmt,
                                               per_replica):
    """Both LFSR modes (device memory forced by a zero shared-memory
    budget), odd L (three colors, padding), fmt None and s{4}{1}, shared
    and per-replica betas."""
    if mode == "lfsr_global":
        sms = pbit_lattice.device_limits(cuda.index)[0]
        monkeypatch.setattr(pbit_lattice, "device_limits",
                            lambda index: (sms, 0))
    R, L, shape = 3, 5, (6, 5, 5)
    d = f32_inputs(19, shape, R=R, pm_j=False)
    d["masks"] = lattice_masks(L, shape)
    betas = d["rng"].uniform(0.2, 3.0, size=(4, R)).astype(np.float32) \
        if per_replica else np.array([0.5, 1.5, 3.0, 0.9], np.float32)
    args = to(cuda, torch_f32_args(d, betas))
    assert pbit_lattice.persistent_mode(args[0]) == mode
    before = _build.launch_counts[f"pbit_brick_sweep:{mode}"]
    got = pbit_brick_sweep(*args, fmt=fmt)
    assert _build.launch_counts[f"pbit_brick_sweep:{mode}"] == before + 1
    assert_f32_agrees(got, t_ref.pbit_brick_sweep_ref(*args, fmt=fmt),
                      f32_boundary_sites(*args, fmt=fmt))


@pytest.mark.cuda
def test_cuda_f32_persistent_zero_sweeps(cuda):
    d = f32_inputs(20, (6, 5, 4), R=2)
    args = to(cuda, torch_f32_args(d, np.zeros(0, np.float32)))
    before = _build.launch_counts["pbit_brick_sweep"]
    got = pbit_brick_sweep(*args)
    assert _build.launch_counts["pbit_brick_sweep"] == before
    assert_bitwise(got, t_ref.pbit_brick_sweep_ref(*args))


@pytest.mark.cuda
def test_cuda_f32_persistent_grid_too_large_raises(cuda):
    """A grid the card cannot co-schedule is refused at launch, and the
    wrapper raises with the launch's error."""
    d = f32_inputs(21, (6, 5, 4), R=2)
    args = to(cuda, torch_f32_args(d, np.array([1.0], np.float32)))
    sms = pbit_lattice.device_limits(cuda.index)[0]
    with pytest.raises(RuntimeError, match="pbit_sweep_f32_persistent"):
        pbit_lattice._f32_persistent(*args, None, grid=64 * sms)
    # the card is still usable afterwards
    assert_f32_agrees(pbit_brick_sweep(*args),
                      t_ref.pbit_brick_sweep_ref(*args),
                      f32_boundary_sites(*args))


# -- the redesigned int8 sweep (persistent) and f32 phase (site words) ------

def force_lfsr_mode(monkeypatch, dev, mode):
    """Force a persistent sweep's LFSR mode: device memory by a zero
    shared-memory budget for the states (the launch shape still comes from
    the card)."""
    if mode == "lfsr_global":
        sms = pbit_lattice.device_limits(dev.index)[0]
        monkeypatch.setattr(pbit_lattice, "device_limits",
                            lambda index: (sms, 0))


def overlapping_masks(rng, shape, n_colors=3):
    """Random masks that are no coloring: sites in two or more phases'
    masks, sites in none, neighbors in one."""
    masks = (rng.random((n_colors,) + shape) < 0.45).astype(np.int8)
    assert (masks.sum(0) > 1).any() and (masks.sum(0) == 0).any()
    return masks


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lfsr_smem", "lfsr_global"])
@pytest.mark.parametrize("per_replica,multibit", [
    (False, False), (True, True)])
def test_cuda_int_persistent_modes_match_plain(cuda, monkeypatch, mode,
                                               per_replica, multibit):
    """Both LFSR modes, odd L (three colors, padding), shared and
    per-replica rows, +-1 and multi-bit couplings: bitwise the plain
    version."""
    force_lfsr_mode(monkeypatch, cuda, mode)
    R, L, shape = 3, 5, (6, 5, 5)
    d = int_inputs(31, shape, R=R, multibit=multibit)
    d["masks"] = lattice_masks(L, shape)
    rows = d["rng"].integers(0, 3, size=(4, R)).astype(np.int32) \
        if per_replica else np.array([0, 2, 1, 2], np.int32)
    args = to(cuda, torch_int_args(d, rows))
    assert pbit_lattice.persistent_mode(args[0]) == mode
    before = _build.launch_counts[f"pbit_brick_sweep_int:{mode}"]
    got = pbit_lattice.pbit_brick_sweep_int(*args)
    assert _build.launch_counts[f"pbit_brick_sweep_int:{mode}"] == before + 1
    assert_bitwise(got, t_ref.pbit_brick_sweep_int_ref(*args))
    assert int(N(got[2]).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lfsr_smem", "lfsr_global"])
@pytest.mark.parametrize("R", [1, 33])
def test_cuda_int_persistent_overlapping_masks(cuda, monkeypatch, mode, R):
    """Masks that are no coloring (the int8 sweep takes any, as the
    reference does), R = 1 and 33, one brick and a batch."""
    force_lfsr_mode(monkeypatch, cuda, mode)
    shape = (7, 6, 9)
    d = int_inputs(32, shape, R=R, multibit=True)
    d["masks"] = overlapping_masks(d["rng"], shape)
    rows = d["rng"].integers(0, 3, size=(3, R)).astype(np.int32)
    args = to(cuda, torch_int_args(d, rows))
    assert_bitwise(pbit_brick_sweep_int(*args),
                   t_ref.pbit_brick_sweep_int_ref(*args))
    one = to(cuda, (T(d["m"][0]), T(d["s"][0]), T(rows[:, 0]),
                    T(d["masks"]), T(d["h_q"]),
                    tuple(T(w) for w in d["w6_q"]),
                    tuple(T(h[0]) for h in d["halos"]), T(d["lut"])))
    assert_bitwise(pbit_brick_sweep_int(*one),
                   t_ref.pbit_brick_sweep_int_ref(*one))


@pytest.mark.cuda
def test_cuda_int_persistent_zero_sweeps(cuda):
    d = int_inputs(33, (6, 5, 4), R=2)
    args = to(cuda, torch_int_args(d, np.zeros(0, np.int32)))
    before = _build.launch_counts["pbit_brick_sweep_int"]
    got = pbit_brick_sweep_int(*args)
    assert _build.launch_counts["pbit_brick_sweep_int"] == before
    assert_bitwise(got, t_ref.pbit_brick_sweep_int_ref(*args))


@pytest.mark.cuda
def test_cuda_int_persistent_grid_too_large_raises(cuda):
    """A grid the card cannot co-schedule is refused at launch, and the
    wrapper raises with the launch's error; the card stays usable."""
    d = int_inputs(34, (6, 5, 4), R=2)
    args = to(cuda, torch_int_args(d, np.array([1], np.int32)))
    sms = pbit_lattice.device_limits(cuda.index)[0]
    with pytest.raises(RuntimeError, match="pbit_sweep_int_persistent"):
        pbit_lattice._int_persistent(*args, grid=64 * sms)
    assert_bitwise(pbit_brick_sweep_int(*args),
                   t_ref.pbit_brick_sweep_int_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("bx", [None, 2])
@pytest.mark.parametrize("per_replica", [False, True])
@pytest.mark.parametrize("fmt", [None, t_pbit.S41])
@pytest.mark.parametrize("shape,width", [
    ((6, 5, 8), "word"), ((6, 5, 7), "site"), ((4, 3, 4), "word")])
def test_cuda_f32_phase_words_match_plain(cuda, shape, width, fmt,
                                          per_replica, bx):
    """One thread per word of 4 z-sites (Z a multiple of 4) or per site:
    no site decided differently from the plain version, LFSR states
    bitwise, and the in-kernel flip count equal to the changed sites."""
    R = 3
    d = f32_inputs(35, shape, R=R, pm_j=False)
    m, s, _, masks, h, w6, halos = to(
        cuda, torch_f32_args(d, np.zeros(1, np.float32)))
    beta = torch.tensor([0.4, 1.1, 2.5], device=cuda) if per_replica \
        else 1.3
    want = t_ref.pbit_brick_update_ref(m, s, beta, masks[1], h, w6, halos,
                                       fmt)
    before = _build.launch_counts[f"pbit_brick_update:{width}"]
    got = pbit_brick_update(m, s, beta, masks[1], h, w6, halos, fmt=fmt,
                            bx=bx)
    assert _build.launch_counts[f"pbit_brick_update:{width}"] == before + 1
    assert_bitwise(got, want)
    flips = torch.full((R,), 5, dtype=torch.int32, device=cuda)
    got = pbit_lattice.launch_update(m, s, beta, masks[1], h, w6, halos, fmt,
                                     flips)
    assert_bitwise(got, want)
    assert N(flips).tolist() == \
        (5 + (N(want[0]) != N(m)).reshape(R, -1).sum(1)).tolist()


@pytest.mark.cuda
def test_cuda_f32_phase_unaligned_takes_site_path(cuda):
    """Constants that are not 16-byte aligned send a Z % 4 == 0 brick down
    the per-site path, with the same result."""
    shape, R = (5, 4, 8), 2
    d = f32_inputs(36, shape, R=R, pm_j=False)
    m, s, _, masks, h, w6, halos = to(
        cuda, torch_f32_args(d, np.zeros(1, np.float32)))
    n = int(np.prod(shape))
    h_off = torch.empty(n + 1, device=cuda)[1:].view(shape)
    h_off.copy_(h)
    before = _build.launch_counts["pbit_brick_update:site"]
    got = pbit_brick_update(m, s, 0.9, masks[0], h_off, w6, halos)
    assert _build.launch_counts["pbit_brick_update:site"] == before + 1
    assert_bitwise(got, t_ref.pbit_brick_update_ref(m, s, 0.9, masks[0], h,
                                                    w6, halos))


@pytest.mark.cuda
def test_cuda_int_phase_counts_flips(cuda):
    R, shape = 3, (12, 10, 7)
    d = int_inputs(37, shape, R=R, multibit=True)
    m, s, _, masks, h_q, w6_q, halos, lut = to(
        cuda, torch_int_args(d, np.zeros(1, np.int32)))
    row = torch.tensor([2, 0, 1], dtype=torch.int32, device=cuda)
    flips = torch.zeros(R, dtype=torch.int32, device=cuda)
    got = pbit_lattice.launch_update_int(m, s, row, masks[0], h_q, w6_q,
                                         halos, lut, flips)
    want = t_ref.pbit_brick_update_int_ref(m, s, row, masks[0], h_q, w6_q,
                                           halos, lut)
    assert_bitwise(got, want)
    assert N(flips).tolist() == \
        (N(want[0]) != N(m)).reshape(R, -1).sum(1).tolist()


# -- the redesigned int8 phase (site words) and energy (fixed order) --------

@pytest.mark.cuda
@pytest.mark.parametrize("bx", [None, 2])
@pytest.mark.parametrize("per_replica,multibit", [
    (False, False), (True, True)])
@pytest.mark.parametrize("shape,width", [
    ((6, 5, 8), "word"), ((6, 5, 7), "site"), ((4, 3, 4), "word")])
def test_cuda_int_phase_words_match_plain(cuda, shape, width, per_replica,
                                          multibit, bx):
    """One thread per word of 4 z-sites (Z a multiple of 4) or per site:
    bitwise the plain version, and the in-kernel flip count equal to the
    changed sites."""
    R = 3
    d = int_inputs(38, shape, R=R, multibit=multibit)
    m, s, _, masks, h_q, w6_q, halos, lut = to(
        cuda, torch_int_args(d, np.zeros(1, np.int32)))
    row = torch.tensor([2, 0, 1], dtype=torch.int32, device=cuda) \
        if per_replica else 1
    want = t_ref.pbit_brick_update_int_ref(m, s, row, masks[1], h_q, w6_q,
                                           halos, lut)
    before = _build.launch_counts[f"pbit_brick_update_int:{width}"]
    got = pbit_brick_update_int(m, s, row, masks[1], h_q, w6_q, halos, lut,
                                bx=bx)
    assert _build.launch_counts[f"pbit_brick_update_int:{width}"] == \
        before + 1
    assert_bitwise(got, want)
    flips = torch.full((R,), 5, dtype=torch.int32, device=cuda)
    got = pbit_lattice.launch_update_int(m, s, row, masks[1], h_q, w6_q,
                                         halos, lut, flips)
    assert_bitwise(got, want)
    assert N(flips).tolist() == \
        (5 + (N(want[0]) != N(m)).reshape(R, -1).sum(1)).tolist()


@pytest.mark.cuda
def test_cuda_int_phase_unaligned_takes_site_path(cuda):
    """int8 constants that are not 4-byte aligned send a Z % 4 == 0 brick
    down the per-site path, with the same result."""
    shape, R = (5, 4, 8), 2
    d = int_inputs(39, shape, R=R, multibit=True)
    m, s, _, masks, h_q, w6_q, halos, lut = to(
        cuda, torch_int_args(d, np.zeros(1, np.int32)))
    n = int(np.prod(shape))
    h_off = torch.empty(n + 1, dtype=torch.int8, device=cuda)[1:].view(shape)
    h_off.copy_(h_q)
    before = _build.launch_counts["pbit_brick_update_int:site"]
    got = pbit_brick_update_int(m, s, 2, masks[0], h_off, w6_q, halos, lut)
    assert _build.launch_counts["pbit_brick_update_int:site"] == before + 1
    assert_bitwise(got, t_ref.pbit_brick_update_int_ref(
        m, s, 2, masks[0], h_q, w6_q, halos, lut))


def energy_args(dev, seed, shape, pm_j, R):
    m, active, h, w6, halos = energy_inputs(seed, shape, pm_j, R=R)
    return to(dev, (T(m), T(active), T(h), tuple(T(w) for w in w6),
                    tuple(T(x) for x in halos)))


@pytest.mark.cuda
@pytest.mark.parametrize("pm_j", [True, False])
@pytest.mark.parametrize("shape,width,R", [
    ((10, 9, 8), "word", 3), ((10, 9, 7), "site", 3),
    ((12, 11, 8), "word", 64)])
def test_cuda_energy_fixed_order(cuda, shape, width, R, pm_j):
    """The kernel's bits are the plain emulation of its reduction tree,
    equal on repeated calls; against the plain version exact on +-J and
    within ENERGY_RTOL of the energy's scale on Gaussian couplings."""
    args = energy_args(cuda, 40, shape, pm_j, R)
    before = _build.launch_counts[f"brick_energy:{width}"]
    got = brick_energy(*args)
    assert _build.launch_counts[f"brick_energy:{width}"] == before + 1
    kw = 4 if width == "word" else 1
    assert_bitwise([got], [energy_dataflow(*to("cpu", args), kw)])
    assert torch.equal(brick_energy(*args), got)
    want = t_ref.brick_energy_ref(*args)
    if pm_j:
        assert torch.equal(got, want)
    else:
        assert_energy_close(got, want, args)


@pytest.mark.cuda
@pytest.mark.parametrize("pm_j", [True, False])
@pytest.mark.parametrize("shape,R", [
    ((9, 6, 8), 20), ((9, 6, 8), 64), ((7, 5, 5), 33)])
def test_cuda_energy_words_match_int8_route(cuda, shape, R, pm_j):
    """The word-plane readout equals the int8 kernel on the unpacked
    spins and word halos bitwise (any couplings), and its plain version
    exactly on +-J."""
    m, active, h, w6, _ = energy_args(cuda, 41, shape, pm_j, R)
    rng = np.random.default_rng(42)
    W = t_pack.lane_words(R)
    mw = t_pack.pack_lanes(m)
    halos_w = tuple(to(cuda, T(rng.integers(0, 2 ** 32, size=sh,
                                            dtype=np.uint32)))
                    for sh in pbit_lattice.halo_shapes(W, *shape))
    before = _build.launch_counts["brick_energy:bitplane"]
    got = brick_energy_words(mw, R, active, h, w6, halos_w)
    assert _build.launch_counts["brick_energy:bitplane"] == before + 1
    halos = tuple(t_pack.unpack_lanes(x, R) for x in halos_w)
    assert torch.equal(got, brick_energy(m, active, h, w6, halos))
    assert torch.equal(brick_energy_words(mw, R, active, h, w6, halos_w),
                       got)
    want = t_ref.brick_energy_words_ref(mw, R, active, h, w6, halos_w)
    if pm_j:
        assert torch.equal(got, want)
    else:
        assert_energy_close(got, want, (m, active, h, w6, halos))


def f32_mesh_steps(h, st, betas, S):
    """The S-sweep iterations of a fused f32 mesh engine from ``st``, one
    at a time: each brick's sweep against its halos agrees with the plain
    sweep (LFSR states bitwise, spins except at sites within 8 ulp of the
    decision boundary), and the engine's iteration is those brick sweeps
    followed by its exchange, bitwise.  Returns the state after them."""
    eng = h.eng
    for it in range(len(betas) // S):
        b_it = np.ascontiguousarray(betas[it * S:(it + 1) * S], np.float32)
        nxt = eng._chunk(st, b_it[None], 1, S, None)
        for k, (b, hk) in enumerate(zip(eng._bricks,
                                        eng._brick_halos(st.halos))):
            args = (st.m[k], st.s[k], torch.from_numpy(b_it).to(eng.device),
                    b.masks, b.h, b.w6, hk)
            got = pbit_brick_sweep(*args, fmt=eng.fmt)
            assert_f32_agrees(got, t_ref.pbit_brick_sweep_ref(
                *args, fmt=eng.fmt), f32_boundary_sites(*args, fmt=eng.fmt))
            assert_bitwise((nxt.m[k], nxt.s[k]), got[:2])
        assert_bitwise(eng._exchange(nxt.m), nxt.halos)
        st = nxt
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("prec,R,shape,fused", [
    ("int8", 3, (2, 2, 2), True), ("int8", 2, (2, 1, 2), False),
    ("bitplane", 40, (2, 2, 2), True), ("bitplane", 5, (1, 2, 1), True),
    ("f32", 3, (2, 2, 2), True), ("f32", 2, (1, 2, 2), True)])
def test_cuda_mesh_equals_plain(cuda, monkeypatch, prec, R, shape, fused):
    """A small mesh through the CUDA kernels, brick by brick, equals the
    same mesh on the plain versions bitwise (states, halos, energies,
    flips); the bit-plane bricks' color-major layouts are built once.  On
    f32 (L=10: bricks of Z=5, the site path, as L=100 on (2,2,2)) the
    card's tanhf is not the CPU's: LFSR states bitwise, and every brick's
    sweep held to the plain one with real halos by ``f32_mesh_steps``."""
    from repro_torch import make_engine
    from repro_torch.core.annealing import ea_schedule
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import pbit_bitplane
    builds = []
    real = pbit_bitplane._build_layout
    monkeypatch.setattr(pbit_bitplane, "_build_layout",
                        lambda *a: builds.append(1) or real(*a))
    L = 10 if prec == "f32" else 8
    runs, engines = {}, {}
    for impl in ("ref", "auto"):
        h = make_engine("lattice", L=L, seed=1, replicas=R, precision=prec,
                        fused=fused, impl=impl,
                        mesh=make_mesh(shape, ("x", "y", "z")),
                        dim_axes=("x", "y", "z"), device=cuda)
        engines[impl] = h.eng
        st0 = h.init_state(seed=2)
        _build.reset_launch_counts()
        runs[impl] = h.run_recorded(st0, ea_schedule(12), [4, 12],
                                    sync_every=4)
        if impl == "auto":
            K = int(np.prod(shape))
            sweep = {"int8": "pbit_brick_sweep_int" if fused
                     else "pbit_brick_update_int",
                     "bitplane": "pbit_bitplane_sweep",
                     "f32": "pbit_brick_sweep"}[prec]
            assert _build.launch_counts[sweep] > 0
            assert _build.launch_counts["brick_energy"] == 2 * K
            assert len(builds) == (K if prec == "bitplane" else 0)
    (sa, ra), (sb, rb) = runs["ref"], runs["auto"]
    if prec == "bitplane":
        # the card's engine holds its LFSR columns in each brick's
        # color-major order: both states in the reference's shapes
        sa, sb = (engines[i].global_state(x)
                  for i, x in (("ref", sa), ("auto", sb)))
    if prec == "f32":
        st = f32_mesh_steps(h, st0, ea_schedule(12).beta_array(), 4)
        for x, y in zip((st.m, st.s, st.flips) + st.halos,
                        (sb.m, sb.s, sb.flips) + sb.halos):
            assert_bitwise((x,), (y,))
        assert_bitwise((sa.s,), (sb.s,))
    if prec != "f32" or torch.equal(sa.m, sb.m):
        assert torch.equal(ra.energies, rb.energies) and \
            ra.flips == rb.flips
        for x, y in zip((sa.m, sa.s, sa.flips) + sa.halos,
                        (sb.m, sb.s, sb.flips) + sb.halos):
            assert_bitwise((x,), (y,))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [None, (2, 1, 1)])
@pytest.mark.parametrize("R", [64, 40])
def test_cuda_bitplane_engine_holds_color_major_columns(cuda, R, mesh):
    """The bit-plane lattice engine on the CUDA kernels holds each brick's
    LFSR columns as (R, n) in its color-major order and permutes none of
    them while it runs chunks; over 64 sweeps (``sync_every=8``, several
    chunks, three record points) it equals impl="ref" on the same card
    bitwise through global_state
    (words, columns, halos, flips, sweep, record-point energies), on one
    brick and on a (2,1,1) mesh in one process; a state passed into
    ``_chunk`` is unchanged by it."""
    from repro_torch import make_engine
    from repro_torch.core.annealing import (ea_schedule, beta_row_indices,
                                            beta_table)
    from repro_torch.core.mesh import make_mesh
    key = "pbit_bitplane_sweep:lfsr_permute"
    kw = dict(L=8, seed=1, replicas=R, precision="bitplane", device=cuda)
    if mesh is not None:
        kw.update(mesh=make_mesh(mesh, ("x", "y", "z")),
                  dim_axes=("x", "y", "z"))
    got = {}
    for impl in ("ref", "auto"):
        h = make_engine("lattice", impl=impl, **kw)
        st = h.init_state(seed=2)
        before = _build.launch_counts[key]
        st, rec = h.run_recorded(st, ea_schedule(64), [16, 48, 64],
                                 sync_every=8)
        assert _build.launch_counts[key] == before
        assert h.eng.color_major == (impl == "auto")
        got[impl] = (h.eng.global_state(st), rec)
    K = 1 if mesh is None else int(np.prod(mesh))
    assert tuple(st.s.shape) == ((R, 8 ** 3) if mesh is None
                                 else (K, R, 8 ** 3 // K))
    (sa, ra), (sb, rb) = got["ref"], got["auto"]
    for x, y in zip((sa.m, sa.s, sa.flips, sa.sweep) + sa.halos,
                    (sb.m, sb.s, sb.flips, sb.sweep) + sb.halos):
        assert_bitwise((y,), (x,))
    assert torch.equal(ra.energies, rb.energies) and ra.flips == rb.flips
    # one chunk from a live state: its input is left as it was
    eng = h.eng
    betas = np.full(16, 3.0, np.float32)
    table = beta_table(betas)
    rows = beta_row_indices(betas, table).reshape(2, 8)
    kept = [x.clone() for x in (st.m, st.s, st.flips) + st.halos]
    before = _build.launch_counts[key]
    nxt = eng._chunk(st, rows, 2, 8, eng._lut_for(table))
    assert _build.launch_counts[key] == before
    assert_bitwise((st.m, st.s, st.flips) + st.halos, kept)
    assert not torch.equal(nxt.s.view(torch.int32), st.s.view(torch.int32))


# -- the general-graph engines on the card against device="cpu" -----------------
#
# gibbs and dsim are PyTorch operations (no hand kernel): on the card they
# must equal the same engine on the CPU.  int8 dsim bitwise; f32 with LFSR
# the LFSR states bitwise and the spins equal except where CUDA's tanhf
# and the CPU's tanh decide a site within a few ulp of its boundary (at
# most 1% of the spins; with none differing, everything bitwise).

def graph_problem(kind):
    from repro_torch.core.coloring import greedy_coloring, lattice3d_coloring
    from repro_torch.core.dsim import build_partitioned
    from repro_torch.core.graph import ea3d, random_regular
    from repro_torch.core.partition import brick_partition, greedy_partition
    if kind == "ea3d":
        g, col = ea3d(6, seed=1, device="cpu"), lattice3d_coloring(6)
        labels, K = brick_partition((6, 6, 6), (2, 2, 1)), 4
    else:
        g = random_regular(60, 4, seed=3, device="cpu")
        col = greedy_coloring(g.idx, g.w)
        labels, K = greedy_partition(g.idx, g.w, 3, seed=0), 3
    return g, col, build_partitioned(g, col, labels, K)


def graph_runs(name, kind, sync, devices, **kw):
    from repro_torch import make_engine
    from repro_torch.core.annealing import ea_schedule
    g, col, prob = graph_problem(kind)
    out = {}
    for dev in devices:
        h = make_engine(name, g if name == "gibbs" else prob,
                        coloring=col if name == "gibbs" else None,
                        replicas=3, device=dev, **kw)
        assert h.device.type == torch.device(dev).type
        st, rec = h.run_recorded(h.init_state(seed=2), ea_schedule(24),
                                 [8, 24], sync_every=sync)
        out[torch.device(dev).type] = (st, rec)
    return out


def assert_graph_runs_agree(out, fields, f32):
    (sc, rc), (sg, rg) = out["cpu"], out["cuda"]
    if f32:
        assert_bitwise((sg.rng,), (sc.rng,))
        differ = N(sg.m) != N(sc.m)
        assert differ.mean() <= 0.01
        if differ.any():
            return
    for f in fields:
        assert_bitwise((getattr(sg, f),), (getattr(sc, f),))
    assert torch.equal(rg.energies.cpu(), rc.energies) and \
        rg.flips == rc.flips


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [None, t_pbit.S41])
@pytest.mark.parametrize("kind", ["ea3d", "regular"])
def test_cuda_gibbs_matches_cpu(cuda, kind, fmt):
    out = graph_runs("gibbs", kind, 1, ("cpu", cuda), rng="lfsr", fmt=fmt)
    assert_graph_runs_agree(out, ("m", "rng", "E", "sweep", "flips"), True)


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["phase", 1, 4, None])
@pytest.mark.parametrize("kind", ["ea3d", "regular"])
def test_cuda_dsim_int8_matches_cpu_bitwise(cuda, kind, sync):
    out = graph_runs("dsim", kind, sync, ("cpu", cuda), rng="lfsr",
                     precision="int8")
    assert_graph_runs_agree(
        out, ("m", "ghosts", "macc", "rng", "sweep", "flips"), False)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,sync", [("dsim", 4), ("cmft", 4),
                                       ("cmft", 8)])
def test_cuda_dsim_f32_matches_cpu(cuda, mode, sync):
    out = graph_runs("dsim", "regular", sync, ("cpu", cuda), rng="lfsr",
                     mode=mode)
    assert_graph_runs_agree(
        out, ("m", "ghosts", "macc", "rng", "sweep", "flips"), True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gibbs", "dsim"])
def test_cuda_graph_engines_philox_resume_bitwise(cuda, name):
    """philox on the card: a snapshot restored, and the same start run
    twice, continue bitwise (the stream's position is in the state)."""
    from repro_torch import make_engine
    from repro_torch.core.annealing import ea_schedule
    g, col, prob = graph_problem("ea3d")
    h = make_engine(name, g if name == "gibbs" else prob,
                    coloring=col if name == "gibbs" else None,
                    rng="philox", replicas=2)
    assert h.device.type == "cuda"
    st0 = h.init_state(seed=4)
    a, ra = h.run_recorded(st0, ea_schedule(16), [8, 16], sync_every=4)
    b, rb = h.run_recorded(h.restore(h.snapshot(st0)), ea_schedule(16),
                           [8, 16], sync_every=4)
    assert torch.equal(a.m, b.m) and torch.equal(ra.energies, rb.energies)
    assert torch.equal(h.energy(a), ra.energies[-1])


# -- B7's fused colour phase and the distributed DSIM -----------------------


def sites_on(dev, sites):
    """A PhaseSites built again from ``sites``' tensors moved to dev."""
    from repro_torch.kernels.bitplane_phase import phase_sites
    return phase_sites(*(None if x is None else to(dev, x) for x in (
        sites.slots, sites.mask, sites.lost, sites.idx, sites.signs,
        sites.nz, sites.base)))


def phase_launches(before):
    """Launch-count increments of the B7 key and its fused phase's."""
    return tuple(_build.launch_counts[k] - before[k] for k in (
        "bitplane_gather_count", "bitplane_gather_count:phase"))


@pytest.mark.cuda
@pytest.mark.parametrize("K,D,R,slot0", DIST_GRID)
def test_cuda_bitplane_phase_matches_plain(cuda, K, D, R, slot0):
    """The fused dsim_dist colour phase == its plain version bitwise
    (words, LFSR states, flips) on padded partitions with lost entries,
    one launch counted under the B7 key and ":phase"."""
    from repro_torch.kernels.bitplane_phase import bitplane_phase
    c = dist_case(K, D, R, slot0, seed=K * 1000 + D * 10 + R + slot0)
    mw, gh, s, sites, lut = as_tensors(c)
    flips = torch.full((R,), 3, dtype=torch.int64)
    g = to(cuda, (mw, gh, s, flips, lut))
    gsites = sites_on(cuda, sites)
    ops.bitplane_phase_op(mw, gh, s, sites, lut, 1, c["f_max"], flips)
    before = dict(_build.launch_counts)
    out = bitplane_phase(g[0], g[1], g[2], gsites, g[4], 1, c["f_max"], g[3])
    torch.cuda.synchronize()
    assert out is g[3] and phase_launches(before) == (1, 1)
    assert_bitwise((g[0], g[2], g[3]), (mw, s, flips))


@pytest.mark.cuda
@pytest.mark.parametrize("L,D", [(5, 4), (40, 3), (128, 6), (128, 12)])
def test_cuda_bitplane_phase_apt_matches_plain(cuda, L, D):
    """The fused packed-APT colour phase == its plain version bitwise
    (words, LFSR states, energies), twice in a row (the energy sums and
    the last-block ticket are left zero for the next launch)."""
    from repro_torch.kernels.bitplane_phase import (bitplane_phase_apt,
                                                    phase_sites)
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
    g = to(cuda, (mw, s, thr, E))
    gsites = sites_on(cuda, sites)
    for _ in range(2):
        ops.bitplane_phase_apt_op(mw, s, sites, thr, c["f_max"], E,
                                  float(c["scale"]))
        before = dict(_build.launch_counts)
        bitplane_phase_apt(g[0], g[1], gsites, g[2], c["f_max"], g[3],
                           float(c["scale"]))
        torch.cuda.synchronize()
        assert phase_launches(before) == (1, 1)
        assert_bitwise((g[0], g[1], g[3]), (mw, s, E))
    assert not bool(gsites.scratch.any())


@pytest.mark.cuda
def test_cuda_bitplane_phase_raises_on_bad_operands(cuda):
    """No clamp and no fallback: operands the kernel does not take raise."""
    from repro_torch.kernels.bitplane_phase import bitplane_phase
    c = dist_case(8, 4, 40, True, seed=3)
    mw, gh, s, sites, lut = to(cuda, as_tensors(c)[:3]) + (
        sites_on(cuda, as_tensors(c)[3]), to(cuda, as_tensors(c)[4]))
    flips = torch.zeros(40, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        bitplane_phase(mw, gh, s.to(torch.int32), sites, lut, 0, c["f_max"],
                       flips)
    with pytest.raises(ValueError, match="LUT row"):
        bitplane_phase(mw, gh, s, sites, lut, 3, c["f_max"], flips)
    with pytest.raises(ValueError):
        bitplane_phase(mw, gh, s[:, :33], sites, lut, 0, c["f_max"],
                       flips[:33])


def dist_runs(kind, sync, devices, replicas, **kw):
    from repro_torch import make_engine
    from repro_torch.core.annealing import ea_schedule
    _, _, prob = graph_problem(kind)
    out = {}
    for dev in devices:
        h = make_engine("dsim_dist", prob, rng="lfsr", replicas=replicas,
                        device=dev, **kw)
        assert h.device.type == torch.device(dev).type
        _build.reset_launch_counts()
        st, rec = h.run_recorded(h.init_state(seed=2), ea_schedule(24),
                                 [8, 24], sync_every=sync)
        out[torch.device(dev).type] = (st, rec,
                                       dict(_build.launch_counts))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("prec,R,sync", [("int8", 3, "phase"),
                                         ("int8", 3, 4), ("int8", 1, None),
                                         ("bitplane", 40, 4),
                                         ("bitplane", 5, "phase")])
@pytest.mark.parametrize("kind", ["ea3d", "regular"])
def test_cuda_dsim_dist_fixed_point_matches_cpu_bitwise(cuda, kind, prec, R,
                                                        sync):
    """dsim_dist int8 and bit-plane on the card == device="cpu" bitwise;
    the bit-plane path launches the fused colour phase and no lattice
    kernel."""
    out = dist_runs(kind, sync, ("cpu", cuda), R, precision=prec)
    (sc, rc, _), (sg, rg, counts) = out["cpu"], out["cuda"]
    for f in ("m", "ghosts", "macc", "rng", "sweep", "flips"):
        assert_bitwise((getattr(sg, f),), (getattr(sc, f),))
    assert torch.equal(rg.energies.cpu(), rc.energies) and \
        rg.flips == rc.flips
    gathers = counts.pop("bitplane_gather_count")
    assert (gathers > 0) == (prec == "bitplane")
    assert counts.pop("bitplane_gather_count:phase") == gathers
    assert not any(counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("mode,sync,bitpack", [("dsim", 4, True),
                                               ("dsim", 1, False),
                                               ("cmft", 4, True),
                                               ("cmft", "phase", True)])
def test_cuda_dsim_dist_f32_matches_cpu(cuda, mode, sync, bitpack):
    out = dist_runs("regular", sync, ("cpu", cuda), 3, mode=mode,
                    bitpack=bitpack)
    out = {k: v[:2] for k, v in out.items()}
    assert_graph_runs_agree(
        out, ("m", "ghosts", "macc", "rng", "sweep", "flips"), True)


# -- the degraded mesh and the server on the card ----------------------------

def degraded_runs(engine, prec, R, policy, codes, devices):
    """A degraded mesh run (L=8 lattice on (2,2,2), or dsim_dist on the
    EA3D L=8 instance cut into 4 slabs) on each device: (state in the
    reference's shapes, record, report, raised) per device."""
    from repro_torch import make_engine
    from repro_torch.core.annealing import ea_schedule
    from repro_torch.core.coloring import lattice3d_coloring
    from repro_torch.core.degrade import StateCorruption
    from repro_torch.core.dsim import build_partitioned
    from repro_torch.core.graph import ea3d
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.partition import slab_partition
    out = {}
    for dev in devices:
        if engine == "lattice":
            axes = ("x", "y", "z")
            h = make_engine("lattice", L=8, seed=1, replicas=R,
                            precision=prec, mesh=make_mesh((2, 2, 2), axes),
                            dim_axes=axes, degrade=policy, device=dev)
        else:
            prob = build_partitioned(ea3d(8, seed=1, device=dev),
                                     lattice3d_coloring(8),
                                     slab_partition(8, 4), 4)
            h = make_engine("dsim_dist", prob, rng="lfsr", replicas=R,
                            precision=prec, degrade=policy, device=dev)
        h.eng.set_exchange_faults(codes)
        cur = h.start_recorded(h.init_state(seed=2), ea_schedule(16),
                               [8, 16], sync_every=2)
        raised = False
        while not cur.done:
            try:
                cur.advance(1)
            except StateCorruption:
                raised = True
                break
        out[str(torch.device(dev).type)] = (
            h.eng.global_state(cur.state), cur.record(),
            h.eng.health.report(), raised)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("engine,prec,R", [("lattice", "int8", 3),
                                           ("lattice", "bitplane", 40),
                                           ("dsim_dist", "int8", 3),
                                           ("dsim_dist", "bitplane", 40)])
@pytest.mark.parametrize("policy,codes", [
    ("stale_hold:4", None), ("stale_hold:4", [0, 2, 0, 1, 1]),
    ("freeze_boundary", [0, 0, 2]), ("fail_fast", [0, 0, 0, 0, 0, 1])])
def test_cuda_checked_exchange_matches_cpu_bitwise(cuda, engine, prec, R,
                                                   policy, codes):
    """The checked exchange on the card, with and without injected codes,
    == device="cpu" bitwise: state, energies, flips, the health report
    and where a policy escalated."""
    out = degraded_runs(engine, prec, R, policy, codes, ("cpu", cuda))
    (sc, rc, pc, xc), (sg, rg, pg, xg) = out["cpu"], out["cuda"]
    fields = ("m", "s", "sweep", "flips") if engine == "lattice" else \
        ("m", "ghosts", "rng", "sweep", "flips")
    for f in fields:
        assert_bitwise((getattr(sg, f),), (getattr(sc, f),))
    for x, y in zip(getattr(sg, "halos", ()), getattr(sc, "halos", ())):
        assert_bitwise((x,), (y,))
    assert (pg, xg) == (pc, xc)
    assert rg.flips == rc.flips
    if len(rc.times):
        assert torch.equal(rg.energies.cpu(), rc.energies)
    assert (pg["detections"] > 0) == (codes is not None)


@pytest.mark.cuda
def test_cuda_server_matches_cpu_server(cuda):
    """The same jobs through SampleServer on the card and on the CPU: an
    int8 lattice pair packed into one call, a bit-plane job, a degraded
    mesh job with a drop and a fail_fast dsim_dist job; the card's jobs
    launch the lattice kernels and B7's fused colour phase."""
    from repro_torch.core.coloring import lattice3d_coloring
    from repro_torch.core.graph import ea3d
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.partition import slab_partition
    from repro_torch.serve import FaultPlan, FaultRule, SampleServer
    axes = ("x", "y", "z")
    results = {}
    for dev in ("cpu", cuda):
        plan = FaultPlan([FaultRule(site="exchange_drop", index=3),
                          FaultRule(site="exchange_corrupt", index=1)])
        srv = SampleServer(device=dev, fault_plan=plan, max_retries=0)
        srv.register_problem("lat", L=8, seed=1)
        srv.register_problem("mesh", L=8, seed=1,
                             mesh=make_mesh((2, 2, 2), axes), dim_axes=axes)
        srv.register_problem("graph", graph=ea3d(8, seed=1, device=dev),
                             coloring=lattice3d_coloring(8), K=4,
                             labels=slab_partition(8, 4), rng="lfsr")
        _build.reset_launch_counts()
        ids = [srv.submit("lat", engine="lattice", precision="int8",
                          sweeps=16, replicas=2, seed=s, sync_every=4)
               for s in (0, 1)]
        ids.append(srv.submit("lat", engine="lattice",
                              precision="bitplane", sweeps=16, replicas=40,
                              seed=3, sync_every=4))
        ids.append(srv.submit("mesh", engine="lattice", precision="int8",
                              sweeps=16, replicas=2, seed=4, sync_every=2,
                              degrade_policy="stale_hold:8"))
        ids.append(srv.submit("graph", engine="dsim_dist",
                              precision="bitplane", sweeps=16, replicas=40,
                              seed=5, sync_every=2,
                              degrade_policy="fail_fast"))
        srv.drain()
        results[torch.device(dev).type] = [srv.result(j) for j in ids]
        if dev != "cpu":
            counts = dict(_build.launch_counts)
    for c, g in zip(results["cpu"], results["cuda"]):
        assert c["status"] == g["status"]
        assert c["error"] == g["error"] and c["degrade"] == g["degrade"]
        np.testing.assert_array_equal(c["energies"], g["energies"])
        assert c["flips"] == g["flips"]
    assert results["cuda"][0]["packed_with"] == 1
    assert results["cuda"][4]["status"] == "failed"
    assert "StateCorruption" in results["cuda"][4]["error"]
    for k in ("pbit_brick_sweep_int", "pbit_bitplane_sweep", "brick_energy",
              "bitplane_gather_count"):
        assert counts[k] > 0, k


@pytest.mark.cuda
@pytest.mark.parametrize("rng,packed,draws", [("lfsr", False, True),
                                              ("lfsr", True, True),
                                              ("lfsr", True, False),
                                              ("philox", False, True)])
def test_cuda_apt_icm_matches_cpu(cuda, rng, packed, draws):
    """APT+ICM on the card == device="cpu" with the same HostDraws: lfsr
    and packed bitwise (packed launching the fused colour phase once per
    colour phase); f32 to tanh ties.  With the default generator (the
    card's Philox, not the CPU's stream) packed == unpacked on the card."""
    from repro_torch.core.apt_icm import APTICM, HostDraws
    from repro_torch.core.graph import toroidal_grid
    g = toroidal_grid(8, 12, seed=81, weights="pm1", device="cpu")
    col = t_coloring.greedy_coloring(g.idx, g.w)
    betas = np.linspace(0.2, 3.0, 48)
    out = {}
    for dev in ("cpu", cuda):
        kw = dict(chains=2, rng=rng, device=dev)
        apt = APTICM(g, col, betas, packed=packed, draws=HostDraws(3)
                     if draws else None, **kw)
        st = apt.init_state(seed=1)
        _build.reset_launch_counts()
        st, (_, best) = apt.run(st, 12, icm_every=4, record_every=4)
        counts = dict(_build.launch_counts)
        if not draws:
            un = APTICM(g, col, betas, **kw)
            su, (_, bu) = un.run(un.init_state(seed=1), 12, icm_every=4,
                                 record_every=4)
            assert torch.equal(un.spins(su), apt.spins(st))
            assert torch.equal(su.E, st.E) and np.array_equal(bu, best)
        out[str(dev)] = (apt.spins(st).cpu(), st, best, counts)
    (sc, stc, bc, _), (sg, stg, bg, counts) = out["cpu"], out[str(cuda)]
    gathers = counts.pop("bitplane_gather_count", 0)
    assert gathers == (12 * col.n_colors if packed else 0)
    assert counts.pop("bitplane_gather_count:phase") == gathers
    assert not any(counts.values())
    if not draws:
        return
    if rng == "philox":
        assert (sc != sg).float().mean() <= 0.01
        return
    assert torch.equal(sc, sg)
    assert torch.equal(stc.E, stg.E.cpu()) and np.array_equal(bc, bg)
    assert_bitwise((stg.lfsr,), (stc.lfsr,))
    assert int(stc.swaps) == int(stg.swaps) and \
        int(stc.icms) == int(stg.icms) > 0


# -- LM serving (repro_torch.models, serve.serve_step): no hand kernel --

LM_CUDA_ARCHS = ["deepseek-7b", "h2o-danube-1.8b", "mamba2-370m",
                 "jamba-v0.1-52b", "deepseek-moe-16b", "seamless-m4t-medium"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", LM_CUDA_ARCHS)
def test_greedy_generate_card_equals_cpu(cuda, name):
    """Reduced f32 greedy serving on the card gives the CPU's tokens, its
    prefill logits within 1e-4 of their largest magnitude, and launches
    none of the hand kernels."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve.serve_step import (cache_len_for, greedy_generate,
                                              make_prefill_step)
    cfg = get_config(name).reduced()
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)}
    if cfg.encdec:
        batch["frames"] = rng.standard_normal((2, 12, cfg.d_model)).astype(
            np.float32)
    s_max = 12 + 6 if cfg.encdec else cache_len_for(cfg, 12 + 6)
    out = {}
    _build.reset_launch_counts()
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev)
        params = model.init(0)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        toks = greedy_generate(model, cfg, params, b, 6, device=dev)
        with torch.no_grad():
            logits, _, _ = make_prefill_step(model, cfg)(
                params, b, model.init_cache(2, s_max, dtype=torch.float32))
        out[str(dev)] = (toks.cpu(), logits.cpu())
    assert not any(_build.launch_counts.values())
    (tc, lc), (tg, lg) = out["cpu"], out[str(cuda)]
    assert tg.dtype == torch.int32 and torch.equal(tc, tg)
    assert float((lc - lg).abs().max()) <= 1e-4 * float(lc.abs().max())


@pytest.mark.cuda
def test_build_model_defaults_to_the_card(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    model = build_model(get_config("mamba2-370m").reduced())
    assert model.device.type == "cuda"
    params = model.init(0)
    assert all(t.device.type == "cuda" for t in params["groups"][0][0][
        "mamba"].values() if isinstance(t, torch.Tensor))


# -- LM training (repro_torch.train): no hand kernel ----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name,int8", [("deepseek-7b", False),
                                       ("deepseek-moe-16b", False),
                                       ("mamba2-370m", False),
                                       ("jamba-v0.1-52b", False),
                                       ("deepseek-7b", True)])
def test_train_steps_card_equal_cpu(cuda, name, int8):
    """Four reduced f32 ``make_train_step`` steps on the card, each also
    taken on the CPU from the card's state before it (as chip_smoke.py's
    phase 12a: chained steps amplify rounding, and one ulp of jamba's
    weights moves its fourth step 2.4e-5, tests/test_torch_train.py): each
    loss and gradient norm within 1e-5 relative of the CPU step's, the
    parameters after it within 1e-3, and none of the hand kernels
    launched."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.train.data import MarkovLM
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import TrainState, make_train_step
    from repro_torch.train.tree import tree_leaves, tree_map
    cfg = get_config(name).reduced()
    batches = [b for _, b in zip(range(4), MarkovLM(cfg.vocab, seed=1)
                                 .batches(8, 32))]
    _build.reset_launch_counts()
    opt = AdamW(lr=3e-3, warmup=5, int8_state=int8)
    model = build_model(cfg, cuda)
    params = model.init(0)
    st = TrainState(params, opt.init(params))
    step = make_train_step(model, opt)
    twin_step = make_train_step(build_model(cfg, "cpu"), opt)
    cpu = torch.device("cpu")
    for b in batches:
        before = tree_map(lambda x: x.to(cpu), st)
        st, m = step(st, {k: torch.from_numpy(v).to(cuda)
                          for k, v in b.items()})
        twin, mc = twin_step(before, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        for key in ("loss", "grad_norm"):
            x, y = float(mc[key]), float(m[key])
            assert abs(x - y) <= 1e-5 * abs(x), (key, x, y)
        assert max(float((a - g.cpu()).abs().max()) for a, g in zip(
            tree_leaves(twin.params), tree_leaves(st.params))) < 1e-3
    assert not any(_build.launch_counts.values())


@pytest.mark.cuda
def test_remat_and_checkpoint_on_the_card(cuda, tmp_path):
    """Remat on == off on the card (within 1e-6 of the gradients' largest
    magnitude), and a checkpoint of a bf16 state restores bitwise."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import TrainState
    from repro_torch.train.tree import tree_flatten, tree_leaves, tree_map
    cfg = get_config("h2o-danube-1.8b").reduced()
    params = build_model(cfg, cuda).init(0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 2048)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks, "targets": toks, "mask": torch.ones_like(toks)}
    grads = []
    for c in (cfg, dataclasses.replace(cfg, remat=False)):
        leaves, unflatten = tree_flatten(params)
        xs = [p.detach().requires_grad_() for p in leaves]
        loss = build_model(c, cuda).loss(unflatten(xs), batch, train=True)
        grads.append(torch.autograd.grad(loss, xs))
    scale = max(float(g.abs().max()) for g in grads[0])
    assert max(float((a - b).abs().max())
               for a, b in zip(*grads)) <= 1e-6 * scale
    p16 = tree_map(lambda x: x.to(torch.bfloat16), params)
    st = TrainState(p16, AdamW(int8_state=True).init(p16))
    ckpt.save(str(tmp_path), 1, st, blocking=False)
    ckpt.wait_pending()
    back = ckpt.restore(str(tmp_path), tree_map(torch.empty_like, st))
    assert all(a.dtype == b.dtype and b.device == a.device
               and torch.equal(a, b)
               for a, b in zip(tree_leaves(st), tree_leaves(back)))


@pytest.mark.cuda
def test_train_launcher_defaults_to_the_card(cuda, tmp_path, capsys):
    from repro_torch.launch.train import main
    res = main(["--arch", "mamba2-370m", "--reduced", "--steps", "12",
                "--batch", "4", "--seq", "32", "--log-every", "4",
                "--ckpt", str(tmp_path), "--ckpt-every", "6"])
    assert len(res["losses"]) == 12 and res["start_step"] == 0
    again = main(["--arch", "mamba2-370m", "--reduced", "--steps", "14",
                  "--batch", "4", "--seq", "32", "--ckpt", str(tmp_path)])
    assert again["start_step"] == 12 and len(again["losses"]) == 2
    assert "restored checkpoint at step 12" in capsys.readouterr().out


# -- the kernels' work model and the dry run (launch/) ---------------------


def inline_work(n, plane, S, lut, W, R, nc, decided, decided_one):
    """(bytes, INT32, FP32) of each kernel as chip_smoke.py's timing phase
    wrote them inline before the model moved into
    ``repro_torch.kernels.work``: a frozen copy, at ``n`` sites of a cube
    with ``plane`` halo sites, S sweeps, ``lut`` LUT entries, R replicas
    (W bit-plane words), ``decided`` masked sites over all colours and
    ``decided_one`` in one."""
    return {
        "sweep_int": (2 * 5 * R * n + (nc + 7) * n + 4 * R + R * plane
                      + 4 * lut + 4 * S,
                      S * R * (6 * nc * n + 19 * decided), 0),
        "bitplane_sweep": (2 * 4 * (W + R) * n + 4 * nc * W * n + 52 * n
                           + 4 * R + 4 * W * plane + 4 * lut + 4 * S,
                           S * (6 * nc * R * n + decided * (26 * W + 13 * R)),
                           0),
        "sweep_f32": (2 * 5 * R * n + (nc + 28) * n + R * plane + 4 * R
                      + 4 * S * R, S * 6 * nc * R * n, S * 18 * R * decided),
        "energy": (R * n + 29 * n + R * plane + 4 * R, 0, 17 * R * n),
        "update_int": (2 * 5 * R * n + 8 * n + R * plane + 4 * lut + 4 * R,
                       R * (6 * n + 19 * decided_one), 0),
        "update_f32": (2 * 5 * R * n + 29 * n + R * plane + 4 * R,
                       6 * R * n, 18 * R * decided_one),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("R", [4, 16, 64])
def test_work_model_equals_the_inline_bounds_at_the_main_path_shapes(cuda, R):
    """At the main path's L=100 brick (its masks on the card), the
    package's work model gives the bytes and operations chip_smoke.py
    bounded each kernel by before the move."""
    from repro_torch.core.lattice import build_ea3d_lattice
    from repro_torch.kernels import work
    L, S, lut = 100, 8, 13 * 40
    masks = build_ea3d_lattice(L, seed=0, device=cuda).masks
    nc, W = int(masks.shape[0]), -(-R // 32)
    dec, one = work.decided(masks), work.decided(masks[0])
    assert (dec, one) == (L ** 3, L ** 3 // 2)
    want = inline_work(L ** 3, 6 * L * L, S, lut, W, R, nc, dec, one)
    got = {"sweep_int": work.sweep_int(R, L, L, L, nc, S, dec, lut, S),
           "bitplane_sweep": work.bitplane_sweep(W, R, L, L, L, nc, S, dec,
                                                 lut, S),
           "sweep_f32": work.sweep_f32(R, L, L, L, nc, S, dec),
           "energy": work.energy(R, L, L, L),
           "update_int": work.update_int(R, L, L, L, one, lut),
           "update_f32": work.update_f32(R, L, L, L, one)}
    assert {k: (w.bytes, w.int32, w.fp32) for k, w in got.items()} == want


@pytest.mark.cuda
def test_work_model_at_the_dsim_dist_and_apt_phase_shapes(cuda):
    """B7's fused colour phase at chip_smoke.py phase 6's shape (L=100 on
    the K=8 brick partition, bit-plane R=64, colour 0) and phase 8's (G81,
    2 x 64 lanes): the bytes of the fused kernel's first bounds,
    564,821,128 and 21,542,288."""
    from repro_torch import make_engine
    from repro_torch.core.annealing import beta_table, ea_schedule
    from repro_torch.core.apt_icm import APTICM
    from repro_torch.core.bits import u32_to_i64
    from repro_torch.core.coloring import greedy_coloring, lattice3d_coloring
    from repro_torch.core.dsim import build_partitioned
    from repro_torch.core.graph import ea3d
    from repro_torch.core.partition import brick_partition
    from repro_torch.kernels import work
    from repro_torch.problems.maxcut import gset_like_toroidal, maxcut_to_ising
    L = 100
    prob = build_partitioned(ea3d(L, seed=0, device=cuda),
                             lattice3d_coloring(L),
                             brick_partition((L, L, L), (2, 2, 2)), 8)
    e = make_engine("dsim_dist", prob, rng="lfsr", replicas=64,
                    precision="bitplane", device=cuda).eng
    lut = u32_to_i64(e._lut_for(beta_table(ea_schedule(256).beta_array())))
    w = work.launch_work("bitplane_gather_count:phase", dict(
        sites=e._colors[0].sites, W=2, R=64, lut_bytes=8 * int(lut.shape[1])))
    assert w.bytes == 564_821_128
    g = maxcut_to_ising(gset_like_toroidal(rows=100, cols=200, seed=81,
                                           device=cuda))
    apt = APTICM(g, greedy_coloring(g.idx, g.w), np.linspace(0.2, 3.0, 64),
                 chains=2, rng="lfsr", packed=True, device=cuda)
    lw = int(apt._thr_lanes.shape[1])
    w = work.launch_work("bitplane_gather_count:phase", dict(
        sites=apt._sites[0], W=apt.words, R=apt.L,
        lut_bytes=8 * apt.L * lw + 8 * apt.L))
    assert w.bytes == 21_542_288


@pytest.mark.cuda
def test_dryrun_chunk_card_equals_cpu(cuda):
    """The dry run's chunk at rank 17 of the 16x16 mesh (a 7x7x100 brick
    of the padded L=100 instance, on a "fake" group of 256 ranks) on the
    card against the same rank on the CPU, iteration by iteration from
    the card's state: LFSR states bitwise, spins equal except at sites
    within 8 ulp of a phase's boundary; #3 launched once per iteration,
    noted with its work."""
    import dataclasses
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.core.annealing import ea_schedule
    from repro_torch.core.lattice import build_ea3d_lattice
    from repro_torch.core.lattice_dsim import LatticeDSIM, to_device
    from repro_torch.core.mesh import make_mesh
    dist.init_process_group("fake", rank=17, world_size=256,
                            store=FakeStore())
    try:
        mesh = make_mesh((16, 16), ("data", "model"),
                         group=dist.group.WORLD)
        prob = build_ea3d_lattice(100, seed=0, pad_xy=(112, 112),
                                  device="cpu")
        engs = {d: LatticeDSIM(prob, mesh=mesh,
                               dim_axes=("data", "model", None), device=d)
                for d in (cuda, "cpu")}
        card, twin = engs[cuda], engs["cpu"]
        assert card.brick == (7, 7, 100) and card.coords == [(1, 1, 0)]
        st = card.init_state(seed=0)
        betas = np.asarray(ea_schedule(8).beta_array(), np.float32)
        _build.reset_launch_counts()
        for it in range(2):
            b = betas[it * 4:(it + 1) * 4]
            nxt = card._chunk(st, b[None], 1, 4, None)
            here = dataclasses.replace(
                st, m=st.m.cpu(), s=to_device(st.s, "cpu"),
                halos=tuple(h.cpu() for h in st.halos), sweep=st.sweep.cpu(),
                flips=st.flips.cpu())
            want = twin._chunk(here, b[None], 1, 4, None)
            bk = twin._bricks[0]
            flagged = f32_boundary_sites(
                here.m[0], here.s[0], torch.from_numpy(b), bk.masks, bk.h,
                bk.w6, twin._brick_halos(here.halos)[0])
            assert_f32_agrees((nxt.m[0], nxt.s[0]), (want.m[0], want.s[0]),
                              flagged)
            st = nxt
        assert _build.launch_counts["pbit_brick_sweep"] == 2
        tr = card.trace_chunk(2, 4)
        assert [(ln.name, ln.launches) for ln in tr.launches] == [
            ("pbit_brick_sweep", 1)] * 2
        assert dict(tr.launches[0].shape) == dict(
            R=1, X=7, Y=7, Z=100, n_colors=2, S=4)
    finally:
        dist.destroy_process_group()
