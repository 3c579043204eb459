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
from repro_torch.kernels.lattice_energy import brick_energy
from repro_torch.kernels import pbit_lattice
from repro_torch.kernels.pbit_bitplane import pbit_bitplane_sweep
from repro_torch.kernels.pbit_lattice import (pbit_brick_sweep,
                                              pbit_brick_sweep_int,
                                              pbit_brick_update,
                                              pbit_brick_update_int)


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


def bitplane_inputs(seed, shape, R, n_betas=3, masks=None):
    """One +-J-style brick in word layout (lane-masked color masks, random
    word halos) plus its int8 unpacked twin; ``masks`` (n_colors, *shape)
    int8 replaces the checkerboard."""
    d = int_inputs(seed, shape, R=R, n_betas=n_betas)
    if masks is not None:
        d["masks"] = masks
    rng = d["rng"]
    h = rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
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
    lut = t_pbit.threshold_lut(np.linspace(0.4, 4.0, n_betas), scale, f_max)
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
@pytest.mark.parametrize("R", [20, 32, 64])
def test_cuda_bitplane_sweep_matches_plain(cuda, R):
    d = bitplane_inputs(12, (9, 6, 5), R)
    rows = d["rng"].integers(0, 3, size=(3, R)).astype(np.int32)
    args = to(cuda, bp_args(d, rows, T))
    assert_bitwise(pbit_bitplane_sweep(*args),
                   t_ref.pbit_bitplane_sweep_ref(*args))


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
    R = 33 and 64 lanes, per-lane rows: bitwise the plain version."""
    shape = (L, L, L) if pad is None else (pad[0], pad[1], L)
    d = bitplane_inputs(17, shape, R, masks=lattice_masks(L, shape))
    rows = d["rng"].integers(0, 3, size=(3, R)).astype(np.int32)
    args = to(cuda, bp_args(d, rows, T))
    before = _build.launch_counts["pbit_bitplane_sweep"]
    got = pbit_bitplane_sweep(*args)
    n_colors = d["masks_w"].shape[0]
    assert _build.launch_counts["pbit_bitplane_sweep"] == before + 3 * \
        n_colors
    assert_bitwise(got, t_ref.pbit_bitplane_sweep_ref(*args))
    assert int(N(got[2]).sum()) > 0


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
