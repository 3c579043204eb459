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

from repro_torch.core import packing as t_pack
from repro_torch.core import pbit as t_pbit
from repro_torch.core.bits import u32_from_numpy, u32_to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.lattice_energy import brick_energy
from repro_torch.kernels.pbit_bitplane import pbit_bitplane_sweep
from repro_torch.kernels.pbit_lattice import pbit_brick_sweep_int


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


def bitplane_inputs(seed, shape, R, n_betas=3):
    """One +-J-style brick in word layout (lane-masked color masks, random
    word halos) plus its int8 unpacked twin."""
    d = int_inputs(seed, shape, R=R, n_betas=n_betas)
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
    assert _build.launch_counts["pbit_brick_sweep_int"] == before + 8
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
