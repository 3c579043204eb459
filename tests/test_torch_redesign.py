"""The layouts and schedules of the redesigned CUDA sweeps, on the CPU.

The color-major bit-plane kernel (``csrc/pbit_bitplane.cu``) and the
persistent f32 sweep (``csrc/pbit_lattice.cu``) run only on the card; what
surrounds them is Python that runs here: the color order, its offsets and
inverse, the mask check, and the LFSR mode choice.  A plain-PyTorch
emulation of the bit-plane kernel's schedule (color-lazy LFSR steps on
color-major columns, in-place word updates) is held bitwise against the
JAX Pallas kernel in interpret mode, so the reordering is proved before any
card runs it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.kernels.ops as j_ops
from repro_torch.core.bits import MASK32, i64_to_i32, i64_to_u32, u32_to_i64
from repro_torch.core.packing import LANE_WIDTH
from repro_torch.core.pbit import lfsr_next
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.pbit_bitplane import (check_phase_masks,
                                               color_layout, color_order)
from repro_torch.kernels.pbit_lattice import (launch_shape, lfsr_resident,
                                              persistent_smem, smem_budget)
from test_torch_cuda import (T, assert_bitwise, bitplane_inputs, bp_args,
                             lattice_masks)


def lane_masks_w(masks, W):
    """(n_colors, X, Y, Z) int8 masks as full-lane word masks."""
    return T(np.where(masks[:, None] != 0, np.uint32(0xFFFFFFFF),
                      np.uint32(0)).repeat(W, axis=1))


# -- the color order --------------------------------------------------------

@pytest.mark.parametrize("L,shape", [
    (4, (4, 4, 4)), (5, (5, 5, 5)), (3, (4, 5, 3)), (5, (6, 6, 5))])
def test_color_order_sorts_sites_by_phase(L, shape):
    """perm lists the no-mask sites (padding) first, then each color's
    sites in natural order; bounds are the class edges; inv inverts
    perm."""
    masks = lattice_masks(L, shape)
    order = color_order(lane_masks_w(masks, 2))
    n = int(np.prod(shape))
    perm, inv = order.perm.numpy(), order.inv.numpy()
    assert perm.dtype == np.int32 and inv.dtype == np.int32
    assert sorted(perm.tolist()) == list(range(n))
    assert (perm[inv] == np.arange(n)).all()
    assert (inv[perm] == np.arange(n)).all()
    flat = masks.reshape(masks.shape[0], n)
    b = order.bounds
    assert b[0] == 0 and b[-1] == n and len(b) == masks.shape[0] + 2
    none = np.flatnonzero(~flat.any(axis=0))
    assert (perm[b[0]:b[1]] == none).all()
    assert b[1] - b[0] == n - L ** 3
    for c in range(masks.shape[0]):
        assert (perm[b[c + 1]:b[c + 2]] == np.flatnonzero(flat[c])).all()
        assert (order.phase.numpy()[b[c + 1]:b[c + 2]] == c).all()
    assert (order.phase.numpy()[:b[1]] == -1).all()
    assert masks.shape[0] == (3 if L % 2 else 2)


def test_color_order_site_in_no_mask_inside_the_lattice():
    """A site whose mask words are 0 in every phase joins the no-mask
    class, as padding does."""
    masks = lattice_masks(4, (4, 4, 4))
    masks[:, 1, 2, 3] = 0
    order = color_order(lane_masks_w(masks, 1))
    i = (1 * 4 + 2) * 4 + 3
    assert order.bounds[1] == 1 and int(order.perm[0]) == i


def test_color_layout_permutes_planes_and_own_mask():
    d = bitplane_inputs(3, (5, 5, 5), 40, masks=lattice_masks(5, (5, 5, 5)))
    args = bp_args(d, np.zeros(1, np.int32), T)
    masks_w, signs6, nz6, base = args[3], args[4], args[5], args[6]
    lay = color_layout(masks_w, signs6, nz6, base)
    perm = lay.order.perm.long()
    for cm, plane in zip(lay.sign_cm + lay.nz_cm, signs6 + nz6):
        assert torch.equal(u32_to_i64(cm), u32_to_i64(plane).flatten()[perm])
    assert torch.equal(lay.base_cm, base.flatten()[perm])
    words = u32_to_i64(masks_w).flatten(2)            # (nc, W, n)
    own = u32_to_i64(lay.mask_cm)                     # (W, n)
    b = lay.order.bounds
    for c in range(masks_w.shape[0]):
        sl = slice(b[c + 1], b[c + 2])
        assert torch.equal(own[:, sl], words[c][:, perm[sl]])
    assert int(own[:, :b[1]].abs().sum()) == 0
    # the last word plane carries only the live lanes 32..39
    assert int(own[1].max()) == 0xFF
    # cached on the tensors' identities and versions
    assert color_layout(masks_w, signs6, nz6, base) is lay
    base.add_(0)
    assert color_layout(masks_w, signs6, nz6, base) is not lay


# -- the mask check ---------------------------------------------------------

def test_check_phase_masks_accepts_every_lattice_coloring():
    for L, shape in ((4, (4, 4, 4)), (5, (5, 5, 5)), (3, (5, 4, 3))):
        check_phase_masks(lane_masks_w(lattice_masks(L, shape), 1))


def test_check_phase_masks_rejects_a_site_in_two_phases():
    masks = lattice_masks(4, (4, 4, 4))
    masks[1, 0, 0, 0] = 1
    with pytest.raises(ValueError, match="two phases' masks"):
        check_phase_masks(lane_masks_w(masks, 2))


def test_check_phase_masks_rejects_neighbors_in_one_phase():
    masks = lattice_masks(4, (4, 4, 4))
    masks[:, 0, 0, 1] = 0
    masks[0, 0, 0, 1] = 1                   # (0,0,0) is color 0 too
    with pytest.raises(ValueError, match="neighboring sites"):
        check_phase_masks(lane_masks_w(masks, 1))


# -- the LFSR mode and launch shape of the persistent sweeps ----------------

def test_lfsr_mode_by_size():
    """Resident exactly while one block per SM holds its tile's states
    (the same rule for the int8 and f32 sweeps: 4 B per state either way);
    the main path's L=100, R=4 is resident and R=16 is not on a 132-SM,
    227 KB card."""
    sms, smem = 132, 232448
    n = 100 ** 3
    assert smem_budget(4, n, sms) == 4 * 4 * (7576 + 1)
    assert lfsr_resident(4, n, sms, smem)
    assert not lfsr_resident(16, n, sms, smem)
    assert not lfsr_resident(8, n, sms, smem)
    for R, n in ((4, 10 ** 6), (7, 5 * 10 ** 5), (1, 2 ** 24)):
        need = smem_budget(R, n, sms)
        assert lfsr_resident(R, n, sms, need)
        assert not lfsr_resident(R, n, sms, need - 1)
    assert lfsr_resident(64, 6 * 5 * 5, sms, 0) is False
    assert smem_budget(4, 100 ** 3, sms) == persistent_smem(4, 7576, True)
    assert persistent_smem(4, 7576, False) == 16


def occupancy_of(regs_per_thread, smem_per_sm=233472, threads=512):
    """A stand-in for the card's occupancy query: blocks of ``threads``
    threads per SM by registers (64K per SM), threads (2048) and shared
    memory; 0 where one block may not opt in to ``smem``."""
    def occ(smem):
        if smem > 232448:
            return 0
        by_smem = smem_per_sm // max(smem + 1024, 1)
        return min(65536 // (regs_per_thread * threads), 2048 // threads,
                   by_smem)
    return occ


@pytest.mark.parametrize("resident", [True, False])
def test_launch_shape_per_kernel(resident):
    """Each persistent kernel gets its own launch shape from its own
    occupancy: at L=100, R=4 a 64-register kernel (the f32 sweep's
    count) runs 2 blocks per SM with states resident, a 100-register one
    (an int8 build with several sites in flight) 1, and without resident
    states (or with few registers) up to 4 blocks per SM."""
    n, R, sms = 100 ** 3, 4, 132
    f32 = launch_shape(R, n, resident, sms, occupancy_of(64))
    int8 = launch_shape(R, n, resident, sms, occupancy_of(100))
    assert f32[3] == 2 and int8[3] == 1
    for grid, tile, smem, per_sm in (f32, int8):
        assert grid == per_sm * sms and tile == -(-n // grid)
        assert tile * grid >= n > tile * (grid - 1)
        assert smem == persistent_smem(R, tile, resident)
    assert launch_shape(R, n, resident, sms, occupancy_of(32))[3] == 4


def test_launch_shape_refuses_what_does_not_fit():
    with pytest.raises(RuntimeError, match="not even one block per SM"):
        launch_shape(4, 100 ** 3, True, 132, lambda smem: 0)
    # the occupancy is asked with each candidate's shared memory, most
    # blocks per SM first
    asked = []
    assert launch_shape(2, 1000, True, 10,
                        lambda smem: asked.append(smem) or 3)[3] == 3
    assert asked == [persistent_smem(2, 25, True),
                     persistent_smem(2, 34, True)]


# -- the color-lazy, color-major bit-plane schedule -------------------------

def _steps(s, k):
    for _ in range(k):
        s = lfsr_next(s)
    return s


def color_major_sweep(mw, s, rows, masks_w, signs6, nz6, base, halos_w,
                      lut):
    """The CUDA bit-plane sweep's schedule in plain PyTorch: LFSR columns
    permuted into color order; per (sweep, color) phase only that color's
    positions, each lane advanced color+1 times for its draw and
    n_colors-color-1 more, the no-mask class n_colors times in phase 0;
    word updates in place at the class's sites."""
    lay = color_layout(masks_w, signs6, nz6, base)
    R = int(s.shape[0])
    W, X, Y, Z = (int(d) for d in mw.shape)
    n, nc = X * Y * Z, int(masks_w.shape[0])
    perm, b = lay.order.perm.long(), lay.order.bounds
    rows = torch.as_tensor(rows, dtype=torch.int64)
    if rows.dim() == 1:
        rows = rows[:, None].expand(rows.shape[0], R)
    lut64, lw = u32_to_i64(lut), int(lut.shape[1])
    s_cm = u32_to_i64(s).reshape(R, n)[:, perm]
    mwf = u32_to_i64(mw).reshape(W, n)
    planes = [tuple(u32_to_i64(x) for x in g) for g in (signs6, nz6)]
    halos = tuple(u32_to_i64(h) for h in halos_w)
    mask_cm, base_cm = u32_to_i64(lay.mask_cm), lay.base_cm.long()
    lanes = torch.arange(R)
    word, bit = lanes // LANE_WIDTH, (lanes % LANE_WIDTH)[:, None]
    flips = torch.zeros(R, dtype=torch.int64)
    for t in range(rows.shape[0]):
        for c in range(nc):
            if c == 0:
                s_cm[:, b[0]:b[1]] = _steps(s_cm[:, b[0]:b[1]], nc)
            lo, hi = b[c + 1], b[c + 2]
            sites = perm[lo:hi]
            cnt3 = [x.reshape(W, n)[:, sites] for x in
                    t_ref.bitplane_ones_count_ref(mwf.reshape(W, X, Y, Z),
                                                  *planes, halos)]
            st = _steps(s_cm[:, lo:hi], c + 1)
            cnt = sum((1 << q) * ((x[word] >> bit) & 1)
                      for q, x in enumerate(cnt3))
            idx = (base_cm[lo:hi] + 2 * cnt).clamp(0, lw - 1)
            thr = torch.gather(lut64[rows[t]], 1, idx)
            acc = ((st >> 8) >= thr).to(torch.int64)          # (R, k)
            s_cm[:, lo:hi] = _steps(st, nc - c - 1)
            upd = torch.zeros(W, hi - lo, dtype=torch.int64)
            upd.index_add_(0, word, acc << bit)
            mk = mask_cm[:, lo:hi]
            old = mwf[:, sites]
            new = (old & (mk ^ MASK32)) | (upd & mk)
            flips += (((old ^ new)[word] >> bit) & 1).sum(1)
            mwf[:, sites] = new
    s_out = s_cm[:, lay.order.inv.long()].reshape(R, X, Y, Z)
    return (i64_to_u32(mwf.reshape(W, X, Y, Z)), i64_to_u32(s_out),
            i64_to_i32(flips))


@pytest.mark.parametrize("L,shape,S", [(4, (4, 4, 4), 2), (3, (4, 3, 3), 1)])
def test_color_major_schedule_matches_pallas_interpret(L, shape, S):
    """R=33 lanes (two word planes), per-lane rows, even L (two colors)
    and odd L with padding (three colors): the emulated schedule equals
    the JAX word kernel in interpret mode and the plain version,
    bitwise."""
    R = 33
    d = bitplane_inputs(22, shape, R, masks=lattice_masks(L, shape))
    rows = d["rng"].integers(0, 3, size=(S, R)).astype(np.int32)
    got = color_major_sweep(*bp_args(d, rows, T))
    want = j_ops.pbit_bitplane_sweep_op(*bp_args(d, rows, jnp.asarray),
                                        impl="interpret")
    assert_bitwise(got, want)
    assert_bitwise(got, t_ref.pbit_bitplane_sweep_ref(*bp_args(d, rows, T)))
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("L,shape", [(6, (6, 6, 6)), (5, (6, 7, 5))])
def test_color_major_schedule_matches_plain_wide(L, shape):
    """R=64 (two full words) over four sweeps against the plain version."""
    R = 64
    d = bitplane_inputs(23, shape, R, masks=lattice_masks(L, shape))
    rows = d["rng"].integers(0, 3, size=(4, R)).astype(np.int32)
    assert_bitwise(color_major_sweep(*bp_args(d, rows, T)),
                   t_ref.pbit_bitplane_sweep_ref(*bp_args(d, rows, T)))
