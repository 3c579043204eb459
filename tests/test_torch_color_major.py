"""The bit-plane lattice engine's color-major form of its LFSR columns, on
the CPU.

On CUDA the lattice engine holds each brick's LFSR columns as (R, n) in
kernel #2's color-major order (``LatticeDSIM.color_major``) and converts
them only where a state crosses into or out of the reference's shapes
(``shard_state`` / ``init_state``, ``global_state``).  Here the form is
forced on CPU engines, whose color-major op runs its plain path (permute
out, the plain sweep, permute in), so the conversions and the engine's
plumbing of the form are held to the natural engine bitwise.  The kernel
on color-major columns is held to its plain version in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import make_engine
from repro_torch.core.annealing import ea_schedule
from repro_torch.core.bits import u32_from_numpy
from repro_torch.core.mesh import make_mesh
from repro_torch.kernels import _build, ops
from repro_torch.kernels.pbit_bitplane import (color_layout,
                                               from_color_major,
                                               to_color_major)
from test_torch_cuda import bitplane_inputs, bp_args, lattice_masks, T

AXES = ("x", "y", "z")
PERMUTE = "pbit_bitplane_sweep:lfsr_permute"


def i32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def fields(st) -> list:
    return [st.m, st.s, st.sweep, st.flips, *st.halos]


def assert_same(a, b):
    for x, y in zip(fields(a), fields(b)):
        assert x.shape == y.shape and torch.equal(i32(x), i32(y))


def engine(R: int, mesh=None, color_major: bool = False):
    kw = {} if mesh is None else dict(mesh=make_mesh(mesh, AXES),
                                      dim_axes=AXES)
    h = make_engine("lattice", L=6, seed=1, replicas=R, precision="bitplane",
                    device="cpu", **kw)
    assert not h.eng.color_major        # the plain path keeps natural order
    h.eng.color_major = color_major
    return h


@pytest.mark.parametrize("L,shape", [(4, (4, 4, 4)), (5, (5, 5, 5)),
                                     (3, (4, 4, 3))],
                         ids=["2colors", "3colors", "padded"])
def test_columns_round_trip_through_a_color_order(L, shape):
    """Position p of the color-major columns holds natural site perm[p],
    and the way back gives the columns unchanged; each way counts one
    permutation."""
    d = bitplane_inputs(5, shape, 40, masks=lattice_masks(L, shape))
    order = color_layout(T(d["masks_w"]), tuple(map(T, d["signs6"])),
                         tuple(map(T, d["nz6"])), T(d["base"])).order
    s = u32_from_numpy(d["s"], "cpu")
    before = _build.launch_counts[PERMUTE]
    cm = to_color_major(s, order)
    assert tuple(cm.shape) == (40, int(np.prod(shape)))
    perm = order.perm.long()
    assert torch.equal(i32(cm), i32(s).reshape(40, -1)[:, perm])
    back = from_color_major(cm, order, shape)
    assert torch.equal(i32(back), i32(s))
    assert _build.launch_counts[PERMUTE] == before + 2


def unpack(packed: torch.Tensor):
    """The kernel's packed read-only words (n,) -> six sign and six
    nonzero words (all-ones or zero) and base, as int64."""
    w = packed.view(torch.int32).to(torch.int64)
    bit = lambda k: ((w >> k) & 1) * 0xFFFFFFFF  # noqa: E731
    return ([bit(d) for d in range(6)], [bit(6 + d) for d in range(6)],
            w >> 12)


@pytest.mark.parametrize("L,shape", [(4, (4, 4, 4)), (5, (5, 5, 5)),
                                     (3, (4, 4, 3))],
                         ids=["2colors", "3colors", "padded"])
def test_packed_plane_unpacks_to_signs_nonzeros_and_base(L, shape):
    """The layout's packed word of position p holds the signs, nonzero
    masks and base of natural site perm[p], bit for bit; its LUT index
    range holds every base + 2c the site's nonzero count allows; its own
    mask words are each position's word of its own phase (zero in the
    no-mask class)."""
    d = bitplane_inputs(5, shape, 40, masks=lattice_masks(L, shape))
    signs6, nz6 = tuple(map(T, d["signs6"])), tuple(map(T, d["nz6"]))
    lay = color_layout(T(d["masks_w"]), signs6, nz6, T(d["base"]))
    perm = lay.order.perm.long()
    assert lay.packed.dtype == torch.uint32
    assert tuple(lay.packed.shape) == (int(np.prod(shape)),)
    signs, nzs, base = unpack(lay.packed)
    for got, want in zip(signs + nzs, signs6 + nz6):
        assert torch.equal(got, i32(want).flatten()[perm].to(torch.int64)
                           & 0xFFFFFFFF)
    assert torch.equal(base, T(d["base"]).flatten()[perm].to(torch.int64))
    nnz = sum(x != 0 for x in nzs)
    assert lay.idx_lo == int(base.min())
    assert lay.idx_hi == int((base + 2 * nnz).max())
    words = i32(T(d["masks_w"])).flatten(2)                # (nc, W, n)
    phase = lay.order.phase
    want = words[phase.clamp(min=0), :, perm].t()
    want = torch.where(phase >= 0, want, 0)
    assert torch.equal(i32(lay.mask_cm), want)


def test_packed_plane_saturates_base_and_refuses_mixed_words():
    """Base saturates to 20 signed bits (no clamped LUT index moves while
    rows hold at most 2^19 entries); a sign word that is neither all-ones
    nor zero cannot be packed."""
    from repro_torch.kernels.pbit_bitplane import pack_planes
    d = bitplane_inputs(6, (3, 3, 3), 8)
    signs6, nz6 = tuple(map(T, d["signs6"])), tuple(map(T, d["nz6"]))
    base = T(d["base"]).clone()
    base.view(-1)[:3] = torch.tensor([1 << 25, -(1 << 25), (1 << 19) - 1],
                                     dtype=torch.int32)
    _, _, got = unpack(pack_planes(signs6, nz6, base).view(torch.uint32))
    want = base.flatten().to(torch.int64).clamp(-(1 << 19), (1 << 19) - 1)
    assert torch.equal(got, want)
    mixed = list(signs6)
    mixed[2] = mixed[2].clone()
    mixed[2].view(torch.int32).view(-1)[4] = 0x00FF
    with pytest.raises(ValueError, match="all-ones or zero"):
        pack_planes(tuple(mixed), nz6, base)


@pytest.mark.parametrize("sites,W,want", [
    (500_000, 2, 1), (62_500, 2, 1), (62_500, 8, 1), (33_792, 8, 2),
    (16_384, 4, 4), (16_384, 8, 4), (2_048, 8, 8), (135, 3, 3),
    (135, 1, 1), (25_600, 3, 2), (16_896, 5, 3)],
    ids=["L100", "mesh_brick", "mesh_brick_W8", "one_block_an_sm",
         "L32_W4", "L32_W8", "L16_W8", "tiny_W3", "tiny_W1", "W3_in_2",
         "W5_in_3"])
def test_plane_groups_fill_the_card_and_leave_no_group_empty(sites, W,
                                                             want):
    """A phase of at least two 256-thread blocks an SM (132 SMs) keeps each
    site's planes in one thread; a smaller one splits them into at most W
    groups of equal size but the last, none empty, so that it fills the
    card as far as the planes allow."""
    from repro_torch.kernels.pbit_bitplane import plane_groups
    g = plane_groups(sites, W, 132)
    assert g == want
    per = -(-W // g)
    assert (g - 1) * per < W <= g * per


def test_color_major_op_plain_path_is_the_natural_op():
    """The color-major op's plain path == the natural op on the gathered
    columns, and leaves its input as it was."""
    d = bitplane_inputs(9, (5, 5, 5), 40, masks=lattice_masks(5, (5, 5, 5)))
    rows = d["rng"].integers(0, 3, size=(3, 40)).astype(np.int32)
    args = bp_args(d, rows, T)
    order = color_layout(*args[3:7]).order
    want = ops.pbit_bitplane_sweep_op(*args)
    s_cm = to_color_major(args[1], order)
    kept = s_cm.clone()
    got = ops.pbit_bitplane_sweep_cm_op(args[0], s_cm, *args[2:])
    assert torch.equal(i32(got[0]), i32(want[0]))
    assert torch.equal(i32(got[1]), i32(to_color_major(want[1], order)))
    assert torch.equal(got[2], want[2])
    assert torch.equal(i32(s_cm), i32(kept))


@pytest.mark.parametrize("mesh", [None, (2, 1, 1)], ids=["brick", "mesh"])
def test_global_state_inverts_shard_state(mesh):
    """shard_state puts each brick's columns in its color order, (R, n)
    per brick, one permutation a brick; global_state gives the state back
    unchanged, one permutation a brick; neither changes its input."""
    h = engine(40, mesh, color_major=True)
    plain = engine(40, mesh)
    st = plain.eng.global_state(plain.init_state(3))
    kept = [x.clone() for x in fields(st)]
    K = 1 if mesh is None else int(np.prod(mesh))
    before = _build.launch_counts[PERMUTE]
    sh = h.eng.shard_state(st)
    assert _build.launch_counts[PERMUTE] == before + K
    n = 6 ** 3 // K
    assert tuple(sh.s.shape) == ((40, n) if mesh is None else (K, 40, n))
    back = h.eng.global_state(sh)
    assert _build.launch_counts[PERMUTE] == before + 2 * K
    assert_same(back, st)
    for x, y in zip(fields(st), kept):
        assert torch.equal(i32(x), i32(y))


@pytest.mark.parametrize("mesh", [None, (2, 1, 1)], ids=["brick", "mesh"])
def test_color_major_engine_runs_the_natural_engine_bitwise(mesh):
    """Forced into the color-major form, the engine's runs equal the
    natural engine's bitwise through global_state: words, columns, halos,
    flips and record-point energies, at a partial word plane (R=40)."""
    out = []
    for cm in (False, True):
        h = engine(40, mesh, color_major=cm)
        st, rec = h.run_recorded(h.init_state(seed=2), ea_schedule(24),
                                 [8, 24], sync_every=8)
        out.append((h.eng.global_state(st), rec))
    (a, ra), (b, rb) = out
    assert_same(a, b)
    assert torch.equal(ra.energies, rb.energies) and ra.flips == rb.flips
