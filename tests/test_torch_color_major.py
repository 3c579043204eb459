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
