"""The f32 single-phase kernel's word layout and the per-phase flip count,
on the CPU.

The CUDA f32 phase (``csrc/pbit_lattice.cu``, ``word_phase_kernel``) runs
one thread per word of 4 consecutive z-sites where rows are word-aligned,
else one per site (``pbit_lattice.phase_width``).  Its neighbors come from
32-bit spin words: the +-x and +-y rows as whole words, the z neighbors of
the word's sites from the own word by byte shifts plus the adjacent byte
on each side, or the z halo at a face.  A plain-PyTorch emulation of that
dataflow is held bitwise to the plain version and, up to tanh ties, to the
JAX kernel in interpret mode, at Z a multiple of 4 and not, so the layout
is proved before any card runs it.  The engine's per-phase dispatch
counts flips through the ``flips`` argument of ``ops.pbit_update_op`` /
``pbit_update_int_op``; their plain path is held here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.pbit_lattice import pbit_brick_update as j_update
from repro_torch import S41
from repro_torch.core import pbit as t_pbit
from repro_torch.core.bits import i64_to_u32, u32_to_i64
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.pbit_lattice import phase_width
from test_torch_cuda import (N, T, assert_bitwise, f32_inputs, int_inputs,
                             torch_f32_args, torch_int_args)
from test_torch_f32 import (FMTS, assert_f32_matches_jax, jax_f32_args,
                            jax_near_ties)


def _words(a, kw):
    """int8 spins (..., Z) -> (..., Z // kw) int64 words, byte q of a word
    being site z0 + q."""
    b = (a.to(torch.int64) & 0xFF).reshape(*a.shape[:-1], -1, kw)
    return sum(b[..., q] << (8 * q) for q in range(kw))


def _byte(w, q):
    """Byte q of int64-carried words as a signed int8 value (int64)."""
    v = (w >> (8 * q)) & 0xFF
    return torch.where(v >= 128, v - 256, v)


def word_phase(m, s, beta, mask, h, w6, halos, fmt=None):
    """The CUDA f32 phase's dataflow in plain PyTorch on (R, X, Y, Z)
    spins: words of kw = phase_width(Z) z-sites; every LFSR state
    advances; masked sites decided from word-extracted neighbors, the rest
    keep their byte.  Returns (m, s, flips)."""
    R, X, Y, Z = (int(d) for d in m.shape)
    kw = phase_width(Z, (), ())
    xlo, xhi, ylo, yhi, zlo, zhi = halos
    own = _words(m, kw)
    xm = _words(torch.cat([xlo[:, None], m[:, :-1]], 1), kw)
    xp = _words(torch.cat([m[:, 1:], xhi[:, None]], 1), kw)
    ym = _words(torch.cat([ylo[:, :, None], m[:, :, :-1]], 2), kw)
    yp = _words(torch.cat([m[:, :, 1:], yhi[:, :, None]], 2), kw)
    # the byte before each word (z0 - 1, or the zlo halo at z0 = 0) and
    # after it (z0 + kw, or the zhi halo at the last word of a row)
    before = torch.cat([zlo[..., None], m[..., :-1]], -1)[..., ::kw]
    after = torch.cat([m[..., 1:], zhi[..., None]], -1)[..., kw - 1::kw]
    full = (1 << (8 * kw)) - 1
    zm = ((own << 8) | (before.to(torch.int64) & 0xFF)) & full
    zp = (own >> 8) | ((after.to(torch.int64) & 0xFF) << (8 * (kw - 1)))
    st = t_pbit.lfsr_next(u32_to_i64(s))
    mk = _words(mask[None], kw)
    beta = torch.as_tensor(beta, dtype=torch.float32).reshape(-1, 1, 1, 1)
    new = own
    for q in range(kw):
        sl = (Ellipsis, slice(q, None, kw))
        nb = [_byte(w, q).to(torch.float32) for w in (xm, xp, ym, yp, zm, zp)]
        wq = [w[sl] for w in w6]
        field = (h[sl] + wq[0] * nb[0] + wq[1] * nb[1] + wq[2] * nb[2]
                 + wq[3] * nb[3] + wq[4] * nb[4] + wq[5] * nb[5])
        v = t_pbit.pbit_update(field, beta, t_pbit.lfsr_uniform(st[sl]), fmt)
        dec = (v.to(torch.int64) & 0xFF) << (8 * q)
        keep = own & (0xFF << (8 * q))
        new = (new & ~(0xFF << (8 * q))) | torch.where(
            _byte(mk, q) != 0, dec, keep)
    flips = sum((_byte(own ^ new, q) != 0).to(torch.int64)
                .flatten(1).sum(1) for q in range(kw))
    m_out = torch.stack([_byte(new, q) for q in range(kw)], -1).reshape(
        R, X, Y, Z).to(torch.int8)
    return m_out, i64_to_u32(st), flips


SHAPES = [(5, 4, 8), (4, 5, 7), (3, 4, 4), (4, 3, 6)]


@pytest.mark.parametrize("shape", SHAPES)
def test_phase_width_by_z(shape):
    Z = shape[-1]
    assert phase_width(Z, (0, 16), (0, 4)) == (4 if Z % 4 == 0 else 1)


def test_phase_width_by_alignment():
    """A word-aligned brick takes the per-site path where a 16-byte
    operand (states, f32 constants) or a 4-byte one (spins, mask, halos)
    is misaligned."""
    assert phase_width(8, (512, 1024), (4, 8)) == 4
    assert phase_width(8, (512, 1028), (4, 8)) == 1
    assert phase_width(8, (512, 1024), (4, 10)) == 1
    assert phase_width(12, (), ()) == 4 and phase_width(10, (), ()) == 1


@pytest.mark.parametrize("fmt", [None, "S41"])
@pytest.mark.parametrize("per_replica", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_word_phase_matches_plain(shape, per_replica, fmt):
    """The word dataflow equals the plain version bitwise (spins, LFSR)
    and its byte count equals the changed sites, for every mask."""
    R = 3
    d = f32_inputs(41, shape, R=R, pm_j=False)
    m, s, _, masks, h, w6, halos = torch_f32_args(d, np.zeros(1, np.float32))
    beta = T(d["rng"].uniform(0.3, 3.0, size=R).astype(np.float32)) \
        if per_replica else 1.7
    tf = FMTS[fmt][1]
    for mask in masks:
        got = word_phase(m, s, beta, mask, h, w6, halos, tf)
        want = t_ref.pbit_brick_update_ref(m, s, beta, mask, h, w6, halos,
                                           tf)
        assert_bitwise(got[:2], want)
        assert N(got[2]).tolist() == \
            (N(want[0]) != N(m)).reshape(R, -1).sum(1).tolist()
        assert (N(got[0]) != N(m)).any()


@pytest.mark.parametrize("fmt", [None, "S41"])
@pytest.mark.parametrize("shape", [(4, 3, 8), (3, 4, 7)])
def test_word_phase_matches_pallas_interpret(shape, fmt):
    """Replica by replica against the JAX kernel in interpret mode: LFSR
    bitwise, spins equal except at near-tie sites."""
    R = 2
    d = f32_inputs(42, shape, R=R, pm_j=False)
    jf, tf = FMTS[fmt]
    betas = np.array([0.8, 2.4], np.float32)
    m, s, _, masks, h, w6, halos = torch_f32_args(d, np.zeros(1, np.float32))
    got = word_phase(m, s, T(betas), masks[0], h, w6, halos, tf)
    for r in range(R):
        jm, js, _, jmasks, jh, jw6, jhalos = jax_f32_args(d, 0, r)
        want = j_update(jm, js, betas[r], jmasks[0], jh, jw6, jhalos,
                        fmt=jf, interpret=True)
        near, n = jax_near_ties(jm, js, betas[r:r + 1], jmasks[:1], jh,
                                jw6, jhalos, jf)
        assert_f32_matches_jax([g[r] for g in got[:2]], want, near, n)


# -- the per-phase dispatch's flip count --------------------------------------

def test_counted_ops_add_the_changed_sites():
    """The phase ops given ``flips`` return the plain phase's (m, s) and
    add each replica's changed sites to it in place."""
    R = 3
    d = f32_inputs(43, (4, 5, 8), R=R, pm_j=False)
    m, s, _, masks, h, w6, halos = torch_f32_args(d, np.zeros(1, np.float32))
    beta = T(np.array([0.5, 1.5, 3.0], np.float32))
    flips = torch.tensor([7, 0, 2], dtype=torch.int32)
    got = t_ops.pbit_update_op(m, s, beta, masks[1], h, w6, halos, fmt=S41,
                               bx=2, flips=flips)
    want = t_ref.pbit_brick_update_ref(m, s, beta, masks[1], h, w6, halos,
                                       S41)
    assert_bitwise(got, want)
    changed = (N(want[0]) != N(m)).reshape(R, -1).sum(1)
    assert flips.dtype == torch.int32
    assert N(flips).tolist() == (changed + [7, 0, 2]).tolist()

    di = int_inputs(44, (4, 5, 7), R=R, multibit=True)
    m, s, _, masks, h_q, w6_q, halos, lut = torch_int_args(
        di, np.zeros(1, np.int32))
    row = T(np.array([2, 0, 1], np.int32))
    flips = torch.zeros(R, dtype=torch.int32)
    got = t_ops.pbit_update_int_op(m, s, row, masks[0], h_q, w6_q, halos,
                                   lut, flips=flips)
    want = t_ref.pbit_brick_update_int_ref(m, s, row, masks[0], h_q, w6_q,
                                           halos, lut)
    assert_bitwise(got, want)
    assert N(flips).tolist() == \
        (N(want[0]) != N(m)).reshape(R, -1).sum(1).tolist()
