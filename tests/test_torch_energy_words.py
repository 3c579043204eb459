"""The redesigned brick energy on the CPU: its dataflow and the bit-plane
readout.

The CUDA energy (``csrc/lattice_energy.cu``) runs one thread per word of 4
z-sites (or per site where rows are not word-aligned) over all replicas
and reduces in a fixed order: a thread's sites in order, a shuffle tree
per warp, the warps in order per block, then a second pass over the block
partials.  ``energy_dataflow`` (``test_torch_cuda.py``, which the card's
tests hold the kernel to bitwise) emulates that order in plain PyTorch;
here it is held to the plain version and to the JAX kernel in interpret
mode: exactly on +-J couplings, on Gaussian ones within rtol 1e-5 of the
energy's scale, the larger of |E| and the root sum of squares of its site
terms (another summation order).  On the bit-plane path the engine reads
its energies from the word planes and word halos
(``ops.brick_energy_words_op``, whose plain version unpacks both, as the
reference's readout does); that is held bitwise to the JAX bit-plane
engine's energies and to the port's int8 engine on the same spins.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.engines.registry import make_engine as j_make
from repro.kernels.lattice_energy import brick_energy as j_brick_energy
from repro_torch import make_engine as t_make
from repro_torch.core.packing import pack_lanes, unpack_lanes
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.pbit_lattice import phase_width
from test_torch_cuda import (N, T, assert_energy_close, energy_dataflow,
                             energy_inputs)

SHAPES = [(5, 4, 8), (4, 5, 7), (6, 3, 12), (3, 4, 5)]


def assert_energies(got, want, pm_j, args):
    if pm_j:
        np.testing.assert_array_equal(N(got), N(want))
    else:
        assert_energy_close(got, want, args)


@pytest.mark.parametrize("pm_j", [True, False])
@pytest.mark.parametrize("R", [3, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_energy_dataflow_matches_plain(shape, R, pm_j):
    m, active, h, w6, halos = energy_inputs(50, shape, pm_j, R=R)
    args = (T(m), T(active), T(h), tuple(T(w) for w in w6),
            tuple(T(x) for x in halos))
    kw = phase_width(shape[-1], (), ())
    got = energy_dataflow(*args, kw)
    assert got.dtype == torch.float32 and got.shape == (R,)
    assert_energies(got, t_ref.brick_energy_ref(*args), pm_j, args)
    if kw == 4:
        # one site per thread regroups the sums, not the result on +-J
        assert_energies(energy_dataflow(*args, 1), got, pm_j, args)


@pytest.mark.parametrize("pm_j", [True, False])
@pytest.mark.parametrize("shape", [(5, 4, 8), (4, 5, 7)])
def test_energy_dataflow_matches_pallas_interpret(shape, pm_j):
    """Replica by replica against the JAX kernel in interpret mode."""
    R = 2
    m, active, h, w6, halos = energy_inputs(51, shape, pm_j, R=R)
    args = (T(m), T(active), T(h), tuple(T(w) for w in w6),
            tuple(T(x) for x in halos))
    got = energy_dataflow(*args, phase_width(shape[-1], (), ()))
    for r in range(R):
        want = j_brick_energy(jnp.asarray(m[r]), jnp.asarray(active),
                              jnp.asarray(h),
                              tuple(jnp.asarray(w) for w in w6),
                              tuple(jnp.asarray(x[r]) for x in halos),
                              interpret=True)
        assert_energies(got[r:r + 1], torch.tensor([float(want)]), pm_j,
                        (args[0][r:r + 1], *args[1:4],
                         tuple(x[r:r + 1] for x in args[4])))


def test_energy_dataflow_zero_halo_contributes_zero():
    """Zero halo spins (the int8 state's open faces) contribute w * 0, as
    the plain version's product does: the same bits."""
    m, active, h, w6, halos = energy_inputs(52, (4, 4, 8), True, R=2)
    halos = tuple(np.zeros_like(x) for x in halos)
    args = (T(m), T(active), T(h), tuple(T(w) for w in w6),
            tuple(T(x) for x in halos))
    np.testing.assert_array_equal(N(energy_dataflow(*args, 4)),
                                  N(t_ref.brick_energy_ref(*args)))


@pytest.mark.parametrize("R", [20, 32, 64])
def test_words_op_matches_jax_bitplane_energy(R):
    """``brick_energy_words_op`` (plain) on the port's word planes and the
    word halos of a fresh exchange equals the JAX bit-plane engine's
    energies bitwise (+-J), on the same state."""
    L = 4
    jh = j_make("lattice", L=L, seed=0, replicas=R, precision="bitplane",
                impl="ref")
    th = t_make("lattice", L=L, seed=0, replicas=R, precision="bitplane",
                device="cpu")
    jst, tst = jh.init_state(seed=3), th.init_state(seed=3)
    eng = th.eng
    halos_w = eng._squeeze(eng._exchange(tst.m))
    got = t_ops.brick_energy_words_op(tst.m, R, eng.p.active, eng.p.h,
                                      eng.p.w6, halos_w)
    want = np.asarray(jh.eng.energy(jst))
    assert got.shape == (R,)
    np.testing.assert_array_equal(N(got), want)
    np.testing.assert_array_equal(N(eng.energy(tst)), want)


@pytest.mark.parametrize("R", [20, 64])
def test_engine_bitplane_energy_on_cpu_unchanged(R):
    """The bit-plane engine's energies on the CPU equal the readout it had
    before (unpack the spins, an int8 exchange of them, the int8 energy)
    and the int8 engine's on the same spins, bitwise (+-J)."""
    L = 5
    tb = t_make("lattice", L=L, seed=1, replicas=R, precision="bitplane",
                device="cpu").eng
    ti = t_make("lattice", L=L, seed=1, replicas=R, precision="int8",
                device="cpu").eng
    sb, si = tb.init_state(seed=4), ti.init_state(seed=4)
    m = unpack_lanes(sb.m, R)
    assert torch.equal(m, si.m)
    before = t_ref.brick_energy_ref(m, tb.p.active, tb.p.h, tb.p.w6,
                                    tb._squeeze(tb._exchange(m)))
    got = tb.energy(sb)
    assert torch.equal(got, before)
    assert torch.equal(got, ti.energy(si))


def test_words_op_equals_int8_op_on_unpacked_inputs():
    """The plain word readout is the int8 energy of the unpacked spins and
    word halos (a zero word is -1 in every lane), for a partial last
    word; the CPU runs no kernel."""
    R, shape = 37, (4, 3, 8)
    m, active, h, w6, _ = energy_inputs(53, shape, True, R=R)
    rng = np.random.default_rng(54)
    mw = pack_lanes(T(m))
    halos_w = tuple(T(rng.integers(0, 2 ** 32, size=(2,) + sh,
                                   dtype=np.uint32))
                    for sh in [(3, 8), (3, 8), (4, 8), (4, 8), (4, 3),
                               (4, 3)])
    consts = (T(active), T(h), tuple(T(w) for w in w6))
    got = t_ops.brick_energy_words_op(mw, R, *consts, halos_w)
    want = t_ops.brick_energy_op(
        T(m), *consts, tuple(unpack_lanes(x, R) for x in halos_w))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="word planes"):
        t_ops.brick_energy_words_op(mw, 70, *consts, halos_w)
