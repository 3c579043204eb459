"""The port's plain kernel versions against the JAX kernels.

On the CPU each plain PyTorch version is held to the JAX Pallas kernel run
in interpret mode and to its jnp oracle, on the same numpy inputs: the
sweeps bitwise (spins, LFSR states, flips), the energy exactly on +-J
couplings and to ``rtol=1e-6`` on general ones (f32 sums in another order).
The inputs come from ``test_torch_cuda.py``'s builders; that file holds the
CUDA kernels to the plain versions on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.kernels.ops as j_ops
import repro.kernels.ref as j_ref
from repro.core import pbit as j_pbit
from repro.kernels.lattice_energy import brick_energy as j_brick_energy
from repro.kernels.pbit_bitplane import pbit_bitplane_sweep as j_bp_sweep
from repro.kernels.pbit_lattice import pbit_brick_sweep_int as j_int_sweep
from repro_torch.core import packing as t_pack
from repro_torch.core.bits import i64_to_u32, u32_to_i64
from repro_torch.kernels import _build
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.lattice_energy import brick_energy
from repro_torch.kernels.pbit_bitplane import pbit_bitplane_sweep
from repro_torch.kernels.pbit_lattice import halo_shapes, pbit_brick_sweep_int
from test_torch_cuda import (N, T, assert_bitwise, bitplane_inputs, bp_args,
                             energy_inputs, int_inputs, torch_int_args)


def jax_int_args(d, rows, r=None):
    pick = (lambda a: a) if r is None else (lambda a: a[r])
    return (jnp.asarray(pick(d["m"])), jnp.asarray(pick(d["s"])),
            jnp.asarray(rows), jnp.asarray(d["masks"]),
            jnp.asarray(d["h_q"]), tuple(jnp.asarray(w) for w in d["w6_q"]),
            tuple(jnp.asarray(pick(h)) for h in d["halos"]),
            jnp.asarray(d["lut"]))


# -- int8 sweep ----------------------------------------------------------------

@pytest.mark.parametrize("shape,multibit", [
    ((8, 4, 4), False), ((16, 8, 8), False), ((6, 3, 5), True)])
def test_int_sweep_plain_matches_pallas_interpret(shape, multibit):
    d = int_inputs(1, shape, multibit=multibit)
    rows = np.array([0, 2, 1, 2], np.int32)
    want = j_int_sweep(*jax_int_args(d, rows), interpret=True)
    oracle = j_ref.pbit_brick_sweep_int_ref(*jax_int_args(d, rows))
    got = t_ref.pbit_brick_sweep_int_ref(*torch_int_args(d, rows))
    assert_bitwise(got, want)
    assert_bitwise(got, oracle)
    assert (N(got[0]) != d["m"]).any() and int(got[2]) > 0
    if multibit:
        assert d["lut"].shape[1] > j_pbit.LUT_SELECT_MAX_WIDTH


@pytest.mark.parametrize("per_replica", [False, True])
def test_int_sweep_replica_batch_matches_jax_per_replica(per_replica):
    """The replica-batched plain version (the CUDA kernel's layout) equals
    the JAX oracle run replica by replica, with shared (S,) or per-replica
    (S, R) LUT rows."""
    R, shape = 3, (6, 4, 4)
    d = int_inputs(2, shape, R=R)
    rows = d["rng"].integers(0, 3, size=(3, R)).astype(np.int32) \
        if per_replica else np.array([2, 0, 1], np.int32)
    got = t_ops.pbit_sweep_int_op(*torch_int_args(d, rows))
    for r in range(R):
        rr = rows[:, r] if per_replica else rows
        want = j_ops.pbit_sweep_int_op(*jax_int_args(d, rr, r), impl="ref")
        assert_bitwise([g[r] for g in got], want)


def test_int_field_and_neighbor_sums_match_jax():
    d = int_inputs(3, (5, 4, 3), multibit=True)
    rng = d["rng"]
    h = rng.normal(0, 1, (5, 4, 3)).astype(np.float32)
    w6 = [rng.normal(0, 1, (5, 4, 3)).astype(np.float32) for _ in range(6)]
    jh = tuple(jnp.asarray(x) for x in d["halos"])
    th = tuple(T(x) for x in d["halos"])
    assert_bitwise([t_ref.int_field_ref(T(d["m"]), T(d["h_q"]),
                                        [T(w) for w in d["w6_q"]], th)],
                   [j_ref.int_field_ref(jnp.asarray(d["m"]),
                                        jnp.asarray(d["h_q"]),
                                        [jnp.asarray(w) for w in d["w6_q"]],
                                        jh)])
    assert_bitwise([t_ref.neighbor_sums_ref(T(d["m"]), T(h),
                                            [T(w) for w in w6], th)],
                   [j_ref.neighbor_sums_ref(jnp.asarray(d["m"]),
                                            jnp.asarray(h),
                                            [jnp.asarray(w) for w in w6],
                                            jh)])


# -- bit-plane sweep -------------------------------------------------------------

def bp_rows(d, R, S, per_lane):
    return d["rng"].integers(0, 3, size=(S, R)).astype(np.int32) \
        if per_lane else np.array([1, 0, 2, 2][:S], np.int32)


# The interpreted Pallas word kernel unrolls lanes x sweeps x colors x LUT
# width, so its cases keep R and S small; wider cases go to the oracle.
@pytest.mark.parametrize("shape,R,per_lane,S", [
    ((6, 4, 4), 3, False, 2), ((4, 4, 4), 5, True, 2),
    ((4, 3, 3), 34, True, 1)])
def test_bitplane_sweep_plain_matches_pallas_interpret(shape, R, per_lane,
                                                       S):
    """W=1 against the one-word Pallas kernel, W=2 against the op's word
    loop over it, both in interpret mode, and against the jnp oracle."""
    d = bitplane_inputs(4, shape, R)
    rows = bp_rows(d, R, S, per_lane)
    jargs = bp_args(d, rows, jnp.asarray)
    if d["W"] == 1:
        jrows = jnp.asarray(rows if per_lane else
                            np.broadcast_to(rows[:, None], (S, R)))
        want = j_bp_sweep(jargs[0][0], jargs[1], jrows, jargs[3][:, 0],
                          *jargs[4:7], tuple(h[0] for h in jargs[7]),
                          jargs[8], interpret=True)
        want = (want[0][None],) + tuple(want[1:])
    else:
        want = j_ops.pbit_bitplane_sweep_op(*jargs, impl="interpret")
    got = t_ops.pbit_bitplane_sweep_op(*bp_args(d, rows, T))
    assert_bitwise(got, want)
    assert_bitwise(got, j_ref.pbit_bitplane_sweep_ref(*jargs))
    assert int(N(got[2]).sum()) > 0


@pytest.mark.parametrize("shape,R,per_lane", [
    ((4, 4, 4), 32, False), ((6, 4, 4), 20, True), ((4, 3, 3), 64, False),
    ((4, 3, 3), 40, True)])
def test_bitplane_sweep_plain_matches_jax_oracle(shape, R, per_lane):
    """Full, partial and two-word lane counts against the jnp oracle."""
    d = bitplane_inputs(5, shape, R)
    rows = bp_rows(d, R, 4, per_lane)
    got = t_ops.pbit_bitplane_sweep_op(*bp_args(d, rows, T))
    assert_bitwise(got, j_ops.pbit_bitplane_sweep_op(
        *bp_args(d, rows, jnp.asarray), impl="ref"))
    assert int(N(got[2]).min()) > 0


@pytest.mark.parametrize("R", [7, 33])
def test_bitplane_lanes_equal_int8_replicas(R):
    """Lane (w, b) of the plain word sweep is int8 replica w*32+b of the
    plain int8 sweep, spins, LFSR and flips."""
    d = bitplane_inputs(5, (4, 4, 3), R)
    rows = d["rng"].integers(0, 3, size=(3, R)).astype(np.int32)
    mw, s, fl = t_ref.pbit_bitplane_sweep_ref(*bp_args(d, rows, T))
    halos = tuple(t_pack.unpack_lanes(T(h), R) for h in d["halos_w"])
    m = t_pack.unpack_lanes(T(d["mw"]), R)
    m8, s8, fl8 = t_ref.pbit_brick_sweep_int_ref(
        m, T(d["s"]), T(rows), T(d["masks"]), T(d["h_q"]),
        tuple(T(w) for w in d["w6_q"]), halos, T(d["lut"]))
    assert_bitwise([t_pack.unpack_lanes(mw, R), s, fl], [m8, s8, fl8])


def test_bitplane_ones_count_matches_jax():
    d = bitplane_inputs(6, (5, 4, 3), 32)
    args = lambda conv: (conv(d["mw"][0]),  # noqa: E731
                         tuple(conv(x) for x in d["signs6"]),
                         tuple(conv(x) for x in d["nz6"]),
                         tuple(conv(h[0]) for h in d["halos_w"]))
    want = j_ref.bitplane_ones_count_ref(*args(jnp.asarray))
    got = t_ref.bitplane_ones_count_ref(*args(lambda a: u32_to_i64(T(a))))
    assert_bitwise([i64_to_u32(g) for g in got], want)


# -- energy --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 4, 4), (16, 8, 8), (6, 3, 5)])
@pytest.mark.parametrize("pm_j", [True, False])
def test_energy_plain_matches_pallas_interpret(shape, pm_j):
    m, active, h, w6, halos = energy_inputs(7, shape, pm_j)
    jargs = (jnp.asarray(m), jnp.asarray(active), jnp.asarray(h),
             tuple(jnp.asarray(w) for w in w6),
             tuple(jnp.asarray(x) for x in halos))
    want = [j_brick_energy(*jargs, interpret=True),
            j_ref.brick_energy_ref(*jargs)]
    got = t_ops.brick_energy_op(T(m), T(active), T(h),
                                tuple(T(w) for w in w6),
                                tuple(T(x) for x in halos))
    assert got.dtype == torch.float32 and got.dim() == 0
    for w in want:
        if pm_j:
            assert float(got) == float(w)
        else:
            np.testing.assert_allclose(float(got), float(w), rtol=1e-6)


def test_energy_replica_batch_matches_per_replica():
    m, active, h, w6, halos = energy_inputs(8, (5, 4, 6), True, R=4)
    got = t_ref.brick_energy_ref(T(m), T(active), T(h),
                                 tuple(T(w) for w in w6),
                                 tuple(T(x) for x in halos))
    assert got.shape == (4,)
    for r in range(4):
        want = j_ref.brick_energy_ref(
            jnp.asarray(m[r]), jnp.asarray(active), jnp.asarray(h),
            tuple(jnp.asarray(w) for w in w6),
            tuple(jnp.asarray(x[r]) for x in halos))
        assert float(got[r]) == float(want)


# -- dispatch ------------------------------------------------------------------

def test_wrappers_run_plain_on_cpu_without_counting():
    d = int_inputs(9, (4, 4, 4), R=2)
    rows = np.array([0, 1], np.int32)
    _build.reset_launch_counts()
    got = pbit_brick_sweep_int(*torch_int_args(d, rows))
    want = t_ref.pbit_brick_sweep_int_ref(*torch_int_args(d, rows))
    assert_bitwise(got, want)
    b = bitplane_inputs(9, (4, 4, 4), 3)
    assert_bitwise(pbit_bitplane_sweep(*bp_args(b, rows, T)),
                   t_ref.pbit_bitplane_sweep_ref(*bp_args(b, rows, T)))
    m, active, h, w6, halos = energy_inputs(9, (4, 4, 4), True)
    e_args = (T(m), T(active), T(h), tuple(T(w) for w in w6),
              tuple(T(x) for x in halos))
    assert float(brick_energy(*e_args)) == float(t_ref.brick_energy_ref(
        *e_args))
    assert set(_build.launch_counts.values()) == {0}


def test_impl_selection_and_guards():
    assert t_ops.resolve_impl("auto", on_cuda=False) == "ref"
    assert t_ops.resolve_impl("auto", on_cuda=True) == "cuda"
    assert t_ops.resolve_impl("ref", on_cuda=True) == "ref"
    with pytest.raises(ValueError, match="CUDA device"):
        t_ops.resolve_impl("cuda", on_cuda=False)
    with pytest.raises(ValueError, match="unknown impl"):
        t_ops.resolve_impl("pallas", on_cuda=False)
    d = int_inputs(10, (4, 4, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        t_ops.pbit_sweep_int_op(*torch_int_args(d, np.zeros(1, np.int32)),
                                impl="cuda")
    m, active, h, w6, halos = energy_inputs(10, (4, 4, 4), True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_ops.brick_energy_op(T(m), T(active), T(h), [T(w) for w in w6],
                              [T(x) for x in halos], bx=2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pbit_brick_sweep_int(torch.zeros(2, 2, 2, dtype=torch.int8,
                                         device="meta"),
                             *([None] * 7))


def test_wrapper_checks_raise_before_launch():
    """The argument checks the CUDA path runs before any launch."""
    t = torch.zeros((2, 3, 4), dtype=torch.int8)
    dev = t.device
    _build.require("m", t, torch.int8, (2, 3, 4), dev)
    with pytest.raises(TypeError, match="int8"):
        _build.require("m", t.to(torch.int16), torch.int8, (2, 3, 4), dev)
    with pytest.raises(ValueError, match="shape"):
        _build.require("m", t, torch.int8, (2, 4, 3), dev)
    with pytest.raises(ValueError, match="contiguous"):
        _build.require("m", t.transpose(0, 1), torch.int8, (3, 2, 4), dev)
    assert halo_shapes(2, 3, 4, 5) == [(2, 4, 5), (2, 4, 5), (2, 3, 5),
                                       (2, 3, 5), (2, 3, 4), (2, 3, 4)]
