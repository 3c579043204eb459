"""The port's f32 pipeline and per-phase kernels against the JAX package.

The f32 accept ``tanh(act) + r >= 0`` takes ``tanh`` from PyTorch here
and from XLA there; the two differ by a few ulp on some inputs, so a site
can be decided differently where ``tanh(act) + r`` lies within a few ulp
of 0.  Everything upstream of the tanh is held exactly: LFSR states
bitwise, fields exactly on +-J couplings (and to ``rtol=1e-6`` on
Gaussian ones).  Spins are held equal except at the sites that the JAX
side decides with ``|tanh(act) + r| < 1e-6`` (f64), and that count is
held to 1% of the sites.  The per-phase int8 kernel is held bitwise.
Engines are held statistically as ``tests/test_quantized.py`` holds int8
against f32: residual energy within 5%, flips within 10%.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.kernels.ref as j_ref
from repro.core import pbit as j_pbit
from repro.core.annealing import ea_schedule as j_ea_schedule
from repro.core.lattice import build_ea3d_lattice as j_build
from repro.engines.registry import make_engine as j_make
from repro.kernels.pbit_lattice import (pbit_brick_sweep as j_sweep,
                                        pbit_brick_update as j_update,
                                        pbit_brick_update_int as j_update_int)
from repro_torch import S41, make_engine as t_make
from repro_torch.core import pbit as t_pbit
from repro_torch.core.annealing import ea_schedule
from repro_torch.interop import (problem_from_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.lattice_energy import brick_energy
from repro_torch.kernels.pbit_lattice import (pbit_brick_update,
                                              pbit_brick_update_int)
from test_torch_cuda import (N, T, assert_bitwise, energy_inputs,
                             f32_inputs, int_inputs, torch_f32_args,
                             torch_int_args)

FMTS = {None: (None, None), "S41": (j_pbit.S41, S41)}
TIE = 1e-6          # |tanh(act) + r| below which a decision may differ


def jax_f32_args(d, betas, r=None):
    pick = (lambda a: a) if r is None else (lambda a: a[r])
    return (jnp.asarray(pick(d["m"])), jnp.asarray(pick(d["s"])),
            jnp.asarray(betas), jnp.asarray(d["masks"]),
            jnp.asarray(d["h"]), tuple(jnp.asarray(w) for w in d["w6"]),
            tuple(jnp.asarray(pick(h)) for h in d["halos"]))


def jax_near_ties(m, s, betas, masks, h, w6, halos, fmt):
    """Sites that some phase of the JAX f32 sweep decides with
    ``|tanh(act) + r| < TIE`` (f64), and the number of such decisions."""
    near = np.zeros(m.shape, bool)
    n = 0
    for beta in np.asarray(betas).reshape(-1):
        for mask in masks:
            field = j_ref.neighbor_sums_ref(m, h, w6, halos)
            r = j_pbit.lfsr_uniform(j_pbit.lfsr_next(s))
            act = j_pbit.quantize(jnp.float32(beta) * field, fmt)
            v = np.tanh(np.asarray(act, np.float64)) + np.asarray(r,
                                                                  np.float64)
            tie = (np.abs(v) < TIE) & (np.asarray(mask) != 0)
            near |= tie
            n += int(tie.sum())
            m, s = j_ref.pbit_brick_update_ref(m, s, beta, mask, h, w6,
                                               halos, fmt)
    return near, n


def assert_f32_matches_jax(got, want, near, n_near):
    """LFSR bitwise; spins equal except at near-tie sites; at most 1% of
    the sites near a tie."""
    assert_bitwise(got[1:2], want[1:2])
    differ = N(got[0]) != np.asarray(want[0])
    assert not (differ & ~near).any()
    assert n_near <= 0.01 * near.size
    if not differ.any() and len(got) > 2:
        assert_bitwise(got[2:], want[2:])


# -- host pieces -----------------------------------------------------------------

@pytest.mark.parametrize("fmt_name", ["S41", "S43", "S46"])
def test_quantize_rounds_half_to_even_like_jnp(fmt_name):
    jf, tf = getattr(j_pbit, fmt_name), getattr(t_pbit, fmt_name)
    k = np.arange(-80, 81, dtype=np.float32)
    # the half-way points k/2 steps, their neighbours, and the saturation
    x = np.concatenate([(k + 0.5) * np.float32(tf.step),
                        k * np.float32(tf.step),
                        np.nextafter((k + 0.5) * np.float32(tf.step),
                                     np.float32(np.inf)),
                        np.array([-1e3, 1e3, 0.25, -0.25], np.float32)])
    want = np.asarray(j_pbit.quantize(jnp.asarray(x), jf))
    got = t_pbit.quantize(torch.from_numpy(x), tf).numpy()
    np.testing.assert_array_equal(got, want)
    xt = torch.from_numpy(x)
    assert t_pbit.quantize(xt, None) is xt
    # round half to even, not half away from zero
    assert float(t_pbit.quantize(torch.tensor([0.25]), t_pbit.S41)) == 0.0


def test_lfsr_and_pbit_update_match_jax():
    rng = np.random.default_rng(20)
    s = rng.integers(1, 2 ** 32, size=4096, dtype=np.uint32)
    js, ts = jnp.asarray(s), T(s)
    for _ in range(3):
        js, ts = j_pbit.lfsr_next(js), t_pbit.lfsr_next(ts)
        assert ts.dtype == torch.uint32
        assert_bitwise([ts], [js])
        np.testing.assert_array_equal(t_pbit.lfsr_uniform(ts).numpy(),
                                      np.asarray(j_pbit.lfsr_uniform(js)))
    # int64-carried states step the same way
    np.testing.assert_array_equal(
        N(t_pbit.lfsr_next(ts.view(torch.int32).to(torch.int64)
                           & 0xFFFFFFFF)),
        np.asarray(j_pbit.lfsr_next(js)).astype(np.int64))
    field = rng.normal(0, 2, size=4096).astype(np.float32)
    u = np.array(j_pbit.lfsr_uniform(js))
    for jf, tf in FMTS.values():
        want = np.asarray(j_pbit.pbit_update(jnp.asarray(field), 0.7,
                                             jnp.asarray(u), jf))
        got = t_pbit.pbit_update(torch.from_numpy(field), 0.7,
                                 torch.from_numpy(u), tf).numpy()
        act = np.asarray(j_pbit.quantize(jnp.float32(0.7) * field, jf))
        tie = np.abs(np.tanh(act.astype(np.float64)) + u) < TIE
        assert got.dtype == np.int8 and not ((got != want) & ~tie).any()


# -- per-phase int8 (the reference's pbit_brick_update_int) ------------------------

@pytest.mark.parametrize("bx", [None, 2])
def test_int_update_plain_matches_pallas_interpret(bx):
    d = int_inputs(21, (4, 6, 8), multibit=True)
    m, s, _, masks, h_q, w6_q, halos, lut = torch_int_args(
        d, np.zeros(1, np.int32))
    jargs = (jnp.asarray(d["m"]), jnp.asarray(d["s"]), 2,
             jnp.asarray(d["masks"][1]), jnp.asarray(d["h_q"]),
             tuple(jnp.asarray(w) for w in d["w6_q"]),
             tuple(jnp.asarray(h) for h in d["halos"]),
             jnp.asarray(d["lut"]))
    want = j_update_int(*jargs, bx=bx, interpret=True)
    got = pbit_brick_update_int(m, s, 2, masks[1], h_q, w6_q, halos, lut,
                                bx=bx)
    assert_bitwise(got, want)
    assert_bitwise(got, j_ref.pbit_brick_update_int_ref(*jargs))
    assert (N(got[0]) != d["m"]).any()


def test_int_update_replica_batch_matches_jax_per_replica():
    R = 3
    d = int_inputs(22, (4, 6, 8), R=R)
    rows = np.array([2, 0, 1], np.int32)
    m, s, _, masks, h_q, w6_q, halos, lut = torch_int_args(
        d, np.zeros(1, np.int32))
    got = t_ops.pbit_update_int_op(m, s, T(rows), masks[0], h_q, w6_q,
                                   halos, lut)
    for r in range(R):
        want = j_ref.pbit_brick_update_int_ref(
            jnp.asarray(d["m"][r]), jnp.asarray(d["s"][r]), int(rows[r]),
            jnp.asarray(d["masks"][0]), jnp.asarray(d["h_q"]),
            tuple(jnp.asarray(w) for w in d["w6_q"]),
            tuple(jnp.asarray(h[r]) for h in d["halos"]),
            jnp.asarray(d["lut"]))
        assert_bitwise([g[r] for g in got], want)
    with pytest.raises(ValueError, match="not divisible by tile bx=3"):
        pbit_brick_update_int(m, s, 0, masks[0], h_q, w6_q, halos, lut,
                              bx=3)


# -- f32 (the reference's pbit_brick_update and pbit_brick_sweep) -------------------

@pytest.mark.parametrize("fmt", [None, "S41"])
@pytest.mark.parametrize("pm_j", [True, False])
def test_f32_fields_match_jax(pm_j, fmt):
    d = f32_inputs(23, (4, 6, 8), R=None, pm_j=pm_j)
    want = np.asarray(j_ref.neighbor_sums_ref(*jax_f32_args(d, 0)[:1],
                                              *jax_f32_args(d, 0)[4:]))
    got = t_ref.neighbor_sums_ref(T(d["m"]), T(d["h"]),
                                  [T(w) for w in d["w6"]],
                                  [T(h) for h in d["halos"]]).numpy()
    if pm_j:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    jf, tf = FMTS[fmt]
    beta = np.float32(1.3)
    np.testing.assert_array_equal(
        t_pbit.quantize(beta * torch.from_numpy(got), tf).numpy(),
        np.asarray(j_pbit.quantize(beta * jnp.asarray(got), jf)))


@pytest.mark.parametrize("bx", [None, 2])
@pytest.mark.parametrize("fmt", [None, "S41"])
@pytest.mark.parametrize("pm_j", [True, False])
def test_f32_update_plain_matches_pallas_interpret(pm_j, fmt, bx):
    d = f32_inputs(24, (4, 6, 8), pm_j=pm_j)
    jf, tf = FMTS[fmt]
    beta = np.float32(1.7)
    m, s, _, masks, h, w6, halos = jax_f32_args(d, 0)
    want = j_update(m, s, beta, masks[1], h, w6, halos, fmt=jf, bx=bx,
                    interpret=True)
    near, n = jax_near_ties(m, s, [beta], masks[1:], h, w6, halos, jf)
    tm, ts, _, tmasks, th, tw6, thalos = torch_f32_args(d, 0)
    got = pbit_brick_update(tm, ts, beta, tmasks[1], th, tw6, thalos,
                            fmt=tf, bx=bx)
    assert_f32_matches_jax(got, want, near, n)
    assert (N(got[0]) != d["m"]).any()


@pytest.mark.parametrize("fmt", [None, "S41"])
@pytest.mark.parametrize("pm_j", [True, False])
def test_f32_sweep_plain_matches_pallas_interpret(pm_j, fmt):
    d = f32_inputs(25, (4, 6, 8), pm_j=pm_j)
    jf, tf = FMTS[fmt]
    betas = np.array([0.6, 2.2, 1.1], np.float32)
    jargs = jax_f32_args(d, betas)
    want = j_sweep(*jargs, fmt=jf, interpret=True)
    near, n = jax_near_ties(*jargs, jf)
    got = t_ops.pbit_sweep_op(*torch_f32_args(d, betas), fmt=tf)
    assert_f32_matches_jax(got, want, near, n)
    assert_f32_matches_jax(got, j_ref.pbit_brick_sweep_ref(*jargs, fmt=jf),
                           near, n)
    assert int(got[2]) > 0


@pytest.mark.parametrize("fmt", [None, "S41"])
def test_f32_replica_batch_matches_jax_per_replica(fmt):
    """The replica-batched plain versions (the CUDA kernels' layout) with
    per-replica betas equal the JAX oracle run replica by replica."""
    R = 3
    d = f32_inputs(26, (4, 6, 8), R=R, pm_j=False)
    jf, tf = FMTS[fmt]
    betas = d["rng"].uniform(0.3, 3.0, size=(3, R)).astype(np.float32)
    got = t_ops.pbit_sweep_op(*torch_f32_args(d, betas), fmt=tf)
    one = t_ops.pbit_update_op(*torch_f32_args(d, betas[0])[:2],
                               T(betas[0]), T(d["masks"][0]), T(d["h"]),
                               [T(w) for w in d["w6"]],
                               [T(h) for h in d["halos"]], fmt=tf)
    for r in range(R):
        jargs = jax_f32_args(d, betas[:, r], r)
        near, n = jax_near_ties(*jargs, jf)
        assert_f32_matches_jax([g[r] for g in got],
                               j_ref.pbit_brick_sweep_ref(*jargs, fmt=jf),
                               near, n)
        m, s, _, masks, h, w6, halos = jargs
        near, n = jax_near_ties(m, s, betas[:1, r], masks[:1], h, w6, halos,
                                jf)
        assert_f32_matches_jax(
            [g[r] for g in one],
            j_ref.pbit_brick_update_ref(m, s, betas[0, r], masks[0], h, w6,
                                        halos, jf), near, n)


def test_energy_bx_is_checked_and_changes_nothing():
    m, active, h, w6, halos = energy_inputs(27, (4, 6, 8), False, R=2)
    args = (T(m), T(active), T(h), tuple(T(w) for w in w6),
            tuple(T(x) for x in halos))
    assert torch.equal(brick_energy(*args, bx=2), brick_energy(*args))
    assert torch.equal(t_ops.brick_energy_op(*args, bx=4),
                       t_ref.brick_energy_ref(*args))
    with pytest.raises(ValueError, match="not divisible by tile bx=3"):
        brick_energy(*args, bx=3)


# -- engines ------------------------------------------------------------------------

@pytest.mark.parametrize("prec,fmt", [("f32", None), ("f32", "S41"),
                                      ("int8", None)])
def test_engine_per_phase_equals_fused_bitwise(prec, fmt):
    """fused == fused=False == kernel_bx=2 on the port, L=8: spins, LFSR,
    halos, flips, energies."""
    runs = {}
    for kw in ({}, {"fused": False}, {"kernel_bx": 2}):
        h = t_make("lattice", L=8, seed=3, replicas=3, precision=prec,
                   fmt=FMTS[fmt][1], device="cpu", **kw)
        st, rec = h.run_recorded(h.init_state(seed=4), ea_schedule(24),
                                 [8, 24], sync_every=4)
        runs[h.kernel_path, h.fallback_reason] = (state_to_numpy(st), rec)
    assert list(runs) == [("fused", None), ("per_phase", None),
                          ("per_phase", "kernel_bx")]
    (a, ra), *rest = runs.values()
    for b, rb in rest:
        for f in ("m", "s", "sweep", "flips"):
            np.testing.assert_array_equal(a[f], b[f])
        for x, y in zip(a["halos"], b["halos"]):
            np.testing.assert_array_equal(x, y)
        assert torch.equal(ra.energies, rb.energies) and ra.flips == rb.flips
    assert ra.flips > 0


def test_engine_f32_matches_jax_trajectory():
    """The port's default (f32) engine against the JAX one at L=6, R=3,
    fmt None and S41, with a per-replica beta fan: LFSR states bitwise,
    spins equal except near ties (none at these seeds)."""
    for jf, tf in FMTS.values():
        jh = j_make("lattice", L=6, seed=1, replicas=3, impl="ref", fmt=jf)
        th = t_make("lattice", L=6, seed=1, replicas=3, fmt=tf,
                    device="cpu")
        assert th.precision == "f32" and th.kernel_path == "fused"
        fan = np.linspace(0.8, 1.2, 3, dtype=np.float32)[None] * \
            j_ea_schedule(32).beta_array()[:, None]
        jst, jrec = jh.eng.run_recorded_full(
            jh.init_state(seed=2), j_ea_schedule(32), [16, 32],
            sync_every=4, betas_R=fan)
        tst, trec = th.eng.run_recorded_full(
            th.init_state(seed=2), ea_schedule(32), [16, 32], sync_every=4,
            betas_R=fan)
        t = state_to_numpy(tst)
        np.testing.assert_array_equal(t["s"], np.asarray(jst.s))
        assert (t["m"] != np.asarray(jst.m)).mean() <= 0.01
        np.testing.assert_allclose(trec.energies.numpy(),
                                   np.asarray(jrec.energies), rtol=0.05)


def test_f32_statistically_matches_jax_f32_and_port_int8():
    """Same EA3D instance and schedule, R replicas per run (as
    ``tests/test_quantized.py``): mean annealed energy within 5% and
    aggregate flips within 10% of JAX f32 and of the port's int8."""
    R, SW = 6, 240
    jh = j_make("lattice", L=6, seed=7, impl="ref", replicas=R,
                precision="f32")
    _, rec = jh.run_recorded(jh.init_state(seed=1), j_ea_schedule(SW), [SW],
                             sync_every=4)
    ref = {"jax_f32": (float(np.asarray(rec.energies[-1]).mean()),
                       rec.flips)}
    for prec in ("f32", "int8"):
        th = t_make("lattice", L=6, seed=7, replicas=R, precision=prec,
                    device="cpu")
        _, rec = th.run_recorded(th.init_state(seed=1), ea_schedule(SW),
                                 [SW], sync_every=4)
        ref[prec] = (float(rec.energies[-1].mean()), rec.flips)
    e, fl = ref["f32"]
    assert e < 0
    for other in ("jax_f32", "int8"):
        e2, fl2 = ref[other]
        assert abs(e - e2) / abs(e2) < 0.05
        assert abs(fl - fl2) / fl2 < 0.10


def test_interop_f32_state_round_trips_and_carries_on():
    """A JAX f32 problem and mid-run state, passed across as numpy, round
    trip through the port unchanged and carry on like JAX's."""
    jp = j_build(5, seed=2)
    tp = problem_from_numpy(
        L=jp.L, dims=jp.dims, seed=jp.seed, n_colors=jp.n_colors,
        h=np.asarray(jp.h), w6=[np.asarray(w) for w in jp.w6],
        masks=np.asarray(jp.masks), active=np.asarray(jp.active),
        device="cpu")
    jh = j_make("lattice", lattice=jp, replicas=3, impl="ref")
    th = t_make("lattice", lattice=tp, replicas=3, device="cpu")
    jst, _ = jh.run_recorded(jh.init_state(seed=5), j_ea_schedule(16), [8],
                             sync_every=2)
    fields = {f: np.asarray(getattr(jst, f))
              for f in ("m", "s", "sweep", "flips")}
    fields["halos"] = tuple(np.asarray(h) for h in jst.halos)
    tst = state_from_numpy(**fields, device="cpu")
    back = state_to_numpy(tst)
    for f in ("m", "s", "sweep", "flips"):
        assert back[f].dtype == fields[f].dtype
        np.testing.assert_array_equal(back[f], fields[f])
    for x, y in zip(back["halos"], fields["halos"]):
        np.testing.assert_array_equal(x, y)
    assert float(th.energy(tst)[0]) == float(np.asarray(jh.energy(jst))[0])
    jst, jrec = jh.run_recorded(jst, j_ea_schedule(16), [8, 16],
                                sync_every=2)
    tst, trec = th.run_recorded(tst, ea_schedule(16), [8, 16], sync_every=2)
    t = state_to_numpy(tst)
    np.testing.assert_array_equal(t["s"], np.asarray(jst.s))
    assert (t["m"] != np.asarray(jst.m)).mean() <= 0.01
    np.testing.assert_allclose(trec.energies.numpy(),
                               np.asarray(jrec.energies), rtol=0.05)
