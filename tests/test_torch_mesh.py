"""The brick-partitioned lattice: the port's mesh engine against the JAX
reference on forced host devices.

One reference subprocess (``XLA_FLAGS`` forcing 8 host devices, as
``tests/test_dist.py`` runs its meshes) runs every case of ``CASES`` and
writes its initial and final states, record-point energies and flip
totals to npz files; the port then runs each case on the CPU with a
one-process mesh and is held to them: bitwise on int8 and bit-plane
(spins, LFSR states, all six halo stacks including the -1 outer faces,
per-replica flips, energies), and on f32 with LFSR states and halos of the
initial state bitwise and energies and flips within 0.5%.  Cheaper checks
follow: the (1,1,1) mesh against no mesh, the energy at init, the 1-bit
halo packing, the divisibility check, the bit-plane layout cache, and the
ported ``EtaMeter``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import packing as j_pack
from repro_torch import make_engine as t_make
from repro_torch.core import commcost as t_commcost
from repro_torch.core.annealing import ArraySchedule, ea_schedule
from repro_torch.core.bricks import BrickState
from repro_torch.core.mesh import make_mesh
from repro_torch.core.packing import pack_pm1, pad_to_multiple, unpack_pm1
from repro_torch.interop import state_to_numpy
from repro_torch.kernels import pbit_bitplane
from repro_torch.obs.timing import EtaMeter, exchanges_per_sweep

SRC = Path(__file__).resolve().parents[1] / "src"
AXES = ("x", "y", "z")
SWEEPS, POINTS = 16, [8, 16]
FIELDS = ("m", "s", "sweep", "flips")

# name: (L, mesh shape, precision, R, sync_every, bitpack_halos, fused)
CASES = {
    "x2-int8-s1": (6, (2, 1, 1), "int8", 3, 1, True, True),
    "y2-int8-s4-unpacked": (6, (1, 2, 1), "int8", 3, 4, False, True),
    "z2-int8-per-phase": (6, (1, 1, 2), "int8", 2, 4, True, False),
    "xyz-int8-s4-L8": (8, (2, 2, 2), "int8", 3, 4, True, True),
    "xyz-int8-s1-unpacked-per-phase": (6, (2, 2, 2), "int8", 2, 1, False,
                                       False),
    "x2-bitplane5-s4": (6, (2, 1, 1), "bitplane", 5, 4, True, True),
    "z2-bitplane40-s1": (6, (1, 1, 2), "bitplane", 40, 1, True, True),
    "y2-bitplane5-s4-unpacked": (6, (1, 2, 1), "bitplane", 5, 4, False,
                                 True),
    "xyz-bitplane5-s1": (6, (2, 2, 2), "bitplane", 5, 1, True, True),
    "xyz-bitplane40-s4": (6, (2, 2, 2), "bitplane", 40, 4, True, True),
    "y2-f32-s1": (6, (1, 2, 1), "f32", 2, 1, True, True),
    "xyz-f32-s4-unpacked": (6, (2, 2, 2), "f32", 2, 4, False, True),
    "xyz-f32-s1-per-phase": (6, (2, 2, 2), "f32", 2, 1, True, False),
}
SEED, INIT_SEED = 1, 3

REFERENCE = """
import json, sys, warnings
import numpy as np, jax
from jax.sharding import Mesh
from repro.core.annealing import ea_schedule
from repro.engines.registry import make_engine

out, cases = sys.argv[1], json.loads(sys.argv[2])
devs = jax.devices()

def fields(st, tag):
    d = {f"{tag}_{f}": np.asarray(getattr(st, f))
         for f in ("m", "s", "sweep", "flips")}
    for i, h in enumerate(st.halos):
        d[f"{tag}_halo{i}"] = np.asarray(h)
    return d

for name, (L, shape, prec, R, sync, bp, fused) in cases.items():
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(devs[:n]).reshape(shape), ("x", "y", "z"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        h = make_engine("lattice", L=L, seed=%(seed)d, replicas=R,
                        precision=prec, impl="ref", mesh=mesh,
                        dim_axes=("x", "y", "z"), bitpack_halos=bp,
                        fused=fused)
    st0 = h.init_state(seed=%(init_seed)d)
    st, rec = h.run_recorded(st0, ea_schedule(%(sweeps)d), %(points)r,
                             sync_every=sync)
    np.savez(f"{out}/{name}.npz", energies=np.asarray(rec.energies),
             total_flips=np.asarray(rec.flips),
             spins=np.asarray(h.global_spins(st)),
             e0=np.asarray(h.energy(st0)), **fields(st0, "init"),
             **fields(st, "final"))
""" % dict(seed=SEED, init_seed=INIT_SEED, sweeps=SWEEPS, points=POINTS)


def run_reference(code: str, args, devices: int = 8, timeout: int = 600):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code), *args],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
    run_reference(REFERENCE, [str(out), json.dumps(CASES)])
    return out


def mesh_engine(L, shape, prec, R, bp=True, fused=True, seed=SEED):
    return t_make("lattice", L=L, seed=seed, replicas=R, precision=prec,
                  mesh=make_mesh(shape, AXES), dim_axes=AXES,
                  bitpack_halos=bp, fused=fused, device="cpu")


def assert_state(ref, tag, st, f32=False):
    got = state_to_numpy(st)
    fields = ("s", "sweep") if f32 else FIELDS
    for f in fields:
        want = ref[f"{tag}_{f}"]
        assert got[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got[f], want, err_msg=f"{tag} {f}")
    if f32 and tag == "final":
        return
    for i, h in enumerate(got["halos"]):
        want = ref[f"{tag}_halo{i}"]
        assert h.dtype == want.dtype and h.shape == want.shape
        np.testing.assert_array_equal(h, want, err_msg=f"{tag} halo {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_jax_forced_devices(reference, name):
    L, shape, prec, R, sync, bp, fused = CASES[name]
    ref = np.load(reference / f"{name}.npz")
    h = mesh_engine(L, shape, prec, R, bp, fused)
    assert h.kernel_path == ("bitplane" if prec == "bitplane" else
                             "fused" if fused else "per_phase")
    st0 = h.init_state(seed=INIT_SEED)
    assert isinstance(st0, BrickState)
    assert st0.m.shape[0] == int(np.prod(shape))
    assert_state(ref, "init", st0)
    np.testing.assert_array_equal(h.energy(st0).numpy(), ref["e0"])
    st, rec = h.run_recorded(st0, ea_schedule(SWEEPS), POINTS,
                             sync_every=sync)
    if prec == "f32":
        assert_state(ref, "final", st, f32=True)
        np.testing.assert_allclose(rec.energies.numpy(), ref["energies"],
                                   rtol=0.005)
        np.testing.assert_allclose(state_to_numpy(st)["flips"],
                                   ref["final_flips"], rtol=0.005)
        assert abs(rec.flips - int(ref["total_flips"])) <= \
            0.005 * int(ref["total_flips"])
        return
    assert_state(ref, "final", st)
    np.testing.assert_array_equal(rec.energies.numpy(), ref["energies"])
    assert rec.flips == int(ref["total_flips"]) > 0
    np.testing.assert_array_equal(h.global_spins(st).numpy(), ref["spins"])
    if shape[0] > 1 and prec == "int8":
        # the outer x faces: -1 through the 1-bit wire, 0 without it
        xlo = ref["final_halo0"]
        assert (xlo[:, 0] == (-1 if bp else 0)).all()


def test_mesh_111_equals_no_mesh_bitwise():
    for prec, R in (("int8", 3), ("bitplane", 5), ("f32", 2)):
        a = t_make("lattice", L=5, seed=2, replicas=R, precision=prec,
                   device="cpu")
        b = mesh_engine(5, (1, 1, 1), prec, R, seed=2)
        sa, ra = a.run_recorded(a.init_state(seed=4), ea_schedule(12),
                                [4, 12], sync_every=4)
        sb, rb = b.run_recorded(b.init_state(seed=4), ea_schedule(12),
                                [4, 12], sync_every=4)
        x, y = state_to_numpy(sa), state_to_numpy(sb)
        for f in FIELDS:
            np.testing.assert_array_equal(x[f], y[f])
        for p, q in zip(x["halos"], y["halos"]):
            np.testing.assert_array_equal(p, q)
        assert torch.equal(ra.energies, rb.energies) and ra.flips == rb.flips


def test_dim_axes_map_mesh_axes_to_lattice_dims():
    """A 2-D mesh named ("row", "col") with dim_axes ("col", None, "row")
    cuts x by "col" and z by "row": the same bricks as a (2, 1, 2) mesh
    over ("x", "y", "z"), bitwise."""
    a = t_make("lattice", L=6, seed=SEED, replicas=3, precision="int8",
               mesh=make_mesh((2, 2), ("row", "col")),
               dim_axes=("col", None, "row"), device="cpu")
    b = mesh_engine(6, (2, 1, 2), "int8", 3)
    assert a.eng.nb == b.eng.nb == (2, 1, 2)
    sa, ra = a.run_recorded(a.init_state(seed=1), ea_schedule(8), [4, 8],
                            sync_every=2)
    sb, rb = b.run_recorded(b.init_state(seed=1), ea_schedule(8), [4, 8],
                            sync_every=2)
    x, y = state_to_numpy(sa), state_to_numpy(sb)
    for f in FIELDS:
        np.testing.assert_array_equal(x[f], y[f])
    for p, q in zip(x["halos"], y["halos"]):
        np.testing.assert_array_equal(p, q)
    assert torch.equal(ra.energies, rb.energies) and ra.flips == rb.flips


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 2), (2, 2, 2)])
def test_mesh_energy_at_init_equals_one_brick(shape):
    """A fresh exchange makes every halo current, so the energy of the
    same spins does not depend on the partition."""
    for prec in ("int8", "bitplane"):
        one = t_make("lattice", L=6, seed=SEED, replicas=4, precision=prec,
                     device="cpu")
        e1 = one.energy(one.init_state(seed=5))
        h = mesh_engine(6, shape, prec, 4)
        assert torch.equal(h.energy(h.init_state(seed=5)), e1)


@pytest.mark.parametrize("n", [8, 13, 64, 100])
def test_pm1_packing_equals_the_reference(n):
    rng = np.random.default_rng(n)
    x = rng.choice(np.array([-1, 1], np.int8), size=(3, n))
    npad = pad_to_multiple(n, 8)
    assert npad == j_pack.pad_to_multiple(n, 8)
    xp = np.pad(x, ((0, 0), (0, npad - n)), constant_values=1)
    got = pack_pm1(torch.from_numpy(xp))
    want = np.asarray(j_pack.pack_pm1(xp))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unpack_pm1(got, n).numpy(),
                                  np.asarray(j_pack.unpack_pm1(want, n)))
    # zero bytes (an open chain's outer face) unpack to -1
    zeros = np.zeros((2, npad // 8), np.uint8)
    np.testing.assert_array_equal(
        unpack_pm1(torch.from_numpy(zeros), n).numpy(),
        np.asarray(j_pack.unpack_pm1(zeros, n)))
    with pytest.raises(ValueError):
        pack_pm1(torch.ones(3, 12, dtype=torch.int8))


def test_mesh_that_does_not_divide_raises():
    with pytest.raises(ValueError, match="not divisible"):
        mesh_engine(5, (2, 1, 1), "int8", 1)
    with pytest.raises(ValueError, match="dim_axes"):
        t_make("lattice", L=4, mesh=make_mesh((2,), ("x",)), device="cpu")
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("x",))


def test_bitplane_layout_built_once_per_brick(monkeypatch):
    """The color-major layout cache holds every live brick's mask set: at
    K=8 each brick's layout is built once and found on every later call
    (the CUDA sweep asks for it once per call)."""
    h = mesh_engine(8, (2, 2, 2), "bitplane", 40)
    builds = []
    real = pbit_bitplane._build_layout
    monkeypatch.setattr(pbit_bitplane, "_build_layout",
                        lambda *a: builds.append(1) or real(*a))
    bricks = h.eng._bricks
    for _ in range(3):
        for b in bricks:
            lay = pbit_bitplane.color_layout(b.masks_w, b.signs6_w, b.nz6_w,
                                             b.base_w)
            assert lay.mask_cm.shape == (2, 64)
    assert len(builds) == len(bricks) == 8


def test_exchange_fn_is_cached_and_dropped_on_restore():
    h = mesh_engine(6, (2, 1, 2), "int8", 2)
    st = h.init_state(seed=1)
    fn = h.eng.boundary_exchange_fn()
    assert h.eng.boundary_exchange_fn() is fn
    halos = fn(st)
    for p, q in zip(halos, st.halos):
        assert torch.equal(p, q)
    st2 = h.restore(h.snapshot(st))
    assert h.eng.boundary_exchange_fn() is not fn
    for f in ("m", "s"):
        assert torch.equal(getattr(st2, f), getattr(st, f))


# -- EtaMeter -----------------------------------------------------------------

def test_exchanges_per_sweep():
    assert exchanges_per_sweep("phase", 3) == 3.0
    assert exchanges_per_sweep(None, 3) == 1.0
    assert exchanges_per_sweep(4, 3) == 0.25
    with pytest.raises(ValueError):
        exchanges_per_sweep(0, 3)


def test_eta_meter_fake_clock_vs_commcost():
    """The reference's hand-computable case: t_ex = 0.02 s, a chunk of 8
    sweeps in 0.84 s at sync_every=4 -> 2 exchanges -> t_pbit = 0.1 s,
    eta = 5.0, threshold 2 * n_color * c_max = 16, margin 0.3125."""
    m = EtaMeter(n_color=2, c_max=4, sync_every=4)
    assert np.isnan(m.t_exchange_s) and np.isnan(m.eta)
    m.record_exchange(0.2, count=10)
    m.record_chunk(sweeps=8, seconds=0.84)
    assert m.t_exchange_s == pytest.approx(0.02)
    assert m.t_pbit_sweep_s == pytest.approx(0.1)
    assert m.f_comm_hz == pytest.approx(50.0)
    assert m.f_pbit_hz == pytest.approx(10.0)
    assert m.eta == pytest.approx(5.0)
    assert m.eta_threshold == t_commcost.eta_threshold(2, 4) == 16.0
    r = m.report()
    assert r["measured_eta"] == pytest.approx(5.0)
    assert r["margin"] == pytest.approx(5.0 / 16.0)
    assert r["behaves_unpartitioned"] is False
    assert r["chunks_recorded"] == 1 and r["sweeps_recorded"] == 8
    assert r["exchanges_attributed"] == pytest.approx(2.0)

    fast = EtaMeter(n_color=2, c_max=4, sync_every=4)
    fast.record_exchange(0.2, count=10000)
    fast.record_chunk(sweeps=8, seconds=0.84)
    rf = fast.report()
    assert rf["margin"] >= 1.0 and rf["behaves_unpartitioned"] is True

    bad = EtaMeter(n_color=2, c_max=4, sync_every=1)
    bad.record_exchange(10.0, count=10)
    bad.record_chunk(sweeps=8, seconds=0.8)
    assert bad.t_pbit_sweep_s == pytest.approx(0.1 * 0.8 / 8)


def test_eta_meter_hooks_into_a_mesh_cursor():
    """attach() installs the meter on the recorded cursor's chunk_timer
    and accumulates every chunk of a real anneal on a (2,1,2) mesh; the
    exchange probe adds f_comm, and the lattice has no C_max (NaN
    threshold), as in the reference."""
    h = mesh_engine(6, (2, 1, 2), "int8", 2)
    st = h.init_state(seed=0)
    cur = h.start_recorded(st, ArraySchedule(np.full(64, 2.0, np.float32)),
                           [8, 16],
                           sync_every=4)
    m = EtaMeter(n_color=2, sync_every=4).attach(cur)
    assert cur.chunk_timer == m.on_chunk
    while not cur.done:
        cur.advance(1)
    fn = h.eng.boundary_exchange_fn()
    t_ex = m.measure_exchange(lambda: fn(cur.state), reps=4, warmup=1)
    r = m.report()
    assert r["chunks_recorded"] == 2 and r["sweeps_recorded"] == 16
    assert r["exchanges_attributed"] == pytest.approx(4.0)
    assert r["exchanges_timed"] == 4 and t_ex > 0
    assert np.isfinite(r["f_pbit_hz"]) and np.isfinite(r["f_comm_hz"])
    assert np.isfinite(r["measured_eta"]) and np.isnan(r["eta_threshold"])


def test_brick_state_snapshot_is_global():
    h = mesh_engine(6, (2, 2, 1), "bitplane", 40)
    st = h.init_state(seed=2)
    snap = h.snapshot(st)
    assert snap.m.shape == (2, 6, 6, 6) and snap.halos[0].shape == \
        (2, 2, 6, 6)
    assert dataclasses.is_dataclass(snap)
