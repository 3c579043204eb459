"""The L=100 golden values of ``chip_smoke.py``, recomputed from JAX.

``chip_smoke.py`` holds the card to the JAX reference at full width through
constants: energies, per-replica flips and sha256 digests of the spins and
LFSR states after 16 sweeps (int8), and energies and flips at the f32
default, whose LFSR digest is the int8 one.  This test recomputes them with the JAX
package on the CPU, so they cannot drift from the reference.
"""

import hashlib
import importlib.util
import warnings
from pathlib import Path

import numpy as np

from repro.core.annealing import ea_schedule
from repro.engines.registry import make_engine

ROOT = Path(__file__).resolve().parents[1]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(precision, R):
    smoke = chip_smoke()
    with warnings.catch_warnings():
        # the TPU VMEM model warns about a 100^3 brick; irrelevant here
        warnings.simplefilter("ignore", RuntimeWarning)
        h = make_engine("lattice", L=smoke.L, seed=smoke.SEED, replicas=R,
                        precision=precision, impl="ref")
    st, rec = h.run_recorded(h.init_state(seed=smoke.SEED), ea_schedule(16),
                             [8, 16], sync_every=smoke.SYNC)
    return smoke.GOLDEN, st, np.asarray(rec.energies)


def test_int8_golden_values_match_jax():
    golden, st, energies = run_jax("int8", 2)
    assert energies.tolist() == golden["energies"]
    assert np.asarray(st.flips).tolist() == golden["flips"]
    m = np.asarray(st.m)
    s = np.asarray(st.s)
    assert m.shape == (2, 100, 100, 100) and m.dtype == np.int8
    assert s.dtype == np.uint32
    assert hashlib.sha256(m.tobytes()).hexdigest() == golden["m_sha256"]
    assert hashlib.sha256(s.tobytes()).hexdigest() == golden["s_sha256"]


def test_bitplane_golden_lanes_match_jax():
    golden, st, energies = run_jax("bitplane", 32)
    assert energies[:, :2].tolist() == golden["energies"]
    assert np.asarray(st.flips)[:2].tolist() == golden["flips"]


def test_f32_golden_values_match_jax():
    """The default precision: its energies and flips (held to 0.5% on the
    card, whose tanh is not XLA's) and its LFSR states, which do not depend
    on the precision."""
    smoke = chip_smoke()
    golden, st, energies = run_jax("f32", 2)
    assert energies.tolist() == smoke.GOLDEN_F32["energies"]
    assert np.asarray(st.flips).tolist() == smoke.GOLDEN_F32["flips"]
    s = np.asarray(st.s)
    assert hashlib.sha256(s.tobytes()).hexdigest() == golden["s_sha256"]
