"""The port's residual-energy analysis: power-law fits, bootstrap,
time-to-target, eta.

The port of ``tests/test_analysis.py``, case by case, on the CPU.  Every
case also holds the port's numbers to the reference's on the same inputs
(numpy, from a seed): both are host numpy, so they agree exactly.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import analysis as jan
from repro_torch.core.analysis import (bootstrap_ci, bootstrap_kappa,
                                       eta_from_sync, fit_kappa,
                                       time_to_target)


def same_fit(f, *args, **kw):
    """The port's fit equals the reference's on the same inputs."""
    assert dataclasses.asdict(f) == dataclasses.asdict(
        jan.fit_kappa(*args, **kw))


def test_fit_kappa_recovers_exponent():
    t = np.geomspace(1, 1e5, 60)
    for kappa in (0.1, 0.27, 0.5):
        rho = 2.0 * t ** -kappa
        f = fit_kappa(t, rho)
        assert abs(f.kappa - kappa) < 1e-6
        assert f.r2 > 0.999999
        same_fit(f, t, rho)


def test_fit_kappa_window_and_noise():
    rng = np.random.default_rng(0)
    t = np.geomspace(1, 1e5, 80)
    rho = 3.0 * t ** -0.27 * np.exp(rng.normal(0, 0.05, 80))
    f = fit_kappa(t, rho, window=(10, 1e5))
    assert abs(f.kappa - 0.27) < 0.03
    same_fit(f, t, rho, window=(10, 1e5))


def test_fit_kappa_handles_zeros():
    t = np.asarray([1, 10, 100, 1000])
    rho = np.asarray([1.0, 0.1, 0.0, 0.0])
    f = fit_kappa(t, rho)
    assert np.isfinite(f.kappa)
    same_fit(f, t, rho)


def test_bootstrap_ci_covers_mean():
    rng = np.random.default_rng(1)
    x = rng.normal(5.0, 1.0, size=200)
    point, lo, hi = bootstrap_ci(x, seed=0)
    assert lo < 5.0 < hi
    assert hi - lo < 0.6
    assert (point, lo, hi) == tuple(jan.bootstrap_ci(x, seed=0))


def test_bootstrap_kappa():
    rng = np.random.default_rng(2)
    t = np.geomspace(1, 1e4, 40)
    runs = np.stack([2.0 * t ** -0.25 * np.exp(rng.normal(0, 0.05, 40))
                     for _ in range(20)])
    point, lo, hi = bootstrap_kappa(t, runs, seed=0)
    assert lo < 0.25 < hi
    assert abs(point - 0.25) < 0.02
    assert (point, lo, hi) == tuple(jan.bootstrap_kappa(t, runs, seed=0))


def test_time_to_target_interpolation():
    t = np.geomspace(1, 1e6, 100)
    rho = 1.0 * t ** -0.5
    # rho = 0.01 at t = 1e4
    ttt = time_to_target(t, rho, 0.01)
    assert abs(np.log10(ttt) - 4) < 0.05
    assert time_to_target(t, rho, 1e-9) == float("inf")
    assert ttt == jan.time_to_target(t, rho, 0.01)


def test_eta_from_sync_ordering():
    """More frequent exchange => larger eta; threshold at S=1."""
    thr = 2 * 3 * 50.8
    assert eta_from_sync(1, 3, 50.8) == pytest.approx(thr)
    assert eta_from_sync("phase", 3, 50.8) > eta_from_sync(1, 3, 50.8)
    assert eta_from_sync(10, 3, 50.8) < eta_from_sync(1, 3, 50.8)
    assert eta_from_sync(None, 3, 50.8) == 0.0
    for s in (1, "phase", 10, None):
        assert eta_from_sync(s, 3, 50.8) == jan.eta_from_sync(s, 3, 50.8)
