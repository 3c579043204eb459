"""Residual-energy analysis: power-law exponents, bootstrap CIs, collapse.

The paper fits rho_E(t) ~ t^(-kappa_f) in log-log over the decaying window
and reports 95% bootstrap confidence intervals over 10 instances x 10 runs,
identically across all platforms and timing settings (Methods).  Port of
``repro.core.analysis`` (host numpy, the same operations).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["fit_kappa", "bootstrap_ci", "bootstrap_kappa", "time_to_target",
           "eta_from_sync", "KappaFit"]


@dataclasses.dataclass(frozen=True)
class KappaFit:
    kappa: float          # decay exponent (positive = decaying)
    intercept: float      # log10 rho at t=1
    r2: float
    window: Tuple[int, int]


def fit_kappa(t: np.ndarray, rho: np.ndarray,
              window: Optional[Tuple[float, float]] = None,
              floor: float = 1e-12) -> KappaFit:
    """Least-squares log-log fit of rho ~ t^-kappa.

    ``window`` restricts to t in [lo, hi]; points with rho <= floor are
    dropped (residual energy can hit exactly zero on small instances).
    """
    t = np.asarray(t, dtype=np.float64)
    rho = np.asarray(rho, dtype=np.float64)
    m = (t > 0) & (rho > floor)
    if window is not None:
        m &= (t >= window[0]) & (t <= window[1])
    if m.sum() < 2:
        return KappaFit(kappa=np.nan, intercept=np.nan, r2=np.nan,
                        window=(0, 0))
    x, y = np.log10(t[m]), np.log10(rho[m])
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, res, *_ = np.linalg.lstsq(A, y, rcond=None)
    slope, icpt = coef
    ss_tot = ((y - y.mean()) ** 2).sum()
    ss_res = ((y - A @ coef) ** 2).sum()
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return KappaFit(kappa=-float(slope), intercept=float(icpt), r2=float(r2),
                    window=(int(t[m].min()), int(t[m].max())))


def bootstrap_ci(samples: np.ndarray, stat=np.mean, n_boot: int = 1000,
                 alpha: float = 0.05, seed: int = 0) -> Tuple[float, float, float]:
    """(point, lo, hi) percentile bootstrap CI over the leading axis."""
    samples = np.asarray(samples)
    rng = np.random.default_rng(seed)
    point = float(stat(samples, axis=0).mean()) if samples.ndim > 1 \
        else float(stat(samples))
    n = samples.shape[0]
    stats = np.empty(n_boot)
    for b in range(n_boot):
        pick = rng.integers(0, n, size=n)
        s = stat(samples[pick], axis=0)
        stats[b] = np.mean(s)
    lo, hi = np.percentile(stats, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return point, float(lo), float(hi)


def bootstrap_kappa(t: np.ndarray, rho_runs: np.ndarray,
                    window: Optional[Tuple[float, float]] = None,
                    n_boot: int = 500, alpha: float = 0.05,
                    seed: int = 0) -> Tuple[float, float, float]:
    """Bootstrap kappa_f over runs: rho_runs (runs, T) resampled with
    replacement; kappa fit on the resampled mean trace (paper protocol:
    instances x runs pooled on the leading axis)."""
    rho_runs = np.asarray(rho_runs, dtype=np.float64)
    rng = np.random.default_rng(seed)
    point = fit_kappa(t, rho_runs.mean(axis=0), window).kappa
    n = rho_runs.shape[0]
    ks = np.empty(n_boot)
    for b in range(n_boot):
        pick = rng.integers(0, n, size=n)
        ks[b] = fit_kappa(t, rho_runs[pick].mean(axis=0), window).kappa
    lo, hi = np.percentile(ks, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return float(point), float(lo), float(hi)


def time_to_target(t: np.ndarray, rho: np.ndarray, target: float) -> float:
    """First sweep count at which the mean trace reaches rho <= target
    (log-linear interpolation; inf if never)."""
    t = np.asarray(t, dtype=np.float64)
    rho = np.asarray(rho, dtype=np.float64)
    below = np.nonzero(rho <= target)[0]
    if len(below) == 0:
        return float("inf")
    i = below[0]
    if i == 0:
        return float(t[0])
    # interpolate in log-log
    x0, x1 = np.log(t[i - 1]), np.log(t[i])
    y0, y1 = np.log(max(rho[i - 1], 1e-300)), np.log(max(rho[i], 1e-300))
    if y1 == y0:
        return float(t[i])
    f = (np.log(target) - y0) / (y1 - y0)
    return float(np.exp(x0 + f * (x1 - x0)))


def eta_from_sync(sync_every, n_color: int, c_max: float) -> float:
    """Map the simulator's staleness control to the paper's eta axis.

    One boundary exchange per S sweeps corresponds to
    f_comm/f_p-bit = 2*N_color*C_max / S evaluated at the Eq.-2 equality:
    sync_every = 1 sits exactly at the threshold eta = 2*N_color*C_max, and
    'phase' sync (refresh every color phase) sits N_color x above it.
    """
    thr = 2.0 * n_color * c_max
    if sync_every == "phase":
        return thr * n_color
    if sync_every is None:
        return 0.0
    return thr / float(sync_every)
