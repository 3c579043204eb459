"""Inverse-temperature (beta) schedules and their LUT row indices.

Port of ``repro.core.annealing`` (host numpy).  EA results anneal with
beta = 0.5, 1.0, ..., 5.0 and Pegasus/Zephyr/3SAT with beta = 0.5, 0.625,
..., 10 as staircases in sweep index; on the integer
paths a staircase becomes int32 row indices into the threshold LUT.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Schedule", "ArraySchedule", "ea_schedule", "sat_schedule",
           "geometric_schedule", "constant_schedule", "replica_beta_arrays",
           "beta_table", "beta_row_indices"]


class Schedule:
    """Sweep-indexed staircase of inverse temperatures."""

    def __init__(self, betas: np.ndarray, total_sweeps: int):
        betas = np.asarray(betas, dtype=np.float32)
        if len(betas) < 1:
            raise ValueError("need at least one beta")
        self.betas = betas
        self.total_sweeps = int(total_sweeps)
        # stage s covers sweeps [bounds[s], bounds[s+1])
        self.bounds = np.linspace(0, total_sweeps, len(betas) + 1).astype(np.int64)

    def beta_at(self, sweep) -> torch.Tensor:
        """f32 beta at a sweep index (an int or an integer tensor of any
        shape), on the sweep tensor's device or on the CPU."""
        sweep = torch.as_tensor(sweep)
        b = torch.as_tensor(self.bounds[1:-1], device=sweep.device)
        stage = torch.searchsorted(b, sweep.to(b.dtype), right=True)
        return torch.as_tensor(self.betas, device=sweep.device)[stage]

    def beta_array(self) -> np.ndarray:
        """Dense (total_sweeps,) beta staircase."""
        out = np.empty(self.total_sweeps, dtype=np.float32)
        for s, beta in enumerate(self.betas):
            out[self.bounds[s]:self.bounds[s + 1]] = beta
        return out

    def rescale(self, total_sweeps: int) -> "Schedule":
        return Schedule(self.betas, total_sweeps)


class ArraySchedule:
    """A precomputed dense (T, ...) per-sweep array presented as a
    Schedule; dtype is preserved, so int32 LUT row staircases and (T, R)
    per-replica fans ride the recording driver unchanged."""

    def __init__(self, values):
        self.values = np.asarray(values)
        if self.values.ndim < 1 or len(self.values) < 1:
            raise ValueError("need at least one scheduled sweep")
        self.total_sweeps = int(self.values.shape[0])

    def beta_array(self) -> np.ndarray:
        return self.values


def beta_table(betas) -> np.ndarray:
    """Sorted unique beta values of a staircase — the threshold LUT rows."""
    return np.unique(np.asarray(betas, np.float32))


def beta_row_indices(betas, table: np.ndarray) -> np.ndarray:
    """Map a beta staircase (any shape) to int32 row indices into ``table``;
    every value must appear in ``table`` exactly."""
    betas = np.asarray(betas, np.float32)
    table = np.asarray(table, np.float32)
    rows = np.searchsorted(table, betas)
    rows = np.clip(rows, 0, len(table) - 1)
    if not (table[rows] == betas).all():
        missing = np.unique(betas[table[rows] != betas])
        raise ValueError(f"betas {missing[:5]} not in the LUT beta table")
    return rows.astype(np.int32)


def replica_beta_arrays(schedule: Schedule, replicas: int,
                        spread: float = 0.0) -> np.ndarray:
    """Per-replica beta staircases, shape (total_sweeps, R): ``spread=0``
    replicates the schedule, ``spread>0`` scales replica r's betas by a
    geometric factor in [1-spread, 1+spread] (feed to ``betas_R=``)."""
    if replicas < 1:
        raise ValueError("replicas must be >= 1")
    if not 0.0 <= spread < 1.0:
        raise ValueError("spread must be in [0, 1)")
    base = schedule.beta_array()
    if spread == 0.0:
        return np.tile(base[:, None], (1, replicas)).astype(np.float32)
    factors = np.geomspace(1.0 - spread, 1.0 + spread, replicas)
    return (base[:, None] * factors[None, :]).astype(np.float32)


def ea_schedule(total_sweeps: int) -> Schedule:
    return Schedule(np.arange(0.5, 5.0 + 1e-6, 0.5), total_sweeps)


def sat_schedule(total_sweeps: int) -> Schedule:
    return Schedule(np.arange(0.5, 10.0 + 1e-6, 0.125), total_sweeps)


def geometric_schedule(beta0: float, beta1: float, stages: int,
                       total_sweeps: int) -> Schedule:
    return Schedule(np.geomspace(beta0, beta1, stages), total_sweeps)


def constant_schedule(beta: float, total_sweeps: int) -> Schedule:
    return Schedule(np.array([beta]), total_sweeps)
