"""Host-side state snapshots for resumable anneals; port of
``repro.core.snapshot``'s ``snapshot_state`` / ``restore_state``.

A snapshot is the state with every tensor leaf pulled to an owned numpy
copy (uint32 stays uint32), so it pickles; ``restore_state`` pushes the
leaves back as tensors.  Leaves are walked through dataclasses, tuples,
lists and dicts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bits import u32_from_numpy, u32_to_numpy

__all__ = ["snapshot_state", "restore_state"]


def _map(fn, x):
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _map(fn, getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return x


def _to_host(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.uint32:
            return u32_to_numpy(t)
        return t.detach().cpu().numpy().copy()
    return np.array(t)


def _to_device(device):
    def fn(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            return u32_from_numpy(a, device)
        return torch.from_numpy(np.array(a)).to(device)
    return fn


def snapshot_state(state):
    """Tensor state -> structurally identical host state (numpy copies)."""
    return _map(_to_host, state)


def restore_state(snapshot, device="cpu"):
    """Host snapshot -> tensor state on ``device`` (dtypes preserved)."""
    return _map(_to_device(torch.device(device)), snapshot)
