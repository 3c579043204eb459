"""Host-side state snapshots for resumable anneals; port of
``repro.core.snapshot``.

A snapshot is the state with every tensor leaf pulled to an owned numpy
copy (uint32 stays uint32), so it pickles; ``restore_state`` pushes the
leaves back as tensors.  Leaves are walked through dataclasses, tuples,
lists and dicts.  The serving layer's checkpoint spool
(``repro_torch.serve.spool``) persists records through
:func:`write_snapshot_file` (atomic: temp file, fsync, ``os.replace``),
named by :func:`snapshot_digest`, their sha1.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile

import numpy as np
import torch

from .bits import u32_from_numpy, u32_to_numpy

__all__ = ["snapshot_state", "restore_state", "snapshot_nbytes",
           "snapshot_digest", "write_snapshot_file", "load_snapshot_file"]


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


def _leaves(x, out):
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        out.append(x)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _leaves(getattr(x, f.name), out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    return out


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


def snapshot_nbytes(snapshot) -> int:
    """Total host bytes held by a snapshot (pool and queue accounting)."""
    return sum(int(x.nbytes) for x in _leaves(snapshot, [])
               if isinstance(x, (np.ndarray, np.generic)))


def snapshot_digest(obj) -> str:
    """sha1 content address of a snapshot or record (bytes are hashed as
    they are; anything else is pickled first)."""
    blob = obj if isinstance(obj, bytes) else \
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return hashlib.sha1(blob).hexdigest()


def write_snapshot_file(path: str, obj) -> str:
    """Durably write a snapshot or record to ``path``: the bytes land in a
    temp file of the same directory, are fsynced, and replace ``path`` in
    one ``os.replace``, so a crash never leaves a torn file there.
    Returns the content digest."""
    blob = obj if isinstance(obj, bytes) else \
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return snapshot_digest(blob)


def load_snapshot_file(path: str):
    """Read back a record written by :func:`write_snapshot_file`."""
    with open(path, "rb") as f:
        return pickle.load(f)
