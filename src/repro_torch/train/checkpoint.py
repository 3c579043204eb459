"""Fault-tolerant checkpointing with elastic resharding; port of
``repro.train.checkpoint``.

- Atomic: write to a temp dir, fsync, rename; a crash mid-save never
  corrupts the latest checkpoint.
- Elastic: arrays are saved in GLOBAL layout (a DTensor is gathered with
  ``full_tensor``), and ``restore`` places them onto whatever mesh the
  restarted job brings up.
- Async: ``save(..., blocking=False)`` snapshots to host then writes on a
  background thread, overlapping I/O with the next training steps.
- Retention: keeps the newest ``keep`` checkpoints.

The keys are the port's tree paths (``train.tree.tree_paths``: the
reference's ``keystr`` form, but the port's groups are lists, so a group
leaf is ``['groups'][g][b]...`` where the reference stacks it).  numpy has
no bf16, so a bf16 leaf is stored as its bits (an ``int16`` view) and the
manifest names its dtype; ``restore`` gives back the same bits.  Over a
process group every rank gathers and rank 0 writes.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .tree import tree_flatten, tree_map, tree_paths

__all__ = ["save", "restore", "latest_step", "wait_pending"]

_pending: list = []


def _host(x) -> tuple:
    """(numpy array, dtype name) of a leaf, gathered to the host."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    on_host = x.device.type == "cpu"
    x = x.detach().cpu()            # a copy unless it was on the host
    name = str(x.dtype).replace("torch.", "")
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return (x.numpy().copy() if on_host else x.numpy()), name


def _writer() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def save(path: str, step: int, tree: Any, meta: Optional[dict] = None,
         keep: int = 3, blocking: bool = True):
    """Save a tree of tensors under path/step_<N>/ atomically."""
    host, dtypes = {}, {}
    for key, leaf in tree_paths(tree):
        host[key], dtypes[key] = _host(leaf)
    if not _writer():
        return

    def write():
        final = os.path.join(path, f"step_{step:010d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {"step": int(step), "keys": sorted(host.keys()),
                    "dtypes": dtypes, "meta": meta or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(path, keep)

    if blocking:
        write()
    else:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _pending.append(t)


def wait_pending():
    while _pending:
        _pending.pop().join()


def _gc(path: str, keep: int):
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, stored: str, tmpl) -> torch.Tensor:
    """A stored array as a tensor of ``tmpl``'s dtype on its device."""
    t = torch.from_numpy(arr)
    if stored == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device=tmpl.device, dtype=tmpl.dtype)


def restore(path: str, template: Any, step: Optional[int] = None,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``template``; if ``shardings`` is a
    tree of ``sharding.rules.NamedSharding`` of the same structure, the
    tensors are placed onto that mesh as DTensors (elastic restart)."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        stored = json.load(f).get("dtypes", {})
    data = np.load(os.path.join(d, "arrays.npz"))
    _, unflatten = tree_flatten(template)
    leaves = []
    for key, tmpl in tree_paths(template):
        if key not in data:
            raise KeyError(f"checkpoint missing {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(tmpl.shape)}")
        leaves.append(_leaf(arr, stored.get(key, str(arr.dtype)), tmpl))
    tree = unflatten(leaves)
    if shardings is not None:
        from repro_torch.sharding.rules import device_put
        tree = tree_map(device_put, tree, shardings)
    return tree
