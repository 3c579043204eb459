"""Int8 error-feedback gradient all-reduce (beyond-paper distributed
trick); port of ``repro.train.compression``.

Mirrors the paper's thesis — stochastic iterative optimization tolerates
low-precision/stale communication — on the training side: gradients are
blockwise-int8 quantized before crossing links, and the quantization error
is fed back into the next step (EF-SGD), which preserves convergence.

Wire format per tensor: int8 codes + one f32 scale per 128 block = ~26% of
f32 traffic.  The collective is an all-gather of the quantized shards
followed by a local dequant-mean (overflow-safe).  Where the replicas
live follows the port's mesh convention: over a process group each rank
holds its own gradients and ``all_gather`` is the wire; with no group the
replicas are stacked on a leading axis in this process and the stack is
what would have crossed it.
"""

from __future__ import annotations

import torch

from .optimizer import q8_decode, q8_encode
from .train_step import _axis_group
from .tree import tree_flatten, tree_leaves, tree_map

__all__ = ["ef_init", "ef_compressed_psum", "make_ef_allreduce"]


def ef_init(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _gather(x, group):
    """(K, ...) of every replica's ``x``: an ``all_gather`` over
    ``group``, or ``x`` itself when it already stacks them (no group)."""
    if group is None:
        return x
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _compressed_mean_block(x, group):
    """Per-replica x -> mean over the replicas via the int8 wire."""
    q, s = q8_encode(x)
    qg = _gather(q, group)                            # (K, ..., blocks, 128)
    sg = _gather(s, group)                            # (K, ..., blocks)
    dec = qg.float() * sg[..., None]
    mean_blocks = dec.mean(dim=0)                     # (..., blocks, 128)
    *lead, L = x.shape if group is not None else x.shape[1:]
    avg = mean_blocks.reshape(*lead, -1)[..., :L]
    return avg if group is not None else avg.expand_as(x).contiguous()


def ef_compressed_psum(grads, err, group=None):
    """(grads, err) -> (averaged grads, new err).  ``group``: the process
    group of the replicas, this rank's tensors given; ``None``: every
    leaf stacks the replicas on its leading axis."""
    g_l, unflatten = tree_flatten(grads)
    avgs, errs = [], []
    for g, e in zip(g_l, tree_leaves(err)):
        g32 = g.float() + e
        q, s = q8_encode(g32)
        local_dec = q8_decode(q, s, g32.shape)
        errs.append(g32 - local_dec)                  # error feedback
        avgs.append(_compressed_mean_block(g32, group))   # int8 + scales
    return unflatten(avgs), unflatten(errs)


def make_ef_allreduce(mesh, axis_name: str = "data"):
    """The compressed data-parallel gradient mean over ``axis_name``.

    Takes replica-laid-out grads + error state (a leading axis: R in one
    process, 1 on a rank) and returns the averaged grads (equal content,
    still laid out per replica) and the per-replica error state."""
    group = _axis_group(mesh, axis_name)

    def block(grads, err):
        if group is None:
            return ef_compressed_psum(grads, err, None)
        g1 = tree_map(lambda x: x[0], grads)
        e1 = tree_map(lambda x: x[0], err)
        avg, new_e = ef_compressed_psum(g1, e1, group)
        return (tree_map(lambda x: x[None], avg),
                tree_map(lambda x: x[None], new_e))

    return block
