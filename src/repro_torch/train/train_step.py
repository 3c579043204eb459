"""Train-step builders: the standard step, microbatched accumulation, and
the eta-style periodic-sync local-SGD step (the paper's staleness rule as
a training feature — see DESIGN.md §4); port of ``repro.train.train_step``.

Gradients come from ``torch.autograd`` over the parameter leaves; the
steps run eagerly and return new states (the one given is not changed).
A state whose parameters are DTensors (``sharding.rules.
train_state_shardings``) takes the sharded step: the model runs on the
DTensors under ``implicit_replication`` (tensors it makes itself, such as
positions and masks, count as replicated), each gradient is laid out as
its parameter, and the update runs shard by shard.

Local SGD follows the port's mesh convention (``core.mesh.make_mesh``,
as ``dsim_dist``): with no process group all R replicas run in this
process, their state stacked on a leading replica axis as the reference
lays it out; over a process group each rank holds one replica (a leading
axis of 1, the reference's per-device block) and the average is an
``all_reduce`` of the sum divided by R.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .optimizer import AdamW, OptState, clip_by_global_norm
from .tree import tree_flatten, tree_map

__all__ = ["TrainState", "make_train_step", "make_local_sgd_step",
           "sync_budget"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: OptState


def _sharded(leaves) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in leaves)


def _plain(x):
    """A DTensor scalar (loss, norm) as a plain tensor."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _scope(leaves):
    if not _sharded(leaves):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _value_and_grad(model, leaves, unflatten, batch):
    """(loss, gradient leaves) of ``model.loss(params, batch, train=True)``;
    a DTensor's gradient in its parameter's placements, an unused leaf's
    zeros (as ``jax.grad`` gives)."""
    xs = [p.detach().requires_grad_() for p in leaves]
    loss = model.loss(unflatten(xs), batch, train=True)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    out = []
    for p, g in zip(xs, grads):
        if g is None:
            g = torch.zeros_like(p)
        elif hasattr(p, "placements") and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        out.append(g)
    return loss.detach(), out


def make_train_step(model, opt: AdamW, grad_accum: int = 1,
                    clip: float = 1.0):
    """The standard step.

    grad_accum > 1: the batch must arrive PRE-SPLIT with a leading
    (grad_accum,) dim (on a mesh, the batch sharding on dim 1); the
    microbatch gradients are summed in f32 and averaged, as the
    reference's scan does."""

    def step(state: TrainState, batch):
        leaves, unflatten = tree_flatten(state.params)
        with _scope(leaves):
            if grad_accum == 1:
                loss, grads = _value_and_grad(model, leaves, unflatten,
                                              batch)
            else:
                gsum = [torch.zeros_like(p, dtype=torch.float32)
                        for p in leaves]
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                for i in range(grad_accum):
                    mb = {k: v[i] for k, v in batch.items()}
                    loss_i, g = _value_and_grad(model, leaves, unflatten, mb)
                    for a, b in zip(gsum, g):   # in place: the sum's memory
                        a.add_(b)
                    del g
                    lsum = lsum + loss_i
                grads = [g.div_(grad_accum) for g in gsum]
                del gsum
                loss = lsum / grad_accum
            grads, gnorm = clip_by_global_norm(unflatten(grads), clip)
            params, opt2 = opt.update(grads, state.opt, state.params)
        metrics = {"loss": _plain(loss), "grad_norm": _plain(gnorm),
                   "step": opt2.step}
        return TrainState(params=params, opt=opt2), metrics

    return step


# ---------------------------------------------------------------------------
# eta-style local SGD (paper technique -> training)
# ---------------------------------------------------------------------------


def _axis_group(mesh, axis: str):
    """The process group of ``axis``, or None when every member of the
    mesh lives in this process."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return mesh.get_group(axis)
    if mesh.group is None:
        return None
    idle = [a for a, k in mesh.shape.items() if a != axis and k > 1]
    if idle:
        raise ValueError(f"over a process group the mesh may only have "
                         f"the {axis!r} axis above 1, got {mesh.shape}")
    return mesh.group


def _pmean(x, group, R: int):
    import torch.distributed as dist
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x / R


def make_local_sgd_step(model, opt: AdamW, mesh, replica_axis: str = "data",
                        sync_every: int = 1, clip: float = 1.0):
    """Replicas (one per member of ``mesh`` along ``replica_axis``) take
    ``sync_every`` local optimizer steps between parameter-averaging
    rounds — the direct analog of S local sweeps between boundary
    exchanges in the DSIM, with the same throughput/staleness trade
    governed by one ratio.

    State leaves carry a leading replica dimension (R in one process, 1
    on a rank).  Returns (outer_step, replicate_fn) where outer_step does
    sync_every local steps + one averaging round, and batch has leading
    dims (replicas, sync_every, local_batch, ...)."""
    from repro_torch.sharding.rules import mesh_sizes
    R = mesh_sizes(mesh)[replica_axis]
    group = _axis_group(mesh, replica_axis)

    def one(st: TrainState, b):
        leaves, unflatten = tree_flatten(st.params)
        loss, grads = _value_and_grad(model, leaves, unflatten, b)
        grads, _ = clip_by_global_norm(unflatten(grads), clip)
        params, opt2 = opt.update(grads, st.opt, st.params)
        return TrainState(params, opt2), loss

    def local_steps(st: TrainState, batches):
        losses = []
        for s in range(sync_every):
            st, loss = one(st, {k: v[s] for k, v in batches.items()})
            losses.append(loss)
        return st, torch.stack(losses).mean()

    def outer_step(state: TrainState, batches):
        if group is None:
            runs = [local_steps(tree_map(lambda x, r=r: x[r], state),
                                {k: v[r] for k, v in batches.items()})
                    for r in range(R)]
            avg = tree_map(lambda *xs: torch.stack(xs).sum(0) / R,
                           *[st.params for st, _ in runs])
            params = tree_map(lambda x: x[None].repeat(
                (R,) + (1,) * x.dim()), avg)
            opt_st = tree_map(lambda *xs: torch.stack(xs),
                              *[st.opt for st, _ in runs])
            loss = torch.stack([lo for _, lo in runs]).sum() / R
            return TrainState(params, opt_st), {"loss": loss}
        st, loss = local_steps(tree_map(lambda x: x[0], state),
                               {k: v[0] for k, v in batches.items()})
        with torch.no_grad():
            params = tree_map(lambda x: _pmean(x, group, R), st.params)
            loss = _pmean(loss, group, R)
        out = TrainState(params, st.opt)
        return tree_map(lambda x: x[None], out), {"loss": loss}

    def replicate(state: TrainState) -> TrainState:
        if group is None:
            return tree_map(lambda x: x[None].repeat((R,) + (1,) * x.dim()),
                            state)
        return tree_map(lambda x: x[None].clone(), state)

    return outer_step, replicate


def sync_budget(param_bytes: float, step_time_s: float, link_bw_Bps: float,
                overlap: float = 0.0) -> int:
    """Minimum sync period S so averaging traffic fits the link budget —
    the Eq.-2 design rule transcribed to training:

      paper:    f_p-bit <= f_comm / (2 N_color C_max)
      here:     step rate <= link_bw / (2 * param_bytes * (1-overlap)) * S

    i.e. S >= 2 * param_bytes * (1-overlap) / (link_bw * step_time).
    """
    s = 2.0 * param_bytes * (1.0 - overlap) / (link_bw_Bps * step_time_s)
    # the reference's jnp.ceil takes s as an f32
    return max(1, int(math.ceil(float(np.float32(s)))))
