"""AdamW with fp32 or int8 block-quantized moments; port of
``repro.train.optimizer``.

The int8 variant stores m and v as int8 with per-128-block absmax scales
(8-bit-Adam style) — 2.5 bytes/param of optimizer state instead of 8.

The arithmetic is the reference's in f32, step for step: the schedule and
the bias corrections are f32 tensors (``step.astype(f32)``, ``b1 ** t`` on
an f32 array), ``torch.round`` rounds half to even as ``jnp.round`` does,
and the gradients leave ``clip_by_global_norm`` in f32.  The update is
functional: it returns new tensors and changes none it is given.  Leaves
that are DTensors (``sharding.rules``) are updated shard by shard where
every operand shares the parameter's placements (the f32 moments); the
int8 codes block the last dimension by 128, which need not fall on a
shard boundary, so an int8 leaf is gathered, updated and cut again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from .tree import tree_leaves, tree_map

__all__ = ["AdamW", "OptState", "q8_encode", "q8_decode",
           "clip_by_global_norm"]

_BLOCK = 128


def _pad_len(n: int) -> int:
    return ((n + _BLOCK - 1) // _BLOCK) * _BLOCK


def q8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., L) f32 -> codes (..., ceil(L/128), 128) int8 + scales
    (..., ceil(L/128)) f32.  Blocking only the last dim preserves the
    leading structure, so quantized optimizer state shards with the same
    spec as its parameter (see sharding.rules.opt_shardings)."""
    *lead, L = x.shape
    pad = _pad_len(L) - L
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*lead, -1, _BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def q8_decode(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    dec = q.float() * scale[..., None]
    *lead, L = shape
    return dec.reshape(*lead, -1)[..., :L].reshape(tuple(shape))


@dataclasses.dataclass
class OptState:
    step: torch.Tensor
    m: Any
    v: Any
    m_scale: Any   # None (fp32 mode) or per-block scales
    v_scale: Any


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in f32;
    the norm before scaling)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in leaves))
    factor = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * factor, grads), gn


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    int8_state: bool = False
    warmup: int = 100

    def init(self, params) -> OptState:
        """Zero moments (plain tensors on each parameter's device; place
        them with ``sharding.rules.train_state_shardings``)."""
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        step = torch.zeros((), dtype=torch.int32, device=dev)
        if not self.int8_state:
            return OptState(step=step, m=tree_map(_zeros_f32, params),
                            v=tree_map(_zeros_f32, params),
                            m_scale=None, v_scale=None)
        enc = lambda p: q8_encode(_zeros_f32(p))  # noqa: E731
        return OptState(step=step,
                        m=tree_map(lambda p: enc(p)[0], params),
                        v=tree_map(lambda p: enc(p)[0], params),
                        m_scale=tree_map(lambda p: enc(p)[1], params),
                        v_scale=tree_map(lambda p: enc(p)[1], params))

    def _schedule(self, step):
        warm = torch.clamp(step.float() / max(self.warmup, 1), max=1.0)
        return self.lr * warm

    def _upd(self, lr, bc1, bc2, g, p, m, v, msc=None, vsc=None):
        g = g.float()
        if self.int8_state:
            m = q8_decode(m, msc, g.shape)
            # v is stored in sqrt domain (better resolution near 0 —
            # linear int8 lets v flush to 0 in blocks m doesn't, which
            # explodes m/sqrt(v))
            v = q8_decode(v, vsc, g.shape) ** 2
        m = self.b1 * m + (1 - self.b1) * g
        v = self.b2 * v + (1 - self.b2) * g * g
        mh = m / bc1
        vh = v / bc2
        dp = mh / (torch.sqrt(vh) + self.eps)
        if self.int8_state:
            # guard residual quantization-flush outliers
            dp = torch.clamp(dp, -10.0, 10.0)
        dp = dp + self.weight_decay * p.float()
        newp = (p.float() - lr * dp).to(p.dtype)
        if self.int8_state:
            mq, ms = q8_encode(m)
            vq, vs = q8_encode(torch.sqrt(v))
            return newp, mq, vq, ms, vs
        return newp, m, v

    def _upd_leaf(self, lr, bc1, bc2, g, p, *state):
        """``_upd`` on plain tensors, or on DTensors: shard by shard where
        every operand has the parameter's shape and placements (the f32
        moments), else gathered and cut to each output's placements."""
        if not _is_dtensor(p):
            return self._upd(lr, bc1, bc2, g, p, *state)
        from torch.distributed.tensor import DTensor, distribute_tensor
        mesh, pl = p.device_mesh, p.placements
        g = g.redistribute(mesh, pl)
        if all(s.placements == pl and s.shape == p.shape for s in state):
            out = self._upd(lr, bc1, bc2, g.to_local(), p.to_local(),
                            *(s.to_local() for s in state))
            return tuple(DTensor.from_local(x, mesh, pl, run_check=False,
                                            shape=p.shape, stride=p.stride())
                         for x in out)
        out = self._upd(lr, bc1, bc2, g.full_tensor(), p.full_tensor(),
                        *(s.full_tensor() for s in state))
        like = (p,) + tuple(state)
        return tuple(distribute_tensor(x, mesh, t.placements,
                                       src_data_rank=None)
                     for x, t in zip(out, like))

    def update(self, grads, state: OptState, params):
        step = state.step + 1
        # a placed step is a replicated DTensor: its value on this rank
        local = step.to_local() if _is_dtensor(step) else step
        lr = self._schedule(local)
        t = local.float()
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        g_l, p_l = tree_leaves(grads), tree_leaves(params)
        fields = ("m", "v", "m_scale", "v_scale") if self.int8_state \
            else ("m", "v")
        st_l = [tree_leaves(getattr(state, f)) for f in fields]
        with torch.no_grad():
            outs = [self._upd_leaf(lr, bc1, bc2, g, p, *st)
                    for g, p, *st in zip(g_l, p_l, *st_l)]
        cols = list(zip(*outs)) if outs else [()] * (1 + len(fields))
        rebuild = lambda tree, col: tree_map(  # noqa: E731
            lambda _, x: x, tree, list(col))
        newp = rebuild(params, cols[0])
        if self.int8_state:
            # _upd returns (p, mq, vq, ms, vs)
            return newp, OptState(
                step=step, m=rebuild(state.m, cols[1]),
                v=rebuild(state.v, cols[2]),
                m_scale=rebuild(state.m_scale, cols[3]),
                v_scale=rebuild(state.v_scale, cols[4]))
        return newp, OptState(step=step, m=rebuild(state.m, cols[1]),
                              v=rebuild(state.v, cols[2]),
                              m_scale=None, v_scale=None)
