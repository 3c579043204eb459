"""Mixture-of-experts FFN: top-k routing, sort-based capacity dispatch,
optional shared experts (DeepSeekMoE-style fine-grained + shared); port of
``repro.models.moe``.

Dispatch is token-local (sort by expert id into an (E, C, d) buffer), so no
all-to-all is required when expert weights are tensor-parallel over the
'model' mesh axis and tokens stay on 'data'.  Over-capacity tokens are
dropped (standard GShard/Switch semantics, capacity_factor 1.25 by
default).  Under an ambient mesh (``layers.set_mesh``) with DTensor
activations, ``_moe_fwd_dist`` is the reference's ``shard_map`` dispatch
written with ``to_local``: each data rank routes its own tokens against
its F shard of the expert weights, the partial sums are all-reduced over
'model' and the auxiliary loss is averaged over the batch axes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.rules import mesh_sizes
from .layers import (_einsum, _is_dtensor, ambient_mesh, init_mlp, mlp_fwd,
                     normal, silu)

__all__ = ["init_moe", "moe_fwd"]


def init_moe(rng, d_model: int, d_ff_expert: int, n_experts: int,
             n_shared: int = 0, d_ff_shared: Optional[int] = None,
             dtype=torch.float32):
    """``rng``: a ``np.random.Generator``; the router stays f32."""
    sc_in = 1.0 / np.sqrt(d_model)
    sc_out = 1.0 / np.sqrt(d_ff_expert)
    p = {
        "router": normal(rng, (d_model, n_experts), 0.02, torch.float32),
        "wi": normal(rng, (n_experts, d_model, d_ff_expert), sc_in, dtype),
        "wg": normal(rng, (n_experts, d_model, d_ff_expert), sc_in, dtype),
        "wo": normal(rng, (n_experts, d_ff_expert, d_model), sc_out, dtype),
    }
    if n_shared > 0:
        dsh = d_ff_shared if d_ff_shared is not None else n_shared * d_ff_expert
        p["shared"] = init_mlp(rng, d_model, dsh, dtype)
    return p


def moe_fwd(p, x, *, top_k: int, capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out, aux_loss).

    Under a multi-device ambient mesh this dispatches token-locally: the
    argsort-based capacity dispatch is not a sharded global op, so each
    rank routes its own tokens against the F-sharded expert weights and
    one all-reduce over 'model' replaces the dense-FFN TP reduction."""
    dist = _dist_plan(x)
    if dist is not None:
        return _moe_fwd_dist(p, x, top_k=top_k,
                             capacity_factor=capacity_factor, plan=dist)
    return _moe_fwd_local(p, x, top_k=top_k, capacity_factor=capacity_factor)


def _dist_plan(x):
    """(mesh, batch_axes, model_axis?) if a usable ambient mesh is present
    and ``x`` is a DTensor on it."""
    mesh = ambient_mesh()
    if mesh is None or not _is_dtensor(x):
        return None
    sizes = mesh_sizes(mesh)
    baxes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    if not baxes:
        return None
    nb = int(np.prod([sizes[a] for a in baxes]))
    if x.shape[0] % nb != 0:
        return None
    m_ax = "model" if sizes.get("model", 1) > 1 else None
    return (mesh, baxes, m_ax)


def _moe_fwd_dist(p, x, *, top_k, capacity_factor, plan):
    """The reference's ``shard_map`` block on this rank's pieces.

    Each operand is laid out as the reference's ``in_specs`` lay it out
    and taken with ``to_local``; the gradient placements said there make
    autograd sum what the reference's transpose sums: over 'model' the
    partial F-contractions (when F is split), over the batch axes the
    per-rank routing.  The output is a Partial over 'model' turned
    Replicate (the all-reduce of the F-contraction partial sums); the
    auxiliary loss is each rank's share of the batch-axes mean, summed."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, baxes, m_ax = plan
    names = mesh.mesh_dim_names
    sizes = mesh_sizes(mesh)
    F = p["wi"].shape[-1]
    f_ok = m_ax is not None and F % sizes[m_ax] == 0
    has_shared = "shared" in p
    s_ok = has_shared and f_ok and \
        p["shared"]["wi"]["w"].shape[-1] % sizes[m_ax] == 0
    # over 'model' a gradient is a sum of F-partials when F is split, else
    # every model rank holds the whole of it
    m_grad = Partial() if f_ok else Replicate()

    def take(t, fwd, grad):
        if not _is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * len(names),
                                   run_check=False)
        return t.redistribute(mesh, fwd).to_local(grad_placements=grad)

    def lay(f):
        return [f(n) for n in names]

    def weight(t, dim, split):
        """An expert or shared weight, its dim ``dim`` over 'model' when
        ``split``."""
        fwd = lay(lambda n: Shard(dim) if split and n == m_ax
                  else Replicate())
        grad = lay(lambda n: Partial() if n in baxes else
                   (Shard(dim) if split and n == m_ax else
                    (m_grad if n == m_ax else Replicate())))
        return take(t, fwd, grad)

    xb = lay(lambda n: Shard(0) if n in baxes else Replicate())
    xl = take(x, xb, lay(lambda n: Shard(0) if n in baxes else
                         (m_grad if n == m_ax else Replicate())))
    pp = {"router": take(p["router"], lay(lambda n: Replicate()),
                         lay(lambda n: Partial() if n in baxes else
                             (m_grad if n == m_ax else Replicate()))),
          "wi": weight(p["wi"], 2, f_ok), "wg": weight(p["wg"], 2, f_ok),
          "wo": weight(p["wo"], 1, f_ok)}
    if has_shared:
        sh = p["shared"]
        pp["shared"] = {"wi": {"w": weight(sh["wi"]["w"], 1, s_ok)},
                        "wg": {"w": weight(sh["wg"]["w"], 1, s_ok)},
                        "wo": {"w": weight(sh["wo"]["w"], 0, s_ok)}}
    out, aux = _moe_fwd_local(pp, xl, top_k=top_k,
                              capacity_factor=capacity_factor)
    # F-contraction partial sums: a Partial over 'model', all-reduced
    out = DTensor.from_local(
        out, mesh, lay(lambda n: Shard(0) if n in baxes else
                       (m_grad if n == m_ax else Replicate())),
        run_check=False, shape=x.shape, stride=x.stride())
    out = out.redistribute(mesh, xb)
    # aux: the mean over the batch axes, as a sum of each rank's share
    # (model ranks hold the same aux; with F split they share it too)
    share = int(np.prod([sizes[a] for a in baxes])) * \
        (sizes[m_ax] if f_ok else 1)
    aux = DTensor.from_local(
        aux / share, mesh, lay(lambda n: Partial() if n in baxes or
                               (f_ok and n == m_ax) else Replicate()),
        run_check=False, shape=(), stride=())
    return out, aux.redistribute(mesh, lay(lambda n: Replicate()))


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort; ``torch.topk`` promises no tie order)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _dispatch(probs, top_k: int, capacity_factor: float) -> dict:
    """The routing integers and weights of ``_moe_fwd_local``: each
    token's top-k experts, the expert-sorted (stable) assignments, their
    slot in the (E, cap) buffer or the dump slot E * cap beyond capacity.
    No host sync: ``cap`` comes from the shapes (host float64, as the
    reference's)."""
    T, E = probs.shape
    dev = probs.device
    topv, topi = _top_k(probs, top_k)                          # (T, k)
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    TK = T * top_k
    eid = topi.reshape(-1)                                     # (TK,)
    src = torch.arange(T, device=dev).repeat_interleave(top_k)
    wgt = topv.reshape(-1)
    order = torch.argsort(eid, stable=True)
    eid_s, src_s, wgt_s = eid[order], src[order], wgt[order]
    counts = torch.zeros((E,), dtype=torch.int32, device=dev).index_add_(
        0, eid_s, torch.ones_like(eid_s, dtype=torch.int32))
    offsets = torch.cumsum(counts, dim=0) - counts             # expert starts
    pos = torch.arange(TK, device=dev) - offsets[eid_s]
    cap = int(np.ceil(TK / E * capacity_factor / 8.0) * 8)
    keep = pos < cap
    dest = torch.where(keep, eid_s * cap + pos, E * cap)       # dump slot
    return {"topi": topi, "eid_s": eid_s, "src_s": src_s,
            "wgt_s": wgt_s, "counts": counts, "cap": cap, "keep": keep,
            "dest": dest}


def _moe_fwd_local(p, x, *, top_k: int, capacity_factor: float = 1.25
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    E = p["router"].shape[1]
    T = B * S
    xf = x.reshape(T, D)

    logits = xf.float() @ p["router"]                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    r = _dispatch(probs, top_k, capacity_factor)
    cap, keep, dest = r["cap"], r["keep"], r["dest"]

    # load-balancing auxiliary (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, r["topi"].reshape(-1),
        torch.ones(T * top_k, dtype=torch.float32, device=x.device)) \
        / (T * top_k)
    aux = E * (me * ce).sum()

    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, dest, xf[r["src_s"]])
    xe = buf[:-1].reshape(E, cap, D)

    h = silu(_einsum("ecd,edf->ecf", xe, p["wg"].to(x.dtype))) \
        * _einsum("ecd,edf->ecf", xe, p["wi"].to(x.dtype))
    ye = _einsum("ecf,efd->ecd", h, p["wo"].to(x.dtype))

    flat = ye.reshape(E * cap, D)
    contrib = torch.where(keep[:, None],
                          flat[torch.where(keep, dest, 0)]
                          * r["wgt_s"][:, None].to(x.dtype), 0)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(
        0, r["src_s"], contrib)

    if "shared" in p:
        out = out + mlp_fwd(p["shared"], xf)
    return out.reshape(B, S, D), aux
