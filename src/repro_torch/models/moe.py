"""Mixture-of-experts FFN: top-k routing, sort-based capacity dispatch,
optional shared experts (DeepSeekMoE-style fine-grained + shared); port of
``repro.models.moe``'s one-device path.

Dispatch is token-local (sort by expert id into an (E, C, d) buffer).
Over-capacity tokens are dropped (standard GShard/Switch semantics,
capacity_factor 1.25 by default).  The reference's ``shard_map`` path
under a multi-device mesh (``_moe_fwd_dist``) is not ported: one device
runs the local path, which is all the reference runs there too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .layers import _einsum, init_mlp, mlp_fwd, normal, silu

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
    """x (B, S, D) -> (out, aux_loss)."""
    return _moe_fwd_local(p, x, top_k=top_k, capacity_factor=capacity_factor)


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
