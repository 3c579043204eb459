"""Shared transformer layers: norms, rotary embeddings (incl. M-RoPE),
GQA/MQA attention with sliding-window and KV-cache support, (Sw)iGLU MLP;
port of ``repro.models.layers``.

Pure functional: ``init_*`` build parameter trees (dict leaves) on the
host from a seeded numpy generator, ``*_fwd`` apply them to tensors on
any device.  The arithmetic is the reference's, in plain PyTorch, with
JAX's type promotion made explicit where ``torch.einsum`` would refuse
mixed dtypes (``_einsum``).  A cache write returns new tensors: a cache
given to a call is never changed.

The mesh hints (``shard_hint``, ``batch_hint``, ``residual_hint``) act
against the ambient mesh that ``set_mesh`` enters (a ``torch.distributed``
``DeviceMesh`` with named dimensions; the counterpart of JAX's
``set_mesh``): under it a hint redistributes a DTensor activation to the
hinted placements.  With no mesh, or on a plain tensor, a hint is a no-op,
so the model code stays mesh-agnostic.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = ["rms_norm", "init_rms", "init_dense", "dense",
           "rope_freqs", "apply_rope", "apply_mrope",
           "init_attention", "attention_fwd", "init_mlp", "mlp_fwd",
           "KVCache", "init_kv_cache", "set_mesh", "ambient_mesh",
           "shard_hint", "batch_hint", "residual_hint", "BATCH_AXES"]

# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------


def _einsum(eq, *xs):
    """``jnp.einsum``'s promotion: every operand in the widest dtype."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return torch.einsum(eq, *(x.to(dt) for x in xs))


def normal(rng: np.random.Generator, shape, scale, dtype):
    """An f32 standard normal draw times ``scale`` (in f32), cast to
    ``dtype``: the reference's ``jax.random.normal(...) * scale`` with a
    numpy stream in place of the jax key."""
    w = rng.standard_normal(shape, dtype=np.float32)
    w *= np.float32(scale)
    return torch.from_numpy(w).to(dtype)


def init_rms(d: int, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype)}


def rms_norm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def init_dense(rng, d_in: int, d_out: int, dtype=torch.float32, scale=None):
    """``rng``: a ``np.random.Generator`` (the reference takes a jax key)."""
    scale = (1.0 / np.sqrt(d_in)) if scale is None else scale
    return {"w": normal(rng, (d_in, d_out), scale, dtype)}


def dense(p, x):
    return x @ p["w"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float = 10000.0):
    half = d_head // 2
    return 1.0 / (theta ** (np.arange(half) / half))   # (half,) float64


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _freqs32(freqs, device):
    return torch.as_tensor(freqs, dtype=torch.float32, device=device)


def apply_rope(q, k, positions, freqs):
    """q/k: (B, S, H, Dh); positions: (B, S) int32."""
    ang = positions[..., None].float() * _freqs32(freqs, q.device)
    cos = torch.cos(ang)[:, :, None, :].to(q.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(q.dtype)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def apply_mrope(q, k, positions3, freqs, sections):
    """Qwen2-VL multimodal RoPE: positions3 (3, B, S) for (t, h, w);
    ``sections`` splits the half-dim across the three components."""
    half = freqs.shape[0]
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    angs = positions3[..., None].float() * _freqs32(freqs, q.device)
    parts, off = [], 0
    for i, s in enumerate(sections):
        parts.append(angs[i, :, :, off:off + s])
        off += s
    ang = torch.cat(parts, dim=-1)                             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(q.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(q.dtype)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


# ---------------------------------------------------------------------------
# attention (GQA / MQA, causal / bidirectional / sliding window, KV cache)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # (B, Hkv, Smax, Dh)
    v: torch.Tensor        # (B, Hkv, Smax, Dh)
    pos: torch.Tensor      # 0-d int32 — tokens already cached


def init_kv_cache(batch: int, n_kv: int, s_max: int, d_head: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """On ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return KVCache(
        k=torch.zeros((batch, n_kv, s_max, d_head), dtype=dtype, device=dev),
        v=torch.zeros((batch, n_kv, s_max, d_head), dtype=dtype, device=dev),
        pos=torch.zeros((), dtype=torch.int32, device=dev))


def init_attention(rng, d_model: int, n_heads: int, n_kv: int, d_head: int,
                   dtype=torch.float32):
    return {
        "wq": init_dense(rng, d_model, n_heads * d_head, dtype),
        "wk": init_dense(rng, d_model, n_kv * d_head, dtype),
        "wv": init_dense(rng, d_model, n_kv * d_head, dtype),
        "wo": init_dense(rng, n_heads * d_head, d_model, dtype,
                         scale=1.0 / np.sqrt(n_heads * d_head)),
    }


# ---------------------------------------------------------------------------
# the ambient mesh and the sharding hints
# ---------------------------------------------------------------------------

_MESHES: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Within the scope ``mesh`` (a ``DeviceMesh`` with named dimensions)
    is the ambient mesh of the hints and of the MoE dispatch."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def ambient_mesh():
    return _MESHES[-1] if _MESHES else None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_hint(x, *spec):
    """Best-effort layout constraint against the ambient mesh.

    Entries name mesh axes (or tuples of axes); axes missing from the
    ambient mesh or not dividing the dim are dropped; every other dim is
    unconstrained (it keeps its placement, unless a hinted dim needs its
    mesh axis).  A no-op outside ``set_mesh`` or on a plain tensor."""
    mesh = ambient_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.rules import mesh_sizes
    sizes = mesh_sizes(mesh)
    target = {}                         # mesh axis -> tensor dim
    for i, a in enumerate(spec):
        if a is None:
            continue
        axes = (a,) if isinstance(a, str) else tuple(
            ax for ax in a if ax in sizes)
        if axes and all(ax in sizes for ax in axes):
            k = int(np.prod([sizes[ax] for ax in axes]))
            if k > 1 and x.shape[i] % k == 0:
                target.update({ax: i for ax in axes})
    if not target:
        return x
    pinned = set(target.values())
    placements = []
    for name, cur in zip(mesh.mesh_dim_names, x.placements):
        if name in target:
            placements.append(Shard(target[name]))
        elif cur.is_shard() and cur.dim in pinned:
            placements.append(Replicate())
        else:
            placements.append(cur)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(mesh, placements)


BATCH_AXES = ("pod", "data")


def batch_hint(x):
    """Pin the leading (batch) dim of an activation to the data axes."""
    if x.dim() < 2:
        return x
    return shard_hint(x, BATCH_AXES, *([None] * (x.dim() - 1)))


def residual_hint(x, seq_parallel: bool = False):
    """Residual-stream layout at layer boundaries: batch on the data axes
    and, when ``seq_parallel``, the sequence dim on 'model' (Megatron-SP
    style)."""
    if x.dim() != 3:
        return batch_hint(x)
    if seq_parallel:
        return shard_hint(x, BATCH_AXES, "model", None)
    return batch_hint(x)


def _sdpa(q, k, v, mask, d_head):
    """q (B,S,H,Dh), k/v (B,Skv,Hkv,Dh); mask (B,1,S,Skv) bool.

    GQA repeats each K/V head ``H // Hkv`` times in place
    (``jnp.repeat``'s order: head h reads K/V head h // rep).  A fully
    masked row fills with -1e30, not -inf, and so gets uniform
    probabilities rather than NaN.  Under a mesh the heads are hinted onto
    'model', as the reference hints them."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    q = shard_hint(q, None, None, "model", None)
    k = shard_hint(k, None, None, "model", None)
    v = shard_hint(v, None, None, "model", None)
    logits = _einsum("bshd,bthd->bhst", q, k)          # (B,H,S,Skv)
    logits = shard_hint(logits, None, "model", None, None)
    logits = logits.float() / float(np.sqrt(d_head))
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = _einsum("bhst,bthd->bshd", probs, v)
    return out.reshape(B, S, H, Dh)


# query-chunked attention: bounds the logits working set to
# (B, H, q_chunk, Skv) per step instead of (B, H, S, Skv)
Q_CHUNK = 1024


def remat(fn):
    """``fn`` with its activations recomputed in the backward pass
    (``jax.checkpoint``): ``torch.utils.checkpoint`` without reentry."""
    from torch.utils.checkpoint import checkpoint
    return functools.wraps(fn)(
        lambda *a: checkpoint(fn, *a, use_reentrant=False))


def _chunked_causal_sdpa(q, k, v, positions, window, d_head, q_chunk):
    """Attention one query chunk at a time; where gradients flow, each
    chunk is rematerialised in the backward pass (the reference's
    ``jax.checkpoint`` on its scan body), so what is kept per layer is one
    chunk's f32 probabilities, not S^2 of them."""
    B, S, H, Dh = q.shape
    kp = positions[:, None, :]                      # (B, 1, Skv)

    def body(qc, pqc, k, v):
        valid = kp <= pqc[:, :, None]
        if window is not None:
            valid &= kp > pqc[:, :, None] - window
        return _sdpa(qc, k, v, valid[:, None], d_head)

    if torch.is_grad_enabled():
        body = remat(body)
    outs = [body(q[:, c * q_chunk:(c + 1) * q_chunk],
                 positions[:, c * q_chunk:(c + 1) * q_chunk], k, v)
            for c in range(S // q_chunk)]
    return torch.cat(outs, dim=1)


def attention_fwd(p, x, positions, freqs, *, n_heads: int, n_kv: int,
                  d_head: int, causal: bool = True,
                  window: Optional[int] = None,
                  cache: Optional[KVCache] = None,
                  kv_x: Optional[torch.Tensor] = None,
                  mrope_sections=None, positions3=None):
    """Returns (out, new_cache).

    Modes:
      cache None, kv_x None      — full self-attention (train / scoring).
      cache given, S == q tokens — decode/prefill append: writes new K/V at
                                   cache.pos and attends over the cache.
      kv_x given                 — cross-attention onto kv_x (no rope).
    """
    B, S, D = x.shape
    q = dense(p["wq"], x).reshape(B, S, n_heads, d_head)
    src = x if kv_x is None else kv_x
    k = dense(p["wk"], src).reshape(B, src.shape[1], n_kv, d_head)
    v = dense(p["wv"], src).reshape(B, src.shape[1], n_kv, d_head)

    if kv_x is None:
        if mrope_sections is not None:
            q, k = apply_mrope(q, k, positions3, freqs, mrope_sections)
        else:
            q, k = apply_rope(q, k, positions, freqs)

    new_cache = None
    if cache is not None and kv_x is None:
        smax = cache.k.shape[2]
        dev = cache.k.device
        rolling = window is not None and smax <= window
        kT = k.transpose(1, 2).to(cache.k.dtype)
        vT = v.transpose(1, 2).to(cache.v.dtype)
        q_pos = positions[:, :, None]            # (B, S, 1) global positions
        if rolling:
            # ring buffer of the last `smax` tokens (Mistral-style SWA cache)
            if S >= smax:
                idx = (cache.pos + S - smax
                       + torch.arange(smax, device=dev)) % smax
                ck = cache.k.index_copy(2, idx.long(), kT[:, :, -smax:])
                cv = cache.v.index_copy(2, idx.long(), vT[:, :, -smax:])
            else:
                idx = (cache.pos + torch.arange(S, device=dev)) % smax
                ck = cache.k.index_copy(2, idx.long(), kT)
                cv = cache.v.index_copy(2, idx.long(), vT)
            new_cache = KVCache(k=ck, v=cv, pos=cache.pos + S)
            if S > 1:
                # prefill: the ring only retains the last `smax` keys, so
                # attention runs over the full fresh K/V (early queries
                # need in-window keys the ring has already evicted); the
                # ring write above still seeds the decode steps.
                if S % Q_CHUNK == 0 and S > Q_CHUNK:
                    out = _chunked_causal_sdpa(q, k, v, positions, window,
                                               d_head, Q_CHUNK)
                else:
                    qp = positions[:, :, None]
                    kp = positions[:, None, :]
                    valid = (kp <= qp) & (kp > qp - window)
                    out = _sdpa(q, k, v, valid[:, None], d_head)
                out = dense(p["wo"], out.reshape(B, S, n_heads * d_head))
                return out, new_cache
            # decode: global position held by ring slot j after this write
            top = cache.pos + S - 1
            slots = torch.arange(smax, device=dev)[None, :]
            gpos = top - torch.remainder(top - slots, smax)    # (1, Smax)
            valid = (gpos[:, None, :] <= q_pos) & (gpos[:, None, :] >= 0)
            valid &= gpos[:, None, :] > q_pos - window
        else:
            if S > smax:
                raise ValueError(f"{S} tokens do not fit a cache of {smax}")
            # lax.dynamic_update_slice clamps its start so the update fits
            start = torch.clamp(cache.pos, 0, smax - S)
            idx = (start + torch.arange(S, device=dev)).long()
            ck = cache.k.index_copy(2, idx, kT)
            cv = cache.v.index_copy(2, idx, vT)
            new_cache = KVCache(k=ck, v=cv, pos=cache.pos + S)
            kv_pos = torch.arange(smax, device=dev)[None, :]   # (1, Smax)
            valid = kv_pos[:, None, :] <= q_pos  # causal within cache
            valid &= (kv_pos < cache.pos + S)[:, None, :]
            if window is not None:
                valid &= kv_pos[:, None, :] > q_pos - window
        k_all = ck.transpose(1, 2)               # (B, Smax, Hkv, Dh)
        v_all = cv.transpose(1, 2)
        mask = valid[:, None]                    # (B,1,S,Smax)
        out = _sdpa(q, k_all, v_all, mask, d_head)
    else:
        Skv = src.shape[1]
        if kv_x is not None:
            out = _sdpa(q, k, v, torch.ones((B, 1, S, Skv), dtype=torch.bool,
                                            device=x.device), d_head)
        elif causal and S % Q_CHUNK == 0 and S > Q_CHUNK:
            out = _chunked_causal_sdpa(q, k, v, positions, window, d_head,
                                       Q_CHUNK)
        else:
            qp = positions[:, :, None]
            kp = positions[:, None, :]
            if causal:
                valid = kp <= qp
            else:
                valid = torch.ones((B, S, Skv), dtype=torch.bool,
                                   device=x.device)
            if window is not None:
                valid &= kp > qp - window
            out = _sdpa(q, k, v, valid[:, None], d_head)

    out = dense(p["wo"], out.reshape(B, S, n_heads * d_head))
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(rng, d_model: int, d_ff: int, dtype=torch.float32):
    return {
        "wi": init_dense(rng, d_model, d_ff, dtype),
        "wg": init_dense(rng, d_model, d_ff, dtype),
        "wo": init_dense(rng, d_ff, d_model, dtype, scale=1.0 / np.sqrt(d_ff)),
    }


def silu(x):
    return x * torch.sigmoid(x)


def mlp_fwd(p, x):
    return dense(p["wo"], silu(dense(p["wg"], x)) * dense(p["wi"], x))
