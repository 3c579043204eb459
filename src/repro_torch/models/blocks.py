"""Decoder blocks; port of ``repro.models.blocks``.

A model is a stack of repeated *groups*; a group is a short sequence of
(mixer, ffn) blocks (one block for uniform archs, eight for Jamba's 1:7
Mamba:attention interleave).  The reference stacks each group's
parameters on a leading axis for ``lax.scan``; the port keeps one tree
per group and loops over them (``models/lm.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .layers import (attention_fwd, init_attention, init_kv_cache, init_mlp,
                     init_rms, mlp_fwd, rms_norm)
from .mamba2 import init_mamba2, init_mamba2_cache, mamba2_fwd
from .moe import init_moe, moe_fwd

__all__ = ["BlockSpec", "init_block", "block_fwd", "init_block_cache"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str                 # 'attn' | 'swa' | 'mamba' | 'cross_attn'
    ffn: Optional[str]         # 'dense' | 'moe' | None


def init_block(rng, spec: BlockSpec, cfg, dtype):
    """``rng``: a ``np.random.Generator``; the tree is on the host."""
    p = {"norm1": init_rms(cfg.d_model, dtype)}
    if spec.mixer in ("attn", "swa", "cross_attn"):
        p["attn"] = init_attention(rng, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.d_head, dtype)
    elif spec.mixer == "mamba":
        p["mamba"] = init_mamba2(rng, cfg.d_model, cfg.ssm_state,
                                 headdim=cfg.ssm_headdim, dtype=dtype)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn is not None:
        p["norm2"] = init_rms(cfg.d_model, dtype)
        if spec.ffn == "dense":
            p["mlp"] = init_mlp(rng, cfg.d_model, cfg.d_ff, dtype)
        elif spec.ffn == "moe":
            p["moe"] = init_moe(rng, cfg.d_model, cfg.moe_d_ff,
                                cfg.moe_experts, cfg.moe_shared,
                                cfg.moe_d_ff_shared, dtype)
        else:
            raise ValueError(spec.ffn)
    return p


def init_block_cache(spec: BlockSpec, cfg, batch: int, s_max: int,
                     dtype=torch.bfloat16, device=None):
    """On ``device`` (CUDA unless ``device="cpu"``)."""
    if spec.mixer in ("attn", "swa", "cross_attn"):
        smax = min(s_max, cfg.window) if (spec.mixer == "swa" and cfg.window
                                          and cfg.use_rolling_swa) else s_max
        return init_kv_cache(batch, cfg.n_kv_heads, smax, cfg.d_head, dtype,
                             device=device)
    d_inner = 2 * cfg.d_model
    return init_mamba2_cache(batch, d_inner, cfg.ssm_state,
                             d_inner // cfg.ssm_headdim, cfg.ssm_headdim,
                             dtype, device=device)


def block_fwd(p, spec: BlockSpec, cfg, x, positions, freqs, *,
              cache=None, enc_out=None, causal=True,
              positions3=None):
    """Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(p["norm1"], x)
    new_cache = cache
    if spec.mixer in ("attn", "swa"):
        window = cfg.window if spec.mixer == "swa" else None
        out, new_cache = attention_fwd(
            p["attn"], h, positions, freqs,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            causal=causal, window=window, cache=cache,
            mrope_sections=cfg.mrope_sections, positions3=positions3)
    elif spec.mixer == "cross_attn":
        out, _ = attention_fwd(
            p["attn"], h, positions, freqs,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            causal=False, kv_x=enc_out)
    elif spec.mixer == "mamba":
        out, new_cache = mamba2_fwd(
            p["mamba"], h, d_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
            chunk=cfg.ssm_chunk, cache=cache)
    else:
        raise ValueError(spec.mixer)
    x = x + out
    if spec.ffn is not None:
        h = rms_norm(p["norm2"], x)
        if spec.ffn == "dense":
            x = x + mlp_fwd(p["mlp"], h)
        else:
            y, aux = moe_fwd(p["moe"], h, top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity)
            x = x + y
    return x, new_cache, aux
