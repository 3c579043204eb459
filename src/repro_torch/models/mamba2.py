"""Mamba-2 (state-space duality) block: chunked SSD for train/prefill and
the exact recurrent update for decode; port of ``repro.models.mamba2``.
[arXiv:2405.21060]

Layout follows the reference implementation with n_groups = 1:
  in_proj -> [z (d_inner), x (d_inner), B (d_state), C (d_state), dt (heads)]
  causal conv1d(k=4) over the (x, B, C) channels
  SSD over heads: h' = exp(dt*A) h + dt * B outer x ;  y = C . h + D x
  gated RMSNorm(y * silu(z)) -> out_proj

The chunked SSD computes the same recurrence with matmuls: an intra-chunk
quadratic attention-like term plus inter-chunk state passing (the
reference's ``lax.scan`` over chunks is a loop here).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from .layers import _einsum, dense, init_dense, init_rms, normal, rms_norm, silu

__all__ = ["init_mamba2", "mamba2_fwd", "Mamba2Cache", "init_mamba2_cache"]

D_CONV = 4


@dataclasses.dataclass
class Mamba2Cache:
    conv: torch.Tensor    # (B, D_CONV-1, conv_channels) rolling conv window
    ssm: torch.Tensor     # (B, heads, headdim, d_state) f32


def init_mamba2_cache(batch: int, d_inner: int, d_state: int, heads: int,
                      headdim: int, dtype=torch.bfloat16,
                      device=None) -> Mamba2Cache:
    """On ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    conv_ch = d_inner + 2 * d_state
    return Mamba2Cache(
        conv=torch.zeros((batch, D_CONV - 1, conv_ch), dtype=dtype,
                         device=dev),
        ssm=torch.zeros((batch, heads, headdim, d_state), dtype=torch.float32,
                        device=dev))


def init_mamba2(rng, d_model: int, d_state: int, headdim: int = 64,
                expand: int = 2, dtype=torch.float32):
    """``rng``: a ``np.random.Generator`` for the projections and the conv;
    ``dt_bias`` and ``A_log`` come from the reference's own
    ``default_rng(42)``, bit for bit."""
    d_inner = expand * d_model
    heads = d_inner // headdim
    conv_ch = d_inner + 2 * d_state
    d_in_proj = 2 * d_inner + 2 * d_state + heads
    rng42 = np.random.default_rng(42)
    dt = np.exp(rng42.uniform(np.log(1e-3), np.log(0.1), heads))
    dt_bias = dt + np.log(-np.expm1(-dt))   # inverse softplus
    in_proj = init_dense(rng, d_model, d_in_proj, dtype)
    conv_w = normal(rng, (D_CONV, conv_ch), 1.0 / np.sqrt(D_CONV), dtype)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype),
        "A_log": f32(np.log(rng42.uniform(1, 16, heads))),
        "D": torch.ones((heads,), dtype=torch.float32),
        "dt_bias": f32(dt_bias),
        "norm": init_rms(d_inner, dtype),
        "out_proj": init_dense(rng, d_inner, d_model, dtype,
                               scale=1.0 / np.sqrt(d_inner)),
    }


def _segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{k in (j, i]} x[..., k]."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    ones = torch.ones((T, T), dtype=torch.bool, device=x.device)
    x = torch.where(torch.tril(ones, -1), x, 0)
    x_seg = torch.cumsum(x, dim=-2)
    return torch.where(torch.tril(ones, 0), x_seg, -torch.inf)


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """x (b,l,h,p), dt (b,l,h) post-softplus, A (h,) negative, B/C (b,l,n).

    Returns y (b,l,h,p), final_state (b,h,p,n).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    L = x.shape[1]
    nc = L // chunk

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    dA = dtc * A                                       # (b,nc,c,h)
    dA_cs = torch.cumsum(dA, dim=2)

    # 1. intra-chunk (diagonal block) output
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))   # (b,nc,h,c,c)
    scores = _einsum("bzin,bzjn,bzhij,bzjh->bzhij", Cc, Bc, Lmat, dtc)
    y_diag = _einsum("bzhij,bzjhp->bzihp", scores, xc)

    # 2. chunk-final states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b,nc,c,h)
    states = _einsum("bzch,bzcn,bzchp->bzhpn",
                     decay_states * dtc, Bc, xc)           # (b,nc,h,p,n)

    # 3. inter-chunk recurrence over chunk states (PRE-chunk states kept)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # (b,nc,h)
    states = states.float()
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                 # (b,nc,h,p,n)

    # 4. state -> output within chunk
    state_decay = torch.exp(dA_cs)                         # (b,nc,c,h)
    y_off = _einsum("bzcn,bzhpn,bzch->bzchp",
                    Cc, prev_states.to(x.dtype), state_decay)
    y = y_diag.reshape(b, L, h, p) + y_off.reshape(b, L, h, p)
    return y[:, :l], carry


def mamba2_fwd(p, x, *, d_state: int, headdim: int = 64, expand: int = 2,
               chunk: int = 128, cache: Optional[Mamba2Cache] = None
               ) -> Tuple[torch.Tensor, Optional[Mamba2Cache]]:
    """x (B, S, D) -> (y, new_cache).  cache given + S == 1 => decode path
    (exact recurrence); otherwise chunked SSD (from a zero state)."""
    Bsz, S, D = x.shape
    d_inner = expand * D
    heads = d_inner // headdim
    zxbcdt = dense(p["in_proj"], x)
    z, xin, Bc, Cc, dt = torch.split(
        zxbcdt, [d_inner, d_inner, d_state, d_state,
                 zxbcdt.shape[-1] - 2 * d_inner - 2 * d_state], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)             # (B,S,conv_ch)
    w = p["conv_w"].to(conv_in.dtype)
    bias = p["conv_b"].to(conv_in.dtype)

    new_cache = None
    if cache is not None:
        full = torch.cat([cache.conv.to(conv_in.dtype), conv_in],
                         dim=1)                            # (B, S+3, ch)
        new_conv = full[:, -(D_CONV - 1):]
    else:
        full = F.pad(conv_in, (0, 0, D_CONV - 1, 0))
    conv = sum(full[:, i:i + S] * w[i] for i in range(D_CONV)) + bias
    conv = silu(conv)
    xs, Bs, Cs = torch.split(conv, [d_inner, d_state, d_state], dim=-1)
    xs = xs.reshape(Bsz, S, heads, headdim)
    dt = _softplus(dt.float() + p["dt_bias"])              # (B,S,h)
    A = -torch.exp(p["A_log"])                             # (h,)

    if cache is not None and S == 1:
        # exact recurrent step
        st = cache.ssm                                     # (B,h,p,n)
        dA = torch.exp(dt[:, 0] * A)                       # (B,h)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bs[:, 0].float(),
                           xs[:, 0].float())
        st = st * dA[:, :, None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", Cs[:, 0].float(), st)
        y = y + p["D"][None, :, None] * xs[:, 0].float()
        y = y[:, None].to(x.dtype)                         # (B,1,h,p)
        new_cache = Mamba2Cache(conv=new_conv, ssm=st)
    else:
        y, final = _ssd_chunked(xs, dt, A, Bs.float(), Cs.float(), chunk)
        y = y + p["D"][None, None, :, None] * xs
        y = y.to(x.dtype)
        if cache is not None:
            new_cache = Mamba2Cache(conv=new_conv, ssm=final)

    y = y.reshape(Bsz, S, d_inner)
    y = rms_norm(p["norm"], y * silu(z))
    return dense(p["out_proj"], y), new_cache
