"""Serving steps: prefill and single-token decode over the model zoo's
caches (standard KV, rolling SWA ring, Mamba2 recurrent state); port of
``repro.serve.serve_step``.  The steps run eagerly (the reference jits
them); no step reads a tensor back to the host.
"""

from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device

__all__ = ["make_prefill_step", "make_decode_step", "greedy_generate",
           "cache_len_for"]


def cache_len_for(cfg, seq_len: int) -> int:
    """Cache extent per attention layer for a serving context of seq_len.

    SWA archs with rolling caches only ever need `window` slots — this is
    what makes long_500k feasible for h2o-danube."""
    if cfg.window is not None and cfg.use_rolling_swa:
        return min(cfg.window, seq_len)
    return seq_len


def make_prefill_step(model, cfg):
    def prefill(params, batch, caches):
        if cfg.encdec:
            enc = model.encode(params, batch["frames"])
            logits, caches = model.decode(params, batch["tokens"], enc,
                                          caches=caches)
            return logits[:, -1:], caches, enc
        logits, caches, _ = model.forward(
            params, batch.get("tokens"), embeds=batch.get("embeds"),
            positions3=batch.get("positions3"), caches=caches)
        return logits[:, -1:], caches, None
    return prefill


def make_decode_step(model, cfg):
    def decode(params, tokens_1, caches, enc=None, positions3=None):
        """tokens_1 (B, 1) -> (logits (B,1,V), new caches)."""
        if cfg.encdec:
            logits, caches = model.decode(params, tokens_1, enc, caches=caches)
            return logits, caches
        logits, caches, _ = model.forward(params, tokens_1, caches=caches,
                                          positions3=positions3)
        return logits, caches
    return decode


def greedy_generate(model, cfg, params, batch, max_new: int,
                    cache_dtype=torch.float32, device=None):
    """Prefill + greedy decode loop (the batched-serving example path).

    Runs on ``device`` (CUDA unless ``device="cpu"``; with no device and
    no CUDA it raises), which must be the model's; ``batch`` holds tensors
    there.  Returns the (B, max_new) int32 tokens."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model is on {model.device}, not on {dev}")
    with torch.no_grad():
        if cfg.encdec:
            B = batch["tokens"].shape[0]
            s_max = batch["tokens"].shape[1] + max_new
        elif "tokens" in batch:
            B = batch["tokens"].shape[0]
            s_max = cache_len_for(cfg, batch["tokens"].shape[1] + max_new)
        else:
            B = batch["embeds"].shape[0]
            s_max = cache_len_for(cfg, batch["embeds"].shape[1] + max_new)
        caches = model.init_cache(B, s_max, dtype=cache_dtype)
        prefill = make_prefill_step(model, cfg)
        decode = make_decode_step(model, cfg)
        logits, caches, enc = prefill(params, batch, caches)
        outs = []
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        for _ in range(max_new):
            outs.append(tok)
            logits, caches = decode(params, tok, caches, enc=enc)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        return torch.cat(outs, dim=1)
