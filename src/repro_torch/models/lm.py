"""Causal LM and encoder-decoder model classes over block groups; port of
``repro.models.lm``.

The models are ``torch.nn.Module``s on one device (CUDA unless
``device="cpu"``) with the reference's functional calls: ``init(seed)``
returns the parameter tree, ``forward(params, tokens, ...)``,
``encode``/``decode`` and ``loss`` take it.  The tree is the reference's
but for the groups: ``params["groups"]`` is a list with one tuple of block
trees per group, where the reference stacks each leaf on a leading axis
for ``lax.scan`` (``interop.lm_params_from_numpy``/``lm_params_to_numpy``
convert).  Caches follow the same layout.

``init`` draws every weight on the host from ``np.random.default_rng(
seed)`` at the reference's scales (f32, then cast to the compute dtype),
so the CPU and the card get the same weights; the reference's
``jax.random`` draws cannot be reproduced, and parity goes through carried
weights.

``train=True`` with ``cfg.remat`` rematerialises each group in the
backward pass (``layers.remat``, the reference's ``jax.checkpoint`` on its
scan body), and each block of a one-block group as well (its nested
remat); the values are the same either way.  Under ``layers.set_mesh``
the batch and logits hints of the reference lay out DTensor activations.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from .blocks import BlockSpec, block_fwd, init_block, init_block_cache
from .layers import BATCH_AXES, KVCache, batch_hint, dense, init_dense, \
    init_rms, normal, remat, rms_norm, rope_freqs, shard_hint

__all__ = ["CausalLM", "EncDecLM", "build_model", "cross_entropy"]


def _to(tree, device):
    """Every tensor of a dict/tuple/list tree moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def cross_entropy(logits, targets, mask):
    """Mean next-token CE over masked positions; logits (B,S,V) any dtype.
    A DTensor's vocabulary dim is gathered first: DTensor has no sharding
    rule for ``gather`` along a sharded dim."""
    if hasattr(logits, "placements"):
        logits = _replicate_dim(logits, logits.dim() - 1)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - tgt) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def _replicate_dim(x, dim: int):
    """A DTensor with every mesh axis that shards ``dim`` replicated."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and p.dim == dim else p
          for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def _embed(params, tokens):
    B, S = tokens.shape
    return params["embed"].index_select(0, tokens.reshape(-1)).reshape(
        B, S, -1)


def _positions(caches, B, S, device):
    """(B, S) int32 query positions after the tokens already cached."""
    base = 0 if caches is None else _first_cache_pos(caches)
    pos = base + torch.arange(S, dtype=torch.int32, device=device)[None, :]
    return pos.expand(B, S)


class CausalLM(torch.nn.Module):
    """Decoder-only LM (dense / SWA / MoE / Mamba2 / hybrid / VLM backbone)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.register_buffer("freqs", torch.tensor(
            rope_freqs(cfg.d_head or 64, cfg.rope_theta), dtype=torch.float32,
            device=self.device), persistent=False)

    # -- params ---------------------------------------------------------------

    def init(self, seed: int = 0) -> dict:
        cfg = self.cfg
        dtype = cfg.compute_dtype
        rng = np.random.default_rng(seed)
        dev = self.device
        p: dict = {
            "embed": normal(rng, (cfg.vocab_padded, cfg.d_model), 0.02,
                            dtype).to(dev),
            "final_norm": _to(init_rms(cfg.d_model, dtype), dev),
            "lm_head": _to(init_dense(rng, cfg.d_model, cfg.vocab_padded,
                                      dtype), dev),
        }
        for i, spec in enumerate(cfg.prelude):
            p[f"prelude{i}"] = _to(init_block(rng, spec, cfg, dtype), dev)
        p["groups"] = [tuple(_to(init_block(rng, spec, cfg, dtype), dev)
                             for spec in cfg.group)
                       for _ in range(cfg.n_groups)]
        return p

    # -- caches ----------------------------------------------------------------

    def init_cache(self, batch: int, s_max: int, dtype=torch.bfloat16):
        cfg = self.cfg
        mk = lambda spec: init_block_cache(  # noqa: E731
            spec, cfg, batch, s_max, dtype, device=self.device)
        return {"prelude": tuple(mk(spec) for spec in cfg.prelude),
                "groups": [tuple(mk(spec) for spec in cfg.group)
                           for _ in range(cfg.n_groups)]}

    # -- forward ----------------------------------------------------------------

    def forward(self, params, tokens=None, *, embeds=None, positions=None,
                caches=None, positions3=None, train: bool = False):
        """Returns (logits, new_caches, aux_loss_sum)."""
        cfg = self.cfg
        if embeds is None:
            x = _embed(params, tokens)
        else:
            x = embeds.to(cfg.compute_dtype)
        x = batch_hint(x)
        B, S = x.shape[:2]
        if positions is None:
            positions = _positions(caches, B, S, x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        rm = train and cfg.remat

        new_pre = []
        for i, spec in enumerate(cfg.prelude):
            c = None if caches is None else caches["prelude"][i]
            x, c, a = block_fwd(params[f"prelude{i}"], spec, cfg, x, positions,
                                self.freqs, cache=c, positions3=positions3)
            new_pre.append(c)
            aux = aux + a

        def group_body(x, gp, gc):
            x = batch_hint(x)   # keep batch on the data axes
            a_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            new_cs = []
            for b, spec in enumerate(cfg.group):
                c = None if gc is None else gc[b]

                def one_block(x, c, gpb=gp[b], spec=spec):
                    return block_fwd(gpb, spec, cfg, x, positions,
                                     self.freqs, cache=c,
                                     positions3=positions3)
                if rm and len(cfg.group) == 1:
                    # nested remat: backward holds one block's internals
                    # at a time instead of the whole layer's
                    one_block = remat(one_block)
                x, c, a = one_block(x, c)
                new_cs.append(c)
                a_sum = a_sum + a
            return x, tuple(new_cs), a_sum

        body = remat(group_body) if rm else group_body
        new_gc, auxs = [], []
        for g, gp in enumerate(params["groups"]):
            gc = None if caches is None else caches["groups"][g]
            x, new_cs, a_sum = body(x, gp, gc)
            new_gc.append(new_cs)
            auxs.append(a_sum)
        if auxs:
            aux = aux + torch.stack(auxs).sum()

        x = batch_hint(rms_norm(params["final_norm"], x))
        logits = dense(params["lm_head"], x)
        # logits: batch on data axes, padded vocab on model
        logits = shard_hint(logits, BATCH_AXES, None, "model")
        new_caches = None
        if caches is not None:
            new_caches = {"prelude": tuple(new_pre), "groups": new_gc}
        return logits, new_caches, aux

    # -- losses -----------------------------------------------------------------

    def loss(self, params, batch, train: bool = True):
        logits, _, aux = self.forward(
            params, batch.get("tokens"), embeds=batch.get("embeds"),
            positions3=batch.get("positions3"), train=train)
        ce = cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                           batch["mask"][:, 1:].float())
        return ce + 0.01 * aux


def _kv_caches(tree):
    if isinstance(tree, KVCache):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _kv_caches(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _kv_caches(v)


def _first_cache_pos(caches):
    """Base query position = tokens already cached (0-d int32, from any
    KVCache: every layer's holds the same count)."""
    for c in _kv_caches(caches):
        return c.pos
    return torch.zeros((), dtype=torch.int32)


class EncDecLM(torch.nn.Module):
    """Encoder-decoder (Seamless backbone): bidirectional encoder over stub
    frame embeddings, causal decoder with cross-attention."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.register_buffer("freqs", torch.tensor(
            rope_freqs(cfg.d_head, cfg.rope_theta), dtype=torch.float32,
            device=self.device), persistent=False)
        self.enc_group = (BlockSpec("attn", "dense"),)
        self.dec_group = (BlockSpec("attn", None),
                          BlockSpec("cross_attn", "dense"))

    def init(self, seed: int = 0) -> dict:
        cfg = self.cfg
        dtype = cfg.compute_dtype
        rng = np.random.default_rng(seed)
        dev = self.device
        blocks = lambda specs: tuple(  # noqa: E731
            _to(init_block(rng, s, cfg, dtype), dev) for s in specs)
        enc_groups = [blocks(self.enc_group) for _ in range(cfg.enc_layers)]
        dec_groups = [blocks(self.dec_group) for _ in range(cfg.n_groups)]
        return {
            "embed": normal(rng, (cfg.vocab_padded, cfg.d_model), 0.02,
                            dtype).to(dev),
            "enc_groups": enc_groups,
            "enc_norm": _to(init_rms(cfg.d_model, dtype), dev),
            "dec_groups": dec_groups,
            "final_norm": _to(init_rms(cfg.d_model, dtype), dev),
            "lm_head": _to(init_dense(rng, cfg.d_model, cfg.vocab_padded,
                                      dtype), dev),
        }

    def init_cache(self, batch: int, s_max: int, dtype=torch.bfloat16):
        cfg = self.cfg
        return {"groups": [tuple(init_block_cache(s, cfg, batch, s_max, dtype,
                                                  device=self.device)
                                 for s in self.dec_group)
                           for _ in range(cfg.n_groups)]}

    def encode(self, params, frames, train: bool = False):
        cfg = self.cfg
        x = frames.to(cfg.compute_dtype)
        B, S = x.shape[:2]
        positions = _positions(None, B, S, x.device)

        def body(x, gp):
            x = batch_hint(x)
            for b, spec in enumerate(self.enc_group):
                x, _, _ = block_fwd(gp[b], spec, cfg, x, positions, self.freqs,
                                    causal=False)
            return x

        bodyf = remat(body) if (train and cfg.remat) else body
        for gp in params["enc_groups"]:
            x = bodyf(x, gp)
        return rms_norm(params["enc_norm"], x)

    def decode(self, params, tokens, enc_out, caches=None, train: bool = False):
        cfg = self.cfg
        x = _embed(params, tokens)
        B, S = x.shape[:2]
        positions = _positions(caches, B, S, x.device)

        def body(x, gp, gc):
            x = batch_hint(x)
            new_cs = []
            for b, spec in enumerate(self.dec_group):
                c = None if gc is None else gc[b]
                x, c, _ = block_fwd(gp[b], spec, cfg, x, positions, self.freqs,
                                    cache=c, enc_out=enc_out)
                new_cs.append(c)
            return x, tuple(new_cs)

        bodyf = remat(body) if (train and cfg.remat) else body
        new_gc = []
        for g, gp in enumerate(params["dec_groups"]):
            gc = None if caches is None else caches["groups"][g]
            x, new_cs = bodyf(x, gp, gc)
            new_gc.append(new_cs)
        x = batch_hint(rms_norm(params["final_norm"], x))
        logits = dense(params["lm_head"], x)
        logits = shard_hint(logits, BATCH_AXES, None, "model")
        return logits, (None if caches is None else {"groups": new_gc})

    def loss(self, params, batch, train: bool = True):
        enc = self.encode(params, batch["frames"], train=train)
        logits, _ = self.decode(params, batch["tokens"], enc, train=train)
        return cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                             batch["mask"][:, 1:].float())


def build_model(cfg, device=None):
    """The model of ``cfg`` on ``device`` (CUDA unless ``device="cpu"``;
    with no device and no CUDA it raises)."""
    return EncDecLM(cfg, device) if cfg.encdec else CausalLM(cfg, device)
