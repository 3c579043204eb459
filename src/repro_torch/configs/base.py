"""Architecture configs: the assigned pool + the paper's own workload;
port of ``repro.configs.base``.

Every LM arch declares its exact published dimensions and a ``reduced()``
variant (same family, tiny widths) for CPU smoke tests.  Shape cells
(train_4k / prefill_32k / decode_32k / long_500k) are defined here too.
The numbers are the reference's; ``compute_dtype`` is a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.blocks import BlockSpec

__all__ = ["ArchConfig", "register", "get_config", "list_configs", "SHAPES",
           "ShapeCell"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                         # dense|moe|ssm|hybrid|audio|vlm|ising
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    group: Tuple[BlockSpec, ...]        # repeating block pattern
    prelude: Tuple[BlockSpec, ...] = () # unscanned leading blocks
    d_head: Optional[int] = None
    window: Optional[int] = None        # sliding-window attention
    use_rolling_swa: bool = True
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_d_ff: int = 0
    moe_d_ff_shared: Optional[int] = None
    moe_capacity: float = 1.25
    encdec: bool = False
    enc_layers: int = 0
    input_kind: str = "tokens"          # 'tokens' | 'frames' (stub frontend)
    long_context: bool = False          # can run long_500k
    dtype: str = "bfloat16"
    fsdp: bool = False                  # shard params over data axis too
    opt_8bit: bool = False              # int8 optimizer state
    remat: bool = True
    notes: str = ""

    def __post_init__(self):
        if self.d_head is None and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        body = self.n_layers - len(self.prelude)
        if self.group and body % len(self.group) != 0:
            raise ValueError(f"{self.name}: {body} layers not divisible by "
                             f"group of {len(self.group)}")

    @property
    def n_groups(self) -> int:
        if not self.group:
            return 0
        return (self.n_layers - len(self.prelude)) // len(self.group)

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def vocab_padded(self) -> int:
        """Embed/head tables padded to 128 so the vocab dim shards over any
        mesh factor (Megatron-style vocab padding; targets never index pads)."""
        return ((self.vocab + 127) // 128) * 128

    def shapes(self):
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.long_context:
            names.append("long_500k")
        return [SHAPES[s] for s in names]

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        small_group = self.group
        prelude = self.prelude
        n_layers = len(prelude) + 2 * len(self.group)
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=64,
            n_heads=4, n_kv_heads=min(4, max(1, self.n_kv_heads)),
            d_head=16, d_ff=128, vocab=256,
            window=min(self.window, 16) if self.window else None,
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
            ssm_state=16, ssm_headdim=16, ssm_chunk=16,
            moe_experts=min(self.moe_experts, 4) if self.moe_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_d_ff=32 if self.moe_experts else 0,
            moe_d_ff_shared=64 if self.moe_shared else None,
            moe_capacity=8.0,   # no drops at smoke-test token counts
            enc_layers=2 if self.encdec else 0,
            dtype="float32", fsdp=False, opt_8bit=False)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    return dict(_REGISTRY)
