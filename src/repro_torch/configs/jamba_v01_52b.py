"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H GQA(kv=8) d_ff=14336 vocab=65536,
Mamba:attention 7:1 interleave (attn at index 4 of each 8-layer group), MoE
16 experts top-2 every other layer [arXiv:2403.19887].

Adaptation note (DESIGN.md): Jamba v0.1 uses Mamba-1 (d_state 16); this
framework's SSM block is Mamba-2/SSD with the same d_state — recorded as a
hardware-codesign substitution (SSD is the MXU-friendly dual form).
"""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

_M_D = BlockSpec("mamba", "dense")
_M_E = BlockSpec("mamba", "moe")
_A_D = BlockSpec("attn", "dense")

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536,
    group=(_M_D, _M_E, _M_D, _M_E, _A_D, _M_E, _M_D, _M_E),
    moe_experts=16, moe_top_k=2, moe_d_ff=14336,
    ssm_state=16, ssm_headdim=64, ssm_chunk=128,
    long_context=True, fsdp=True,
    notes="4 attention layers total; long_500k runs (B=1 KV fits)",
))
