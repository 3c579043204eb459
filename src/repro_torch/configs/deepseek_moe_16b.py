"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16) vocab=102400; layer 0 is
dense (d_ff=10944), layers 1..27 fine-grained MoE: 64 routed top-6 + 2 shared
experts of d_ff=1408 [arXiv:2401.06066]."""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400,
    prelude=(BlockSpec("attn", "dense"),),
    group=(BlockSpec("attn", "moe"),),
    moe_experts=64, moe_top_k=6, moe_shared=2, moe_d_ff=1408,
    moe_d_ff_shared=2816,
    fsdp=True,
    notes="fine-grained + shared experts; long_500k skipped",
))
