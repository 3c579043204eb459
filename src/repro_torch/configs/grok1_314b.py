"""grok-1-314b [moe]: 64L d=6144 48H GQA(kv=8) expert d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, group=(BlockSpec("attn", "moe"),),
    moe_experts=8, moe_top_k=2, moe_d_ff=32768,
    fsdp=True, opt_8bit=True,
    notes="int8 optimizer state to fit 314B on 256 chips; long_500k skipped",
))
