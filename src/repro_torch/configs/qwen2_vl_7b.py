"""qwen2-vl-7b [vlm]: 28L d=3584 28H GQA(kv=4) d_ff=18944 vocab=152064,
M-RoPE (t/h/w sections 16/24/24 of the 64 rotary pairs) [arXiv:2409.12191].
The vision frontend is a STUB: input_specs() provides precomputed patch/token
embeddings plus (3, B, S) M-RoPE position ids."""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, group=(BlockSpec("attn", "dense"),),
    mrope_sections=(16, 24, 24), input_kind="embeds3",
    rope_theta=1000000.0, fsdp=True,
    notes="M-RoPE backbone; dynamic-resolution frontend stubbed; long_500k skipped",
))
