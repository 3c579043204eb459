"""seamless-m4t-medium [audio]: enc-dec, 12L+12L d=1024 16H (kv=16)
d_ff=4096 vocab=256206 [arXiv:2308.11596].  The audio frontend is a STUB:
input_specs() provides precomputed (B, S, d_model) frame embeddings."""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, group=(BlockSpec("attn", "dense"),),
    encdec=True, enc_layers=12, input_kind="frames",
    notes="enc-dec; decode shapes use the decoder; long_500k skipped",
))
