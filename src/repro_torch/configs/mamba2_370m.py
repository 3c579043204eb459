"""mamba2-370m [ssm]: 48L d_model=1024 attn-free, vocab 50280, d_state=128.
SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab=50280, group=(BlockSpec("mamba", None),),
    ssm_state=128, ssm_headdim=64, ssm_chunk=128,
    long_context=True,
    notes="attention-free; d_inner=2*d_model, 32 SSD heads of headdim 64",
))
