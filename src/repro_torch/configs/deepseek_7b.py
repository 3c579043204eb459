"""deepseek-7b [dense]: 30L d=4096 32H MHA(kv=32) d_ff=11008 vocab=102400
[arXiv:2401.02954]."""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab=102400, group=(BlockSpec("attn", "dense"),),
    fsdp=True,
    notes="full attention => long_500k skipped",
))
