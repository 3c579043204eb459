"""deepseek-67b [dense]: 95L d=8192 64H GQA(kv=8) d_ff=22016 vocab=102400
[arXiv:2401.02954]."""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=102400, group=(BlockSpec("attn", "dense"),),
    fsdp=True,
    notes="full attention => long_500k skipped",
))
