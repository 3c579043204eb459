"""granite-20b [dense]: 52L d=6144 48H MQA(kv=1) d_ff=24576 vocab=49152.
Llama-arch code model [arXiv:2405.04324]."""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152, group=(BlockSpec("attn", "dense"),),
    fsdp=True,
    notes="MQA; full attention => long_500k skipped",
))
