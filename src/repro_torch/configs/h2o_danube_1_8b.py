"""h2o-danube-1.8b [dense]: 24L d=2560 32H GQA(kv=8) d_ff=6912 vocab=32000,
sliding-window attention (llama+mistral mix) [arXiv:2401.16818]."""
from repro_torch.models.blocks import BlockSpec
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
    vocab=32000, group=(BlockSpec("swa", "dense"),),
    window=4096, use_rolling_swa=True, long_context=True,
    notes="SWA rolling cache bounds memory => long_500k runs",
))
