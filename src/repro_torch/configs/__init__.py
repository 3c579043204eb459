"""Architecture configs (port of ``repro.configs``): every module below
registers one config on import."""

from .base import ArchConfig, register, get_config, list_configs  # noqa: F401
from . import (mamba2_370m, granite_20b, h2o_danube_1_8b, deepseek_7b,   # noqa: F401
               deepseek_67b, grok1_314b, deepseek_moe_16b, jamba_v01_52b,
               seamless_m4t_medium, qwen2_vl_7b, ea3d_1m)
