"""Mamba2 130M — SSD (state-space duality), attention-free. [arXiv:2405.21060].

d_inner = 2*768 = 1536, ssm_head_dim 64 -> 24 value heads, d_state 128.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", arch_type="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    source="arXiv:2405.21060",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", num_layers=2, d_model=128, ssm_state=16,
        ssm_heads=0, vocab_size=512)
