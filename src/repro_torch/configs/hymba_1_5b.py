"""Hymba 1.5B — hybrid-head: parallel attention + mamba heads per layer.

[arXiv:2411.13676]. GQA 25/5 attention heads in parallel with SSM heads,
ssm_state=16; most layers use sliding-window attention.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", arch_type="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    sliding_window=1024,
    source="arXiv:2411.13676",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="hymba-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=0, d_ff=512, vocab_size=512,
        ssm_state=16, ssm_heads=0, sliding_window=64)
