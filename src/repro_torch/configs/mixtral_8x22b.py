"""Mixtral 8x22B — sparse MoE, 8 experts top-2, SWA. [arXiv:2401.04088]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", arch_type="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    num_experts=8, experts_per_token=2, sliding_window=4096,
    rope_theta=1e6,
    source="arXiv:2401.04088",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=0, d_ff=512, vocab_size=512,
        num_experts=4, experts_per_token=2, sliding_window=64)
