"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 (paper-table config).

[arXiv:2501.kimi2]. GQA kv=8, per-expert d_ff=2048, vocab 163840.
Optimizer state kept in bf16 for the trillion-param dry-run (see DESIGN.md).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    num_experts=384, experts_per_token=8,
    optimizer_state_dtype="bfloat16",
    source="arXiv:2501.kimi2",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="kimi-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=0, d_ff=128, vocab_size=512,
        num_experts=4, experts_per_token=2,
        optimizer_state_dtype="float32")
