"""Qwen1.5 32B — dense GQA with QKV bias. [hf:Qwen/Qwen1.5-0.5B family]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", arch_type="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064, qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=8, head_dim=0, d_ff=512, vocab_size=512)
