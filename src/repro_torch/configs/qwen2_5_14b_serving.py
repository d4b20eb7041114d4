"""Qwen2.5-14B — the paper's own evaluation model (§7.1), used by the
serving benchmarks' cost model (Fig 9/10 reproduction at paper scale)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", arch_type="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, qkv_bias=True,
    source="hf:Qwen/Qwen2.5-14B (paper §7.1)",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2.5-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=0, d_ff=512, vocab_size=512)
