"""StableLM — dense GQA decoder. [hf:stabilityai/stablelm-2-1_6b family]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", arch_type="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    source="hf:stabilityai/stablelm-2-1_6b",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=8, head_dim=0, d_ff=512, vocab_size=512)
