"""GLM-4 9B — dense, aggressive GQA (kv=2), RoPE. [hf:THUDM/glm-4-9b]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", arch_type="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    source="hf:THUDM/glm-4-9b",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="glm4-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=0, d_ff=512, vocab_size=512)
