"""MiniCPM 2B — dense llama-like, trained with the WSD schedule.

[arXiv:2404.06395]. The WSD (warmup-stable-decay) schedule is implemented in
``repro_torch.train.optimizer.wsd_schedule`` and used by this config's train recipe.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", arch_type="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    source="arXiv:2404.06395",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="minicpm-smoke", num_layers=2, d_model=288, num_heads=4,
        num_kv_heads=4, head_dim=0, d_ff=512, vocab_size=512)
