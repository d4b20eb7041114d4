"""LLaVA-NeXT (Mistral-7B backbone) — [hf:llava-hf/llava-v1.6-mistral-7b-hf].

VLM: the transformer backbone only; the SigLIP/CLIP vision tower and the
2-layer MLP projector are stubbed — ``input_specs`` feeds precomputed patch
embeddings (anyres tiling: up to 5 tiles x 24x24 = 2880 patch tokens).
Mistral-7B uses sliding-window attention (window 4096).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", arch_type="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, sliding_window=4096,
    num_patch_tokens=2880, rope_theta=1e6,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llava-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=0, d_ff=512, vocab_size=512,
        num_patch_tokens=16, sliding_window=64)
