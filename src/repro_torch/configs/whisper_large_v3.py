"""Whisper large-v3 — encoder-decoder ASR. [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is stubbed: ``input_specs``
provides precomputed encoder frame embeddings (1500 x d_model). The decoder
is the transformer exercised by decode shapes (self-attn KV cache +
fixed cross-attn cache).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", arch_type="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_frames=1500,
    source="arXiv:2212.04356",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=0, d_ff=512, vocab_size=512,
        encoder_layers=2, encoder_frames=32)
