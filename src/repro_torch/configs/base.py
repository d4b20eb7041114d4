"""Configuration system for the repro framework.

Every assigned architecture gets one module in ``repro/configs/`` exporting
``CONFIG`` (the full published configuration, exercised only via the
lower/compile dry-run) and ``smoke_config()`` (a reduced same-family variant
that runs a real forward/train step on CPU).

Input shapes are global across architectures (assigned by the task):

    train_4k     seq_len=4096    global_batch=256   (training)
    prefill_32k  seq_len=32768   global_batch=32    (inference prefill)
    decode_32k   seq_len=32768   global_batch=128   (inference decode, 1 tok)
    long_500k    seq_len=524288  global_batch=1     (long-context decode)
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters.

    ``arch_type`` selects the model family in ``repro_torch.models.model``:
      dense  — pre-norm GQA decoder (llama-like)
      moe    — dense attention + top-k routed expert FFN
      ssm    — Mamba2 SSD (attention-free)
      hybrid — parallel attention + SSM heads per layer (Hymba)
      vlm    — dense decoder consuming text + projected patch embeddings
      audio  — encoder-decoder (Whisper): conv frontend stubbed as frames
    """
    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int            # query heads (0 for pure SSM)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_router_aux_coef: float = 0.01
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_heads: int = 0         # mamba2 value heads (d_inner // ssm_head_dim)
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 64        # SSD chunk length
    # attention details
    sliding_window: Optional[int] = None     # published SWA window, if any
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # enc-dec (audio)
    encoder_layers: int = 0
    encoder_frames: int = 1500   # whisper 30 s -> 1500 frames after conv
    # vlm
    num_patch_tokens: int = 2880  # llava-next anyres: up to 5 tiles x 576
    # numerics
    dtype: str = "bfloat16"
    # serving/KV
    kv_block_size: int = 32      # tokens per KV block (MXU-friendly multiple)
    # ---- beyond-paper performance options (EXPERIMENTS.md §Perf) ----
    kv_quant_int8: bool = False       # int8 KV cache + per-token-head scales
    remat_policy: str = "full"        # "full" | "dots" (save matmul outputs)
    replicate_params: bool = False    # skip TP for sub-HBM models
    moe_capacity_factor: float = 1.25
    prefill_causal_skip: bool = False # skip masked KV blocks in prefill
    # training
    optimizer_state_dtype: str = "float32"
    # citation for the config values
    source: str = ""

    def __post_init__(self):
        assert self.arch_type in ARCH_TYPES, self.arch_type
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.arch_type in ("ssm", "hybrid") and self.ssm_heads == 0:
            d_inner = self.ssm_expand * self.d_model
            object.__setattr__(self, "ssm_heads", d_inner // self.ssm_head_dim)

    # ---- derived quantities -------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, h = self.d_model, self.head_dim
        embed = self.vocab_size * d * 2  # in + out (untied)
        per_layer = 0
        if self.arch_type != "ssm":
            q = d * self.num_heads * h
            kv = 2 * d * self.num_kv_heads * h
            o = self.num_heads * h * d
            per_layer += q + kv + o
        if self.arch_type in ("dense", "vlm", "audio", "hybrid"):
            per_layer += 3 * d * self.d_ff
        if self.arch_type == "moe":
            per_layer += self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        if self.arch_type in ("ssm", "hybrid"):
            di = self.d_inner
            per_layer += d * (2 * di + 2 * self.ssm_heads * self.ssm_state) \
                + di * d + self.ssm_heads * (2 + di // self.ssm_heads)
        n = embed + self.num_layers * per_layer
        if self.arch_type == "audio":
            enc_layer = 4 * d * d + 3 * d * self.d_ff + d * self.num_heads * h  # + cross-attn in dec
            n += self.encoder_layers * enc_layer
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses top-k experts only)."""
        if self.arch_type != "moe":
            return self.param_count()
        dense_like = dataclasses.replace(
            self, arch_type="dense",
            d_ff=self.d_ff * self.experts_per_token)
        return dense_like.param_count()

    def kv_bytes_per_token(self) -> int:
        if self.arch_type == "ssm":
            return 0
        itemsize = 2 if self.dtype == "bfloat16" else 4
        return 2 * self.num_layers * self.num_kv_heads * self.head_dim * itemsize


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "llava_next_mistral_7b",
    "mixtral_8x22b",
    "kimi_k2_1t_a32b",
    "whisper_large_v3",
    "stablelm_3b",
    "minicpm_2b",
    "qwen1_5_32b",
    "mamba2_130m",
    "hymba_1_5b",
    "glm4_9b",
]

# CLI ids (dashes) -> module names
ARCH_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}

# Dense/full-attention archs get a beyond-paper sliding-window serving
# variant for long_500k only (see DESIGN.md §4).
LONG_CONTEXT_FALLBACK_WINDOW = 8192


def get_config(arch: str) -> ModelConfig:
    arch = ARCH_ALIASES.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    arch = ARCH_ALIASES.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config()


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply per-shape serving variants (long-context SWA fallback)."""
    if shape.name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid") \
            and cfg.sliding_window is None:
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_FALLBACK_WINDOW)
    return cfg


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
