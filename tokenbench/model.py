"""A configuration file read into the serving package's ``ModelConfig``,
and the weights of a run, made from its seed on the device.

``configs/<name>.json`` holds the published config (``config``, with the
keys listed in ``reduced`` changed), the few settings the serving package
reads off the model family (``port``), what was assumed, and the
deployment it stands for. The weights are drawn here, not by the serving
package, in the layout ``TorchBackend(params=...)`` takes, and handed to
both the served model and the reference.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def shapes(spec: dict) -> dict:
    """The sizes both sides use, from a configuration file's ``config``."""
    c = spec["config"]
    h = c["num_attention_heads"]
    return dict(
        layers=c["num_hidden_layers"], d=c["hidden_size"], heads=h,
        kv_heads=c["num_key_value_heads"], head_dim=c["hidden_size"] // h,
        ff=c["intermediate_size"], vocab=c["vocab_size"],
        experts=c.get("num_local_experts", 0),
        top_k=c.get("num_experts_per_tok", 0),
        rope_theta=float(c["rope_theta"]),
        qkv_bias=bool(spec["port"]["qkv_bias"]))


def model_config(spec: dict):
    """The serving package's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig

    s, port = shapes(spec), spec["port"]
    return ModelConfig(
        name=spec["name"], arch_type=port["arch_type"],
        num_layers=s["layers"], d_model=s["d"], num_heads=s["heads"],
        num_kv_heads=s["kv_heads"], head_dim=s["head_dim"], d_ff=s["ff"],
        vocab_size=s["vocab"], num_experts=s["experts"],
        experts_per_token=s["top_k"], qkv_bias=s["qkv_bias"],
        rope_theta=s["rope_theta"],
        sliding_window=spec["config"].get("sliding_window"),
        moe_capacity_factor=port.get("moe_capacity_factor", 1.25),
        dtype="bfloat16", source=spec["source"])


def make_params(s: dict, seed: int, device) -> dict:
    """Random bf16 weights from ``seed``, one generator call per stacked
    tensor, on ``device``: the scales of the serving package's initialiser
    (1/sqrt(fan-in); the output projections also over sqrt(layers)), the
    router in float32, and biases and norm gains drawn at 0.02."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    L, d, V = s["layers"], s["d"], s["vocab"]
    hd, kvd, f, e = (s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"],
                     s["ff"], s["experts"])

    def normal(shape, scale, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(scale)

    layers = {"wq": normal((L, d, hd), d ** -0.5),
              "wk": normal((L, d, kvd), d ** -0.5),
              "wv": normal((L, d, kvd), d ** -0.5),
              "wo": normal((L, hd, d), 1 / math.sqrt(hd * L)),
              "attn_norm": normal((L, d), 0.02),
              "mlp_norm": normal((L, d), 0.02)}
    if s["qkv_bias"]:
        layers.update(bq=normal((L, hd), 0.02), bk=normal((L, kvd), 0.02),
                      bv=normal((L, kvd), 0.02))
    if e:
        layers.update(wr=normal((L, d, e), d ** -0.5, torch.float32),
                      we1=normal((L, e, d, f), d ** -0.5),
                      we3=normal((L, e, d, f), d ** -0.5),
                      we2=normal((L, e, f, d), 1 / math.sqrt(f * L)))
    else:
        layers.update(w1=normal((L, d, f), d ** -0.5),
                      w3=normal((L, d, f), d ** -0.5),
                      w2=normal((L, f, d), 1 / math.sqrt(f * L)))
    return {"embed": normal((V, d), 0.02),
            "unembed": normal((d, V), d ** -0.5),
            "final_norm": normal((d,), 0.02), "layers": layers}
