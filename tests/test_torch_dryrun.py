"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU, with nothing compiled on the port's side.

* Per-device argument bytes, for every (arch x shape x mesh): the local
  shards of the DTensors ``build_step`` places equal, exactly, the sum of
  ``NamedSharding(mesh, spec).shard_shape(shape)`` bytes over the same
  inputs in the JAX package (``tests/jax_spec_dump.py``, one subprocess
  with 512 placeholder devices).
* Smoke pairs run end to end through ``run_one`` on a 2 x 2 fake mesh:
  status ok, collectives where something is sharded, and the layer
  extrapolation equal to the full count (the port counts every layer).
* FLOPs: on a one-device mesh the port's count for a smoke prefill and a
  smoke train step (remat, AdamW) lies within ``FLOP_BAND`` of XLA's
  ``cost_analysis()["flops"]`` for the same jitted JAX step on one CPU
  device, its layer scan and attention chunks unrolled. Measured over
  the ten archs' smoke configs at B 2, S 64: 0.738 (mamba2 train) to
  1.113 (whisper prefill). XLA also counts elementwise work (norms, SSD
  decays, AdamW), which the port's counter (matrix products and
  attention only) leaves out; above 1, XLA drops as dead code the
  projections that ``qkv_project`` computes and the cross-attention
  discards (the decoder's cross K/V, the encoder's cross Q), which the
  port computes.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import jax_spec_dump
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import decoder as JD
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import optimizer as JO
from repro_torch.configs import base as TB
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ssm as S

FLOP_BAND = (0.70, 1.15)
SMOKE_B, SMOKE_S = 2, 64


@pytest.fixture(scope="module", autouse=True)
def release_fake_group():
    """The fake process group the meshes stand over lives for this
    module only: other test files in the same worker find none."""
    yield
    import torch.distributed as dist
    from repro_torch.launch import mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh._MESHES.clear()


@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory):
    return jax_spec_dump.run(tmp_path_factory.mktemp("jax_specs"))


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", list(TB.INPUT_SHAPES))
@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_argument_bytes_equal_jax_shard_shapes(arch, shape, mesh_name,
                                               jax_dump):
    _, args, *_ = DR.build_step(arch, shape, mesh_name == "2x16x16")
    want = jax_dump[mesh_name][arch]["arg_bytes"][shape]
    assert DR.local_bytes(args) == want


def small_mesh(multi_pod=False):
    return make_mesh((2, 2), ("data", "model"))


def smoke_shape(monkeypatch, kind: str, seq: int, batch: int) -> str:
    """An input shape of ``kind`` at a smoke size, in the port's table."""
    name = f"smoke_{kind}"
    monkeypatch.setitem(TB.INPUT_SHAPES, name,
                        TB.InputShape(name, seq, batch, kind))
    return name


@pytest.mark.parametrize("arch,kind", [("glm4_9b", "train"),
                                       ("mixtral_8x22b", "decode"),
                                       ("hymba_1_5b", "prefill")])
def test_smoke_pair_runs_through_run_one(arch, kind, tmp_path, monkeypatch):
    """Three layers of the smoke config, 8 sequences of 256 tokens, on a
    2 x 2 mesh; three layers so that the 1- and 2-layer extrapolation
    says something. The record lands in ``out_dir`` and a second call
    reads it back."""
    monkeypatch.setattr(DR, "make_production_mesh", small_mesh)
    shape = smoke_shape(monkeypatch, kind, 256, 8)
    cfg = dataclasses.replace(TB.get_smoke_config(arch), num_layers=3)
    rec = DR.run_one(arch, shape, False, str(tmp_path), cfg_override=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["output_bytes"] > 0
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["cost_scan_corrected"]["flops"] == rec["cost"]["flops"]
    assert rec["cost_scan_corrected"]["per_layer_flops"] > 0
    for key in ("temp_bytes", "alias_bytes", "code_bytes"):
        assert key not in rec["memory"]
    saved = tmp_path / f"{arch}.{shape}.16x16.json"
    assert json.loads(saved.read_text()) == rec
    assert DR.run_one(arch, shape, False, str(tmp_path)) == rec


def test_a_failed_pair_is_recorded_and_the_sweep_goes_on(tmp_path,
                                                          monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no rule for this op")

    monkeypatch.setattr(DR, "run_step", boom)
    rec = DR.run_one("glm4_9b", "decode_32k", False, str(tmp_path))
    assert rec["status"] == "fail"
    assert rec["error"] == "RuntimeError: no rule for this op"
    assert "Traceback" in rec["traceback"]
    n_ok, n = DR.main(["--arch", "glm4_9b", "--out", str(tmp_path)])
    assert (n_ok, n) == (0, 4)
    assert len(list(tmp_path.glob("glm4_9b.*.16x16.json"))) == 4


def test_meta_inputs_take_the_chunked_plain_scan(monkeypatch):
    """B14's plain version is the token-sequential recurrence; on meta
    tensors the mixer takes the chunked plain scan (the reference's
    prefill computation) and never reaches ``ops.ssd_scan``."""
    cfg = TB.get_smoke_config("mamba2_130m")
    lp = {k: v[0] for k, v in
          S.init_ssm(cfg, None, 1, torch.bfloat16, "meta").items()}

    def refuse(*a, **k):
        raise AssertionError("ops.ssd_scan reached on meta inputs")

    monkeypatch.setattr(S.ops, "ssd_scan", refuse)
    x = torch.empty((2, 128, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    out, (conv, state) = S.ssm_mixer(cfg, lp, x)
    assert out.is_meta and out.shape == x.shape
    assert state.shape == (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)


def xla_flops(arch: str, kind: str) -> float:
    """XLA's count for the JAX package's step on one CPU device, every
    scan unrolled (``set_unroll``, ``set_full_attn``)."""
    cfg = jax_smoke_config(arch)
    dt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    params = JM.param_specs(cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((SMOKE_B, SMOKE_S), jnp.int32)}
    if cfg.arch_type == "audio":
        batch["frames"] = jax.ShapeDtypeStruct(
            (SMOKE_B, cfg.encoder_frames, cfg.d_model), dt)
    JD.set_unroll(True)
    JL.set_full_attn(True)
    try:
        if kind == "train":
            batch["targets"] = batch["tokens"]
            JD.set_remat(True)
            ocfg = JO.AdamWConfig(state_dtype=cfg.optimizer_state_dtype)
            opt = jax.eval_shape(lambda p: JO.init_opt_state(ocfg, p),
                                 params)

            def step(p, o, b):
                (loss, _), g = jax.value_and_grad(
                    lambda q: JM.loss_fn(cfg, q, b), has_aux=True)(p)
                p, o, _ = JO.apply_adamw(ocfg, p, g, o)
                return p, o, loss

            compiled = jax.jit(step).lower(params, opt, batch).compile()
        else:
            compiled = jax.jit(lambda p, b: JM.prefill(cfg, p, b)).lower(
                params, batch).compile()
    finally:
        JD.set_unroll(False)
        JL.set_full_attn(False)
        JD.set_remat(False)
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    return float(cost["flops"])


@pytest.mark.parametrize("arch,kind", [("glm4_9b", "train"),
                                       ("whisper_large_v3", "prefill")])
def test_flops_within_a_band_of_xla(arch, kind, monkeypatch):
    name = smoke_shape(monkeypatch, kind, SMOKE_S, SMOKE_B)
    monkeypatch.setattr(DR, "make_production_mesh",
                        lambda multi_pod=False: make_mesh((1, 1),
                                                          ("data", "model")))
    got = DR.run_step(arch, name, False, TB.get_smoke_config(arch))
    assert got["collectives"]["total"] == 0        # one device
    ratio = got["flops"] / xla_flops(arch, kind)
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio
