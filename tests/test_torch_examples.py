"""The port's examples (``examples/torch_*.py``) on the CPU, against the
JAX package's examples where they compute the same thing.

* ``torch_quickstart.py`` prints the same lines as ``quickstart.py``,
  number for number (the engine alone, virtual time);
* ``torch_serve_multiagent.py --device cpu --apps 2`` finishes the same
  apps with the same decoded tokens and offloads as the engine run of
  ``serve_multiagent.py``, driven through ``torch_engine_pair``'s JAX side
  (each draws its own random weights, so only the counters are compared);
* ``torch_arch_zoo.py --device cpu`` runs for two archs and
  ``torch_train_small.py --device cpu --steps 3`` trains;
* without a card, each example with a model fails unless asked for the
  CPU.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_engine_pair import JAX
from torch_engine_pair import torch_one_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def example(name: str):
    """The example script ``name`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_jax_examples_lines():
    out = [subprocess.run([sys.executable, str(EXAMPLES / name)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
           for name in ("quickstart.py", "torch_quickstart.py")]
    assert "avg latency" in out[0]
    assert out[1] == out[0]


def jax_example_report(apps: int) -> dict:
    """``examples/serve_multiagent.py``'s engine run (JaxBackend, the
    glm4_9b smoke config), through the JAX side of ``torch_engine_pair``."""
    P = JAX
    cfg = P.get_smoke_config("glm4_9b")
    ecfg = P.EngineConfig.preset(
        "tokencake", gpu_blocks=128, host_blocks=256, max_running=8,
        temporal=P.TemporalConfig(score_threshold=-1.0,
                                  pressure_watermark=0.0))
    eng = P.Engine(ecfg, P.A100_PCIE,
                   backend=P.backend(cfg, ecfg, P.A100_PCIE))
    for t, g in P.build_workload("deep_research", qps=2.0, n_apps=apps,
                                 seed=0):
        for n in g.nodes.values():
            n.prompt_len = min(n.prompt_len, 64)
            n.decode_segments = [min(s, 16) for s in n.decode_segments]
        eng.submit_app(g, t)
    return eng.run(max_time=5000)


def test_serve_multiagent_matches_the_jax_example():
    rep, backend = example("torch_serve_multiagent").main(
        ["--device", "cpu", "--apps", "2"])
    want = jax_example_report(2)
    for key in ("apps_finished", "decoded_tokens", "offloads"):
        assert rep[key] == want[key], key
    assert rep["apps_finished"] == 2 and rep["offloads"] >= 1
    assert backend.device.type == "cpu"
    assert sum(map(len, backend.generated.values())) == rep["decoded_tokens"]


def test_serve_multiagent_serves_a_hybrid_arch_on_the_cpu():
    """``--arch hymba_1_5b``: the hybrid arch the backend once refused
    serves its apps, decoding tokens and offloading, as in the JAX
    example."""
    rep, backend = example("torch_serve_multiagent").main(
        ["--device", "cpu", "--apps", "2", "--arch", "hymba_1_5b"])
    assert backend.cfg.arch_type == "hybrid"
    assert rep["apps_finished"] == 2 and rep["offloads"] >= 1
    assert rep["decoded_tokens"] > 0
    assert backend.last_prefill_logits == {}     # per-request prefill
    assert rep["truncated_prompt_tokens"] == 0


@pytest.mark.parametrize("arch", ["hymba_1_5b", "kimi_k2_1t_a32b"])
def test_arch_zoo_runs_on_the_cpu(arch, capsys):
    example("torch_arch_zoo").main(["--device", "cpu", "--arch", arch])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "decode ok" in line and "smoke loss=" in line


def test_train_small_runs_on_the_cpu():
    hist = example("torch_train_small").main(["--device", "cpu",
                                              "--steps", "3"])
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(map(lambda h: h["loss"] == h["loss"], hist))    # finite


def test_examples_fail_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        example("torch_arch_zoo").main(["--arch", "glm4_9b"])
    with pytest.raises(RuntimeError, match="found no CUDA device"):
        example("torch_serve_multiagent").main(["--apps", "1"])
    with pytest.raises(RuntimeError, match="found no CUDA device"):
        example("torch_train_small").main(["--steps", "1"])
