"""Rules of the PyTorch port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package ``repro``, and importing the port loads no JAX module.
* The framework-free modules the port copies (control plane, configs, the
  workload samplers, the HTTP front door and response cache, the cluster
  plane) equal their ``src/repro`` originals, read as text,
  after renaming ``repro.`` to ``repro_torch.``: a change to one side
  without the other fails here.
"""
import ast
import inspect
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

COPIED = [f"core/{m}.py" for m in (
    "engine", "block_pool", "costmodel", "forecast", "graph", "pressure",
    "request", "spatial", "temporal", "policies", "transfers")]
COPIED += ["kvcache/prefix_store.py", "kvcache/radix_index.py",
           "data/workloads.py"]
COPIED += ["launch/http_server.py", "launch/response_cache.py"]
COPIED += [f"cluster/{m}.py" for m in (
    "__init__", "placement", "replica", "router", "summary")]
COPIED += sorted(str(p.relative_to(SRC / "repro"))
                 for p in (SRC / "repro" / "configs").glob("*.py"))


def rename(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files += examples
    assert len(files) > 30
    bad = {(str(f.relative_to(ROOT)), root) for f in files
           for root in _imported_roots(f)
           if root in ("jax", "jaxlib", "repro", "flax", "optax")}
    assert not bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.core.backend, repro_torch.launch.serve\n"
            "import repro_torch.launch.http_server, repro_torch.cluster\n"
            "import repro_torch.kernels.ops, repro_torch.configs.base\n"
            "import repro_torch.models.encdec, repro_torch.models.model\n"
            "import repro_torch.data.pipeline, repro_torch.launch.train\n"
            "import repro_torch.train.optimizer, repro_torch.train.train_loop\n"
            "import repro_torch.train.checkpoint\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "import repro_torch.models.sharding\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_original(rel):
    orig = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert copy == rename(orig)


def test_copied_workload_samplers_equal_original():
    from repro.data import pipeline as jp
    from repro_torch.data import pipeline as tp
    for fn in ("prompt_lengths", "output_lengths"):
        assert inspect.getsource(getattr(tp, fn)) == \
            inspect.getsource(getattr(jp, fn))


def test_cluster_frontend_equals_original():
    from repro.launch import serve as js
    from repro_torch.launch import serve as ts
    assert inspect.getsource(ts.ClusterFrontend) == \
        rename(inspect.getsource(js.ClusterFrontend))
