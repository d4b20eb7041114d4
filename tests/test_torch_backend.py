"""TorchBackend (the PyTorch port) against JaxBackend, on the CPU.

* The same engine trace — two small deep_research apps under the
  tokencake policy with offloads forced — run once by ``repro.core`` with
  ``JaxBackend`` and once by ``repro_torch.core`` with ``TorchBackend`` on
  the same weights, gives identical tokens per request and the same
  offload count.
* The decode invariants of ``test_backend_decode.py`` hold for the port:
  an exactly-full request never writes another request's block, an
  offload -> upload round trip is bit-exact and decode continues as if
  never interrupted, and a re-admitted request is re-prefilled.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.backend import JaxBackend
from repro.core.costmodel import A100_PCIE as J_A100
from repro.core.engine import Engine as JEngine
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.temporal import TemporalConfig as JTemporalConfig
from repro.data.workloads import build_workload as j_build_workload
from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import TorchBackend
from repro_torch.core.costmodel import A100_PCIE
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.graph import AppGraph
from repro_torch.core.request import Request
from repro_torch.core.temporal import TemporalConfig
from repro_torch.data.workloads import build_workload
from repro_torch.models import model as M

TINY = dict(name="tiny-f32", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            dtype="float32")
CFG = ModelConfig(**TINY)
BT = A100_PCIE.block_tokens   # 16


def _shrink(workload):
    for _, g in workload:
        for n in g.nodes.values():
            n.prompt_len = min(n.prompt_len, 48)
            n.decode_segments = [min(s, 8) for s in n.decode_segments]
    return workload


def _engine_cfg(mk, temporal):
    return mk.preset("tokencake", gpu_blocks=96, host_blocks=128,
                     max_running=8,
                     temporal=temporal(score_threshold=-1.0,
                                       pressure_watermark=0.0))


def test_engine_trace_matches_jax_token_for_token():
    jcfg = JModelConfig(**TINY)
    jecfg = _engine_cfg(JEngineConfig, JTemporalConfig)
    jback = JaxBackend(jcfg, jecfg, J_A100)
    jeng = JEngine(jecfg, J_A100, backend=jback)
    for t, g in _shrink(j_build_workload("deep_research", qps=2.0,
                                         n_apps=2, seed=0)):
        jeng.submit_app(g, t)
    jrep = jeng.run(max_time=5000)

    params = M.load_jax_params(jax.tree.map(np.asarray, jback.params),
                               "cpu")
    ecfg = _engine_cfg(EngineConfig, TemporalConfig)
    back = TorchBackend(CFG, ecfg, A100_PCIE, device="cpu", params=params)
    eng = Engine(ecfg, A100_PCIE, backend=back)
    for t, g in _shrink(build_workload("deep_research", qps=2.0, n_apps=2,
                                       seed=0)):
        eng.submit_app(g, t)
    rep = eng.run(max_time=5000)

    assert rep["apps_finished"] == jrep["apps_finished"] == 2
    assert rep["offloads"] >= 1
    assert rep["offloads"] == jrep["offloads"]
    assert rep["decoded_tokens"] == jrep["decoded_tokens"] > 0
    assert rep["truncated_prompt_tokens"] == 0
    assert back.generated.keys() == jback.generated.keys()
    for rid, toks in jback.generated.items():
        assert back.generated[rid] == toks, rid


# ---------------------------------------------------------------------------
# the decode invariants of test_backend_decode.py, on the port
# ---------------------------------------------------------------------------

def mk_backend(gpu_blocks=24, host_blocks=16):
    ecfg = EngineConfig(mode="baseline", gpu_blocks=gpu_blocks,
                        host_blocks=host_blocks)
    return TorchBackend(CFG, ecfg, A100_PCIE, seed=0, device="cpu")


def mk_req(rid, prompt, blocks):
    g = AppGraph("t")
    node = g.add_agent("a", "worker", len(prompt), decode_len=64)
    r = Request(rid=rid, app_id="app", node=node, graph=g, arrival=0.0,
                prompt_tokens=list(prompt))
    r.gpu_blocks_by_device[0] = list(blocks)
    return r


def test_exact_boundary_write_cannot_corrupt_block_zero():
    backend = mk_backend()
    rng = np.random.default_rng(11)
    victim = mk_req("victim", [int(t) for t in rng.integers(0, 128, 8)],
                    blocks=[0])
    backend.decode([victim])
    block0_k = backend.cache.k[:, 0].clone()
    block0_v = backend.cache.v[:, 0].clone()

    full = mk_req("full", [int(t) for t in rng.integers(0, 128, 2 * BT)],
                  blocks=[1, 2])                   # capacity exactly full
    backend.decode([full])
    assert torch.equal(backend.cache.k[:, 0], block0_k)
    assert torch.equal(backend.cache.v[:, 0], block0_v)
    assert 0 <= backend.generated["full"][0] < CFG.vocab_size
    assert backend.cache_len["full"] == 2 * BT


def test_offload_upload_roundtrip_bit_exact_and_decode_continues():
    steps_before, steps_after = 4, 4
    rng = np.random.default_rng(7)
    prompt = [int(t) for t in rng.integers(0, 128, 20)]

    ref_backend = mk_backend()
    ref = mk_req("r", prompt, blocks=[1, 2, 3])
    for _ in range(steps_before + steps_after):
        ref_backend.decode([ref])

    backend = mk_backend()
    r = mk_req("r", prompt, blocks=[1, 2, 3])
    for _ in range(steps_before):
        backend.decode([r])
    snap_k = backend.cache.k[:, [1, 2, 3]].clone()
    r.host_blocks = [0, 1, 2]
    backend.copy_out(r)
    backend.cache.k[:, [1, 2, 3]] = 0              # blocks get recycled
    backend.cache.v[:, [1, 2, 3]] = 0
    r.reserved_upload_blocks = [10, 11, 12]
    backend.copy_in(r)
    r.gpu_blocks_by_device[0] = [10, 11, 12]
    r.reserved_upload_blocks = []
    assert torch.equal(backend.cache.k[:, [10, 11, 12]], snap_k)
    for _ in range(steps_after):
        backend.decode([r])
    assert backend.generated["r"] == ref_backend.generated["r"]


@pytest.mark.parametrize("same_ids", [True, False],
                         ids=["evicted-same-ids", "preempted-fresh-ids"])
def test_readmitted_request_is_reprefilled(same_ids):
    rng = np.random.default_rng(17 if same_ids else 13)
    prompt = [int(t) for t in rng.integers(0, 128, 12)]

    ref_backend = mk_backend()
    ref = mk_req("r", prompt, blocks=[1, 2])
    for _ in range(6):
        ref_backend.decode([ref])

    backend = mk_backend()
    r = mk_req("r", prompt, blocks=[1, 2])
    for _ in range(3):
        backend.decode([r])
    if same_ids:
        backend.invalidate("r")                 # engine._evict hook
        other = mk_req("other", [int(t) for t in rng.integers(0, 128, 30)],
                       blocks=[1, 2])
        backend.decode([other])                 # rewrites the same blocks
        backend.invalidate("other")
        r.gpu_blocks_by_device[0] = [1, 2]
    else:
        backend.cache.k[:, [1, 2]] = 0
        backend.cache.v[:, [1, 2]] = 0
        r.gpu_blocks_by_device[0] = [5, 6]
    for _ in range(3):
        backend.decode([r])
    assert backend.generated["r"] == ref_backend.generated["r"]


def test_unported_archs_raise_and_name_the_later_slice():
    ecfg = EngineConfig(mode="baseline", gpu_blocks=8, host_blocks=8)
    for cfg in (ModelConfig(**dict(TINY, arch_type="moe", num_experts=4,
                                   experts_per_token=2)),
                ModelConfig(**dict(TINY, sliding_window=8))):
        with pytest.raises(NotImplementedError, match="later slices"):
            TorchBackend(cfg, ecfg, A100_PCIE, device="cpu")
