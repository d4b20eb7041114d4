"""One engine scenario, run by the JAX package and by the port.

A scenario is a function ``run(P)`` of a side ``P`` (``JAX`` or
``TORCH``): the package's engine, graph, request and config classes, its
front door, and ``P.backend(cfg, ecfg, platform)``, which builds the
side's real-compute backend (``JaxBackend``, or ``TorchBackend`` on the
CPU) on the weights both sides share: ``init_params`` of the JAX package
from ``PRNGKey(0)`` (``JaxBackend``'s default), converted for the port by
``models.model.load_jax_params``. A scenario returns what it observed as
plain values; ``assert_same`` holds the port's record to the JAX
package's (tokens and counters equal, float arrays within ``LOGITS_ATOL``)
and each test file checks the port's record on its own.
"""
from __future__ import annotations

import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as j_base
import repro.core.backend as j_backend
import repro.core.costmodel as j_costmodel
import repro.core.engine as j_engine
import repro.core.graph as j_graph
import repro.core.request as j_request
import repro.core.temporal as j_temporal
import repro.data.workloads as j_workloads
import repro.kvcache.prefix_store as j_prefix_store
import repro.launch.http_server as j_http
import repro.models.model as j_model
import repro_torch.configs.base as t_base
import repro_torch.core.backend as t_backend
import repro_torch.core.costmodel as t_costmodel
import repro_torch.core.engine as t_engine
import repro_torch.core.graph as t_graph
import repro_torch.core.request as t_request
import repro_torch.core.temporal as t_temporal
import repro_torch.data.workloads as t_workloads
import repro_torch.kvcache.prefix_store as t_prefix_store
import repro_torch.launch.http_server as t_http
import repro_torch.models.model as t_model

# prefill logits of the two packages, float32 on the CPU
LOGITS_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """The module's torch ops on one thread, restored after it. The
    scenarios run many small ops; with one OpenMP thread per core in each
    of several test workers on the same cores, every op waits at a
    barrier for threads the other workers hold (a 4 s scenario took
    220 s so), while one thread costs nothing at these sizes. Test
    modules import this fixture to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TINY = dict(name="tiny-f32", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=50000,
            dtype="float32")


def _jax_params(cfg):
    """The JAX package's weights for ``cfg`` (either package's config), as
    a numpy pytree: what ``JaxBackend(cfg, ...)`` draws by default."""
    jcfg = j_base.ModelConfig(**dataclasses.asdict(cfg))
    return jax.tree.map(np.asarray,
                        j_model.init_params(jcfg, jax.random.PRNGKey(0)))


def _side(name, base, costmodel, engine, graph, request, temporal,
          workloads, prefix_store, http, model):
    return types.SimpleNamespace(
        name=name, ModelConfig=base.ModelConfig,
        get_smoke_config=base.get_smoke_config, Engine=engine.Engine,
        EngineConfig=engine.EngineConfig, AppGraph=graph.AppGraph,
        FuncNode=graph.FuncNode,
        Request=request.Request,
        ReqState=request.ReqState, TemporalConfig=temporal.TemporalConfig,
        build_workload=workloads.build_workload,
        A100_PCIE=costmodel.A100_PCIE,
        SHARED_OWNER=prefix_store.SHARED_OWNER, FrontDoor=http.FrontDoor,
        synth_tokens=http.synth_tokens, ResponseCache=http.ResponseCache,
        M=model)


JAX = _side("jax", j_base, j_costmodel, j_engine, j_graph, j_request,
            j_temporal, j_workloads, j_prefix_store, j_http, j_model)
TORCH = _side("torch", t_base, t_costmodel, t_engine, t_graph, t_request,
              t_temporal, t_workloads, t_prefix_store, t_http, t_model)


def _jax_backend(cfg, ecfg, platform):
    return j_backend.JaxBackend(cfg, ecfg, platform)


def _jax_dense_logits(backend, prompt):
    toks = [t % backend.cfg.vocab_size for t in prompt]
    logits, _ = j_model.prefill(backend.cfg, backend.params,
                                {"tokens": jnp.asarray([toks], jnp.int32)})
    return np.asarray(logits[0, 0], np.float32)


def _jax_pool_k(backend, ids):
    return np.asarray(backend.cache.k[:, jnp.asarray(ids)], np.float32)


def _jax_zero_blocks(backend, ids):
    idx = jnp.asarray(ids)
    backend.cache.k = backend.cache.k.at[:, idx].set(0)
    backend.cache.v = backend.cache.v.at[:, idx].set(0)


def port_params(cfg):
    """The shared weights as the port's params, on the CPU."""
    return t_model.load_jax_params(_jax_params(cfg), "cpu")


def _torch_backend(cfg, ecfg, platform):
    return t_backend.TorchBackend(cfg, ecfg, platform, device="cpu",
                                  params=port_params(cfg))


def _torch_dense_logits(backend, prompt):
    toks = [t % backend.cfg.vocab_size for t in prompt]
    logits, _ = t_model.prefill(
        backend.cfg, backend.params,
        {"tokens": torch.tensor([toks], dtype=torch.int32)})
    return logits[0, 0].float().numpy()


def _torch_pool_k(backend, ids):
    return backend.cache.k[:, ids].float().numpy()


def _torch_zero_blocks(backend, ids):
    backend.cache.k[:, ids] = 0
    backend.cache.v[:, ids] = 0


JAX.backend, JAX.dense_logits = _jax_backend, _jax_dense_logits
JAX.pool_k, JAX.zero_blocks = _jax_pool_k, _jax_zero_blocks
TORCH.backend, TORCH.dense_logits = _torch_backend, _torch_dense_logits
TORCH.pool_k, TORCH.zero_blocks = _torch_pool_k, _torch_zero_blocks


# ---------------------------------------------------------------------------
# the reference tests' engine drivers, for either side
# ---------------------------------------------------------------------------

def submit_one(P, eng, prompt, decode_len=64, name="n0"):
    g = P.AppGraph(f"app{len(eng.apps)}")
    g.add_agent(name, "w", len(prompt), decode_len=decode_len)
    return eng.submit_app(g, eng.clock, prompt_tokens={0: list(prompt)})


def step(eng):
    eng._process_events_until(eng.clock)
    eng.schedule_step()
    if eng.running:
        eng.clock += eng.execute_iteration()
    else:
        eng.clock += 1e-3


def run_out(eng, n):
    for _ in range(n):
        step(eng)
        if not (eng.running or eng.waiting or eng.events):
            break


def offload_now(P, eng, req, drain=True):
    """Force the stall -> offload path; ``drain=False`` leaves the D2H in
    flight so the shared stream stays backlogged for the next admission."""
    req.state = P.ReqState.STALLED
    eng.stalled[req.rid] = req
    if req in eng.running:
        eng.running.remove(req)
    req.fc_predicted_end = eng.clock + 1e9   # park: no predictive upload
    eng._start_offload(req)
    if drain:
        eng._process_events_until(eng.stream_free_at + 1e-9)
        eng.clock = max(eng.clock, eng.stream_free_at + 1e-9)


def shared_prompts(seed=0, prefix_blocks=3, bt=16):
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(0, 50000, prefix_blocks * bt)]
    sfx = [[int(t) for t in rng.integers(0, 50000, 7 + i)] for i in range(3)]
    return prefix, sfx


def record(eng, backend, **extra) -> dict:
    """What both sides must agree on: tokens per rid, every engine
    counter, the prefill logits still held, the truncation count."""
    rec = dict(tokens={k: list(v) for k, v in backend.generated.items()},
               metrics=dict(eng.metrics),
               logits=dict(backend.last_prefill_logits),
               truncated=backend.truncated_prompt_tokens)
    rec.update(extra)
    return rec


def caught(fn):
    """Run ``fn()``; return its warnings' messages."""
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in ws if issubclass(w.category,
                                                     UserWarning)]


def assert_same(want, got, path="record"):
    """``got`` (the port's record) equals ``want`` (the JAX package's):
    the same keys, equal ints, strings, bools and floats, float arrays
    within ``LOGITS_ATOL``."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same(want[k], got[k], f"{path}[{k!r}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0,
                                   err_msg=path)
    elif isinstance(want, (list, tuple)) and any(
            isinstance(x, (dict, np.ndarray)) for x in want):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{path}[{i}]")
    else:
        assert got == want, (path, want, got)


def run_both(scenario):
    """(JAX record, port record) of one scenario."""
    return scenario(JAX), scenario(TORCH)
