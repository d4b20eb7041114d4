"""The cluster plane on the port (``repro_torch.cluster``, verbatim copies
of the JAX package's): the same trace routed over simulated replicas gives
the JAX package's placements, routing metrics and report; a one-replica
cluster is the bare engine; ``ClusterFrontend`` counts bad calls; and the
launcher's ``--replicas`` mode runs.
"""
import json

import pytest

pytest.importorskip("torch")

import repro.cluster as j_cluster
import repro.core.costmodel as j_costmodel
import repro_torch.cluster as t_cluster
import repro_torch.core.costmodel as t_costmodel
from repro_torch.core.costmodel import A100_PCIE
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.data.workloads import build_workload
from repro_torch.launch import serve
from torch_engine_pair import torch_one_thread  # noqa: F401 (autouse)
from torch_engine_pair import JAX, TORCH, assert_same

CLUSTER = {"jax": (j_cluster, j_costmodel), "torch": (t_cluster, t_costmodel)}


def run_cluster(P, n, policy="affinity", link="rdma_100g", n_apps=3, seed=1):
    cluster, costmodel = CLUSTER[P.name]
    pull = link != "none"
    router = cluster.Router(
        lambda i: P.Engine(P.EngineConfig.preset(
            "vllm_prefix", gpu_blocks=640, max_running=16,
            remote_pull=pull), P.A100_PCIE),
        n, policy=policy,
        link=costmodel.make_link(P.A100_PCIE, link) if pull else None,
        gossip=cluster.GossipConfig(interval=2.0),
        policy_kw=(dict(saturate_factor=1.2, saturate_min=2)
                   if policy == "affinity" else None))
    for t, g in P.build_workload("code_writer", "d1", qps=1.0,
                                 n_apps=n_apps, seed=seed):
        router.submit_app(g, t)
    rep = router.run(max_time=20000.0)
    return router, rep


@pytest.mark.parametrize("replicas", [1, 3])
@pytest.mark.parametrize("link", ["rdma_100g", "none"])
@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_router_matches_jax(policy, link, replicas):
    (jr, jrep), (tr, trep) = (run_cluster(P, replicas, policy, link,
                                          n_apps=4) for P in (JAX, TORCH))
    assert {a: ca.placed for a, ca in tr.apps.items()} == \
        {a: ca.placed for a, ca in jr.apps.items()}
    assert_same(dict(jr.metrics), dict(tr.metrics))
    assert_same(jrep, trep)
    assert trep["apps_finished"] == 4
    assert not tr._pulls
    for h in tr.replicas:
        h.engine.prefix_store.check_invariants()


def test_single_replica_cluster_matches_bare_engine():
    eng = Engine(EngineConfig.preset("vllm_prefix", gpu_blocks=640,
                                     max_running=16), A100_PCIE)
    for t, g in build_workload("code_writer", "d1", qps=1.0, n_apps=3,
                               seed=1):
        eng.submit_app(g, t)
    bare = eng.run(max_time=20000.0)
    _, rep = run_cluster(TORCH, 1)
    assert rep["per_replica"][0] == bare       # exact, float-for-float
    assert rep["pulls"] == 0


def test_cluster_frontend_counts_bad_calls():
    router, _ = run_cluster(TORCH, 2, n_apps=1)
    front = serve.ClusterFrontend(router)
    out = front.call_start("nope/r0")
    assert out == {"ok": False, "op": "call_start", "rid": "nope/r0",
                   "error": "unknown rid or bad state"}
    rid = next(iter(front.states()))           # finished: no call pending
    assert front.call_start(rid)["ok"] is False
    assert front.call_finish(rid) == {
        "ok": False, "op": "call_finish", "rid": rid,
        "error": "unknown rid or no call in flight"}
    assert front.bad_calls == 3
    verbose = front.states(verbose=True)
    assert verbose["frontend_bad_calls"] == 3
    assert len(verbose["replicas"]) == 2
    assert verbose["routing"] == dict(router.metrics)
    rep = front.report()
    assert rep["frontend_bad_calls"] == 3 and len(rep["transfers"]) == 2


def test_serve_main_replicas(capsys):
    rep = serve.main(["--replicas", "3", "--apps", "4", "--json"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["apps_finished"] == rep["apps_finished"] == 4
    assert rep["routing"]["placements"] > 0
    assert len(rep["transfers"]) == 3
    assert rep["frontend_bad_calls"] == 0


def test_serve_main_refuses_real_compute_with_replicas():
    with pytest.raises(SystemExit):
        serve.main(["--replicas", "3", "--real-compute", "--device", "cpu"])
