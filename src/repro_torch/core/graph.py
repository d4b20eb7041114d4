"""TokenCake Frontend API (paper §3.1, Table 3).

Users describe a multi-agent application as a DAG. Nodes are agents
(LLM inference) or function-call stages; edges are data dependencies.
The API exposes the three signals serving systems normally lack:

  1. graph structure        -> Spatial Scheduler criticality (Eq. 5/6)
  2. function-call stages   -> Temporal Scheduler offload/upload windows
  3. performance metadata   -> predict_time seeds the forecaster (Eq. 1)

Example (paper Fig. 5)::

    g = AppGraph("rag")
    retrieve = g.add_func(SearchNode("retrieve", predict_time=2.0))
    reader   = g.add_agent("reader", agent_type="reader",
                           prompt_len=1024, decode_len=256,
                           func_calls=[retrieve])
    writer   = g.add_agent("writer", agent_type="writer",
                           prompt_len=512, decode_len=512,
                           deps=[reader])
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class FuncStage:
    name: str
    predict_time: float  # seconds


@dataclass
class FuncNode:
    """A function call, decomposed into sequential stages (paper §3.1).

    ``predict_time`` is the user's estimate for the whole call; stages give
    the Temporal Scheduler a live view of progress for upload timing.
    """
    name: str
    tool: str
    predict_time: float
    stages: List[FuncStage] = field(default_factory=list)
    variability: float = 0.0    # +- fraction of predict_time

    def __post_init__(self):
        if not self.stages:
            self.stages = [FuncStage("all", self.predict_time)]


# ---- pre-built FuncNode types (paper Table 3, latencies from Table 1) ------

def FileReadNode(name="file_read", predict_time=0.1):
    return FuncNode(name, "file_system", predict_time, variability=0.5)


def FileWriteNode(name="file_write", predict_time=0.1):
    return FuncNode(name, "file_system", predict_time, variability=0.5)


def FileQueryNode(name="file_query", predict_time=0.3):
    return FuncNode(name, "file_system", predict_time, variability=0.5)


def GitNode(name="git", predict_time=0.3):
    return FuncNode(name, "git", predict_time, variability=1.0)


def DatabaseNode(name="db", predict_time=0.5):
    return FuncNode(name, "database", predict_time, variability=0.8)


def SearchNode(name="search", predict_time=3.0):
    return FuncNode(name, "web_search", predict_time, variability=1.5,
                    stages=[FuncStage("issue", 0.5),
                            FuncStage("fetch", 2.0),
                            FuncStage("parse", 0.5)])


def DataAnalysisNode(name="analysis", predict_time=5.0):
    return FuncNode(name, "data_analysis", predict_time, variability=1.0,
                    stages=[FuncStage("load", 1.0), FuncStage("crunch", 3.0),
                            FuncStage("report", 1.0)])


def UserConfirmNode(name="confirm", predict_time=10.0):
    return FuncNode(name, "user", predict_time, variability=2.0)


def ExternalTestNode(name="ext_test", predict_time=8.0):
    return FuncNode(name, "test_tool", predict_time, variability=1.0,
                    stages=[FuncStage("build", 3.0), FuncStage("run", 4.0),
                            FuncStage("collect", 1.0)])


def AIGenerationNode(name="ai_gen", predict_time=15.0):
    return FuncNode(name, "ai_generation", predict_time, variability=3.0)


PREBUILT_NODES = {
    "FileReadNode": FileReadNode, "FileWriteNode": FileWriteNode,
    "SearchNode": SearchNode, "FileQueryNode": FileQueryNode,
    "DataAnalysisNode": DataAnalysisNode, "UserConfirmNode": UserConfirmNode,
    "ExternalTestNode": ExternalTestNode,
}


@dataclass
class AgentNode:
    """One agent = one LLM request with optional interleaved function calls.

    Execution is segments of decoding separated by function calls:
    ``prefill(prompt) -> decode(d0) -> fc0 -> decode(d1) -> fc1 -> ...``
    """
    node_id: int
    name: str
    agent_type: str
    prompt_len: int
    decode_segments: List[int]              # tokens generated per segment
    func_calls: List[Optional[FuncNode]]    # between segments (len-1 or pad)
    deps: List[int] = field(default_factory=list)

    @property
    def total_decode(self) -> int:
        return sum(self.decode_segments)


class AppGraph:
    """Application DAG + structural metrics used by both schedulers."""

    # distinct `finished` frontiers memoized per graph: a DAG of N nodes
    # has at most N+1 frontiers on any one execution, but long-lived
    # graphs (multi-turn sessions, reused templates) see many — bound
    # the memo so it cannot grow monotonically with session length
    _STE_CACHE_MAX = 64

    def __init__(self, name: str):
        self.name = name
        self._ids = itertools.count()
        self.nodes: Dict[int, AgentNode] = {}
        self.children: Dict[int, List[int]] = {}
        self._cache: Dict[str, object] = {}   # metrics cache (graph is static)
        # per-frontier steps-to-execution memo, LRU-bounded (see above)
        self._ste_cache: "OrderedDict[frozenset, Dict[int, float]]" = \
            OrderedDict()

    def _cached(self, key: str, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    # ---- construction ------------------------------------------------------
    def add_agent(self, name: str, agent_type: str, prompt_len: int,
                  decode_len: int = 0, decode_segments: Sequence[int] = (),
                  func_calls: Sequence[Optional[FuncNode]] = (),
                  deps: Sequence["int | AgentNode"] = ()) -> AgentNode:
        nid = next(self._ids)
        segs = list(decode_segments) if decode_segments else [decode_len]
        fcs = list(func_calls)
        # segments/calls interleave: seg0, fc0, seg1, fc1, ... segN
        while len(fcs) < len(segs) - 1:
            fcs.append(None)
        if fcs and len(fcs) == len(segs):
            # trailing func call with no following decode: add empty segment
            segs.append(0)
        dep_ids = [d.node_id if isinstance(d, AgentNode) else d for d in deps]
        node = AgentNode(nid, name, agent_type, prompt_len, segs, fcs,
                         dep_ids)
        self._cache.clear()
        self._ste_cache.clear()
        self.nodes[nid] = node
        self.children[nid] = []
        for d in dep_ids:
            self.children[d].append(nid)
        return node

    def add_func(self, fn: FuncNode) -> FuncNode:
        return fn  # FuncNodes live inside agents; kept for API parity (Fig 5)

    # ---- structural metrics -------------------------------------------------
    def topo_order(self) -> List[int]:
        return self._cached("topo", self._topo_order)

    def _topo_order(self) -> List[int]:
        indeg = {n: len(self.nodes[n].deps) for n in self.nodes}
        order, stack = [], [n for n, d in indeg.items() if d == 0]
        while stack:
            n = stack.pop()
            order.append(n)
            for c in self.children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    stack.append(c)
        assert len(order) == len(self.nodes), "graph has a cycle"
        return order

    def depth(self) -> Dict[int, int]:
        return self._cached("depth", self._depth)

    def _depth(self) -> Dict[int, int]:
        d = {}
        for n in self.topo_order():
            deps = self.nodes[n].deps
            d[n] = 1 + max((d[p] for p in deps), default=-1)
        return d

    def remaining_depth(self) -> Dict[int, int]:
        """Longest chain of downstream nodes (critical-path distance)."""
        return self._cached("rdepth", self._remaining_depth)

    def _remaining_depth(self) -> Dict[int, int]:
        rd = {}
        for n in reversed(self.topo_order()):
            rd[n] = 1 + max((rd[c] for c in self.children[n]), default=-1)
        return rd

    def work_estimate(self, node: AgentNode) -> float:
        """Rough seconds of LLM work + tool time for a node."""
        tool = sum(fc.predict_time for fc in node.func_calls if fc)
        return node.prompt_len * 5e-4 + node.total_decode * 0.03 + tool

    def critical_path(self) -> List[int]:
        """Longest-work path through the DAG."""
        return self._cached("cp", self._critical_path)

    def _critical_path(self) -> List[int]:
        topo = self.topo_order()
        best: Dict[int, Tuple[float, Optional[int]]] = {}
        for n in topo:
            node = self.nodes[n]
            w = self.work_estimate(node)
            pred_best = max(((best[p][0], p) for p in node.deps),
                            default=(0.0, None))
            best[n] = (pred_best[0] + w, pred_best[1])
        end = max(best, key=lambda n: best[n][0])
        path = []
        while end is not None:
            path.append(end)
            end = best[end][1]
        return list(reversed(path))

    def steps_to_execution(self, nid: int, finished: frozenset = frozenset(),
                           node_cost=None) -> float:
        """Forecast-priced distance until ``nid`` can start: the longest
        cost path through its *unfinished* ancestors (KVFlow's
        steps-to-execution, generalized from hop counts to seconds).

        ``node_cost`` prices one ancestor's remaining work (defaults to
        :meth:`work_estimate`); a node in ``finished`` contributes
        nothing and cuts the paths through it. A ready node (every dep
        finished) is at distance 0. The default-cost variant is memoized
        per ``finished`` frontier in an LRU bounded at
        ``_STE_CACHE_MAX`` — long-lived graphs (multi-turn sessions)
        must not grow the memo monotonically; callers with a live cost
        function (forecaster-priced, progress-scaled) bypass it."""
        if node_cost is not None:
            return self._steps_to_execution(finished, node_cost)[nid]
        eta = self._ste_cache.get(finished)
        if eta is None:
            eta = self._steps_to_execution(
                finished, lambda n: self.work_estimate(self.nodes[n]))
            self._ste_cache[finished] = eta
            while len(self._ste_cache) > self._STE_CACHE_MAX:
                self._ste_cache.popitem(last=False)
        else:
            self._ste_cache.move_to_end(finished)
        return eta[nid]

    def _steps_to_execution(self, finished, node_cost) -> Dict[int, float]:
        eta: Dict[int, float] = {}
        for n in self.topo_order():
            eta[n] = max((eta[d] + node_cost(d)
                          for d in self.nodes[n].deps if d not in finished),
                         default=0.0)
        return eta

    def on_critical_path(self) -> Dict[int, bool]:
        return self._cached(
            "on_cp", lambda: {n: n in set(self.critical_path())
                              for n in self.nodes})

    def struct_score(self, nid: int) -> float:
        """Structural importance f_struct (Eq. 5): depth + in/out degree."""
        scores = self._cached("struct", lambda: {
            n: self._struct_score(n) for n in self.nodes})
        return scores[nid]

    def _struct_score(self, nid: int) -> float:
        rd = self.remaining_depth()
        node = self.nodes[nid]
        out_deg = len(self.children[nid])
        in_deg = len(node.deps)
        max_rd = max(rd.values()) or 1
        return 0.6 * rd[nid] / max_rd + 0.25 * min(out_deg / 4.0, 1.0) \
            + 0.15 * min(in_deg / 4.0, 1.0)
