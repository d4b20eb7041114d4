"""Benchmark multi-agent applications (paper §7.1, Fig. 1).

Code-Writer: 11 agent types with frequent function calls (file I/O, search,
external test tools) — high memory pressure from many concurrent KV states.

Deep-Research: fewer agents, deeper dependency chains — stresses
critical-path optimization.

Lengths are sampled from ShareGPT-like ("d1") / AgentCode-like ("d2")
mixtures (see repro_torch.data.pipeline); arrivals are Poisson (§7.1).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.graph import (AppGraph, AIGenerationNode, DataAnalysisNode,
                              ExternalTestNode, FileQueryNode, FileReadNode,
                              FileWriteNode, GitNode, SearchNode,
                              UserConfirmNode)
from repro_torch.data.pipeline import output_lengths, prompt_lengths


def _p(rng, dataset):
    return prompt_lengths(rng, "sharegpt" if dataset == "d1" else "agentcode")


def _o(rng, dataset):
    return output_lengths(rng, "sharegpt" if dataset == "d1" else "agentcode")


def code_writer(rng: np.random.Generator, dataset: str = "d1") -> AppGraph:
    """11 agent types; mirrors Fig. 1a's programmer/reviewer/tester pipeline."""
    g = AppGraph("code_writer")
    p = lambda: _p(rng, dataset)
    o = lambda: _o(rng, dataset)

    def segs(n, scale=1):
        return [max(16, int(o() * scale)) for _ in range(n)]

    planner = g.add_agent("planner", "planner", p(), decode_len=o())
    arch = g.add_agent(
        "architect", "architect", p(),
        decode_segments=segs(3),
        func_calls=[FileQueryNode(), FileReadNode()], deps=[planner])
    ctx = g.add_agent(
        "context_reader", "context_reader", p(),
        decode_segments=segs(4, 0.5),
        func_calls=[FileReadNode(), FileQueryNode(), FileReadNode()],
        deps=[planner])
    prog_a = g.add_agent(
        "programmer_a", "programmer", p(),
        decode_segments=segs(6, 0.7),
        func_calls=[FileReadNode(), FileWriteNode(), SearchNode(),
                    FileWriteNode(), ExternalTestNode()], deps=[arch, ctx])
    prog_b = g.add_agent(
        "programmer_b", "programmer_2", p(),
        decode_segments=segs(6, 0.7),
        func_calls=[SearchNode(), FileWriteNode(), FileReadNode(),
                    FileWriteNode(), ExternalTestNode()], deps=[arch, ctx])
    searcher = g.add_agent(
        "api_searcher", "searcher", p() // 2,
        decode_segments=segs(3, 0.5),
        func_calls=[SearchNode(), SearchNode()], deps=[arch])
    reviewer = g.add_agent(
        "reviewer", "reviewer", p(),
        decode_segments=segs(3),
        func_calls=[FileReadNode(), AIGenerationNode(predict_time=8.0)],
        deps=[prog_a, prog_b])
    tester = g.add_agent(
        "tester", "tester", p(),
        decode_segments=segs(4, 0.6),
        func_calls=[ExternalTestNode(), GitNode(), ExternalTestNode()],
        deps=[prog_a, prog_b, searcher])
    debugger = g.add_agent(
        "debugger", "debugger", p(),
        decode_segments=segs(4, 0.7),
        func_calls=[ExternalTestNode(), FileWriteNode(),
                    ExternalTestNode()], deps=[tester])
    doc = g.add_agent(
        "doc_writer", "doc_writer", p() // 2,
        decode_segments=segs(3, 0.6),
        func_calls=[FileReadNode(), FileWriteNode()], deps=[reviewer])
    g.add_agent(
        "integrator", "integrator", p(),
        decode_segments=segs(3, 0.5),
        func_calls=[GitNode(), UserConfirmNode(predict_time=6.0)],
        deps=[debugger, doc, reviewer])
    return g


def deep_research(rng: np.random.Generator, dataset: str = "d1") -> AppGraph:
    """Fig. 1b: search -> summarize -> synthesize with deep chains."""
    g = AppGraph("deep_research")
    p = lambda: _p(rng, dataset)
    o = lambda: _o(rng, dataset)

    planner = g.add_agent("query_planner", "planner", p(), decode_len=o() // 2)
    searchers = [
        g.add_agent(f"searcher_{i}", "searcher", p() // 2,
                    decode_segments=[o() // 4, o() // 2],
                    func_calls=[SearchNode()], deps=[planner])
        for i in range(3)]
    summarizers = [
        g.add_agent(f"summarizer_{i}", "summarizer", p(),
                    decode_len=o(), deps=[searchers[i]])
        for i in range(3)]
    checker = g.add_agent(
        "cross_checker", "checker", p(),
        decode_segments=[o() // 2, o() // 2],
        func_calls=[SearchNode()], deps=summarizers)
    analyst = g.add_agent(
        "analyst", "analyst", p(),
        decode_segments=[o() // 2, o()],
        func_calls=[DataAnalysisNode()], deps=[checker])
    g.add_agent("writer", "writer", p(), decode_len=2 * o(),
                deps=[analyst, checker])
    return g


APPS = {"code_writer": code_writer, "deep_research": deep_research}


def poisson_arrivals(rng: np.random.Generator, qps: float,
                     n_apps: int) -> List[float]:
    gaps = rng.exponential(1.0 / qps, size=n_apps)
    return list(np.cumsum(gaps))


def build_workload(app: str = "code_writer", dataset: str = "d1",
                   qps: float = 0.5, n_apps: int = 20, seed: int = 0
                   ) -> List[Tuple[float, AppGraph]]:
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(rng, qps, n_apps)
    return [(t, APPS[app](rng, dataset)) for t in arrivals]


def session_workload(n_sessions: int = 8, qps: float = 0.2,
                     turns: int = 4, think_mean: float = 30.0,
                     think_sigma: float = 0.8, prompt_len: int = 384,
                     user_len: int = 64, gen_len: int = 32,
                     seed: int = 0) -> List[dict]:
    """Multi-turn agent sessions for the front door (fig22).

    Each session is a chat-shaped conversation: a system prompt, then
    ``~turns`` user turns whose full history is resent every turn (the
    prompt-caching deployment shape — see SNIPPETS.md). ``think`` is the
    gap between a turn's completion and the next submission, sampled
    lognormal around ``think_mean`` so the population spans the three
    TTL regimes: short gaps (stay resident), medium gaps (offload +
    predictive upload), and the conversation end (no next turn — only a
    TTL can reclaim the pin).

    Returns a list of session dicts::

        {"sid": str, "start": float, "prompt": [tok, ...],
         "turns": [{"user_tokens": [...], "max_tokens": int,
                    "think": float}, ...]}

    The driver chains turn ``j+1`` at ``finish(turn j) + think`` with
    prompt = previous prompt + previous response + new user tokens.
    """
    rng = np.random.default_rng(seed)
    starts = poisson_arrivals(rng, qps, n_sessions)
    sessions: List[dict] = []
    for i, t0 in enumerate(starts):
        n_turns = max(2, 1 + int(rng.poisson(max(turns - 1, 1))))
        turn_specs = []
        for j in range(n_turns):
            think = (float(rng.lognormal(np.log(think_mean), think_sigma))
                     if j else 0.0)
            turn_specs.append({
                "user_tokens": [int(x) for x in
                                rng.integers(0, 50000, user_len)],
                "max_tokens": int(gen_len),
                "think": think,
            })
        sessions.append({
            "sid": f"sess{i}", "start": float(t0),
            "prompt": [int(x) for x in rng.integers(0, 50000, prompt_len)],
            "turns": turn_specs,
        })
    return sessions
