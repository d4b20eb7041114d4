"""Quickstart: define a multi-agent app with the TokenCake frontend API
(paper Fig. 5) and serve it, comparing TokenCake against the vLLM baseline,
through the PyTorch port's engine (the scheduling plane: virtual time from
the A100 cost model, no model and no device).

    python examples/torch_quickstart.py
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.costmodel import A100_PCIE
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.graph import AppGraph, SearchNode, DataAnalysisNode


def build_rag_app() -> AppGraph:
    """The paper's Fig. 5 example: a retrieval-augmented generation app."""
    g = AppGraph("rag")
    retrieve = g.add_func(SearchNode("retrieve", predict_time=2.0))
    reader = g.add_agent("reader", agent_type="reader",
                         prompt_len=1024, decode_segments=[128, 256],
                         func_calls=[retrieve])
    analyst = g.add_agent("analyst", agent_type="analyst",
                          prompt_len=768, decode_segments=[64, 192],
                          func_calls=[DataAnalysisNode(predict_time=4.0)],
                          deps=[reader])
    g.add_agent("writer", agent_type="writer", prompt_len=512,
                decode_len=384, deps=[reader, analyst])
    return g


def main():
    print("TokenCake quickstart — 12 concurrent RAG apps, 256-block pool\n")
    for mode in ("baseline", "tokencake"):
        eng = Engine(EngineConfig.preset(mode, gpu_blocks=256,
                                         max_running=32), A100_PCIE)
        for i in range(12):
            eng.submit_app(build_rag_app(), arrival=i * 0.8)
        rep = eng.run(max_time=10000)
        print(f"[{mode:9s}] avg latency {rep['avg_latency']:6.1f}s  "
              f"p90 {rep['p90_latency']:6.1f}s  "
              f"offloads {rep['offloads']:3d}  "
              f"effective KV util {rep['effective_utilization']:.1%}")
    print("\nTokenCake offloads reader/analyst KV during their tool calls "
          "and reserves capacity for the critical path (reader→analyst→"
          "writer).")


if __name__ == "__main__":
    main()
