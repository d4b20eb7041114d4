"""Cluster serving plane: prefix-affinity routing over engine replicas,
gossiped radix summaries, and cost-model-priced cross-replica KV pulls
(paper §5 scaled out — each replica keeps its own Space/Temporal
schedulers; the router only decides *where* prefixes meet requests)."""
from .placement import (AffinityConfig, HashRing, PlacementDecision,
                        POLICIES, PrefixAffinity, RoundRobin)
from .replica import ReplicaHandle
from .router import ClusterApp, Router
from .summary import GossipConfig, ReplicaSummary

__all__ = [
    "AffinityConfig", "ClusterApp", "GossipConfig", "HashRing",
    "PlacementDecision", "POLICIES", "PrefixAffinity", "ReplicaHandle",
    "ReplicaSummary", "RoundRobin", "Router",
]
