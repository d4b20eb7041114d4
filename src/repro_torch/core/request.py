"""Request lifecycle model.

A request is one agent's LLM session: prefill(prompt) then decode segments
separated by function calls (paper Fig. 2b):

    Inference1 => FunctionCall => Inference2 => ...

State machine (paper §6.2 MCPManager: running, pending-offload, offloaded,
pending-upload, uploaded — plus queueing/terminal states the engine needs):

    WAITING -> RUNNING -> STALLED -(gate)-> PENDING_OFFLOAD -> OFFLOADED
       ^          |           |                                   |
       |          v           +--(call_finish, resident)----------+--> PENDING_UPLOAD
       +-- PREEMPTED                                                     -> UPLOADED -> RUNNING
    RUNNING -> FINISHED
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.graph import AgentNode, AppGraph, FuncNode


class ReqState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    STALLED = "stalled"                  # function call, cache resident
    PENDING_OFFLOAD = "pending_offload"  # D2H transfer in flight
    OFFLOADED = "offloaded"              # cache on host
    PENDING_UPLOAD = "pending_upload"    # H2D transfer in flight
    UPLOADED = "uploaded"                # cache back, waiting re-admission
    PREEMPTED = "preempted"              # evicted; must recompute
    FINISHED = "finished"


# states whose KV cache occupies device blocks
DEVICE_RESIDENT = (ReqState.RUNNING, ReqState.STALLED, ReqState.UPLOADED)


@dataclass
class Request:
    rid: str
    app_id: str
    node: AgentNode
    graph: AppGraph
    arrival: float
    prompt_tokens: List[int]
    critical: bool = False               # on app critical path (static)
    # request group for host-tier capacity quotas: the application family
    # (graph name), shared by every instance of the same app — one chatty
    # app family cannot squeeze other apps' promotable host inventory out
    # of the CPU cache tier (HostPool.group_quota_frac). Empty = untracked.
    group: str = ""

    state: ReqState = ReqState.WAITING
    segment: int = 0
    generated_in_segment: int = 0
    generated_total: int = 0

    # per-device block ids (TP mirroring, paper §5 Multi-GPU); device 0 is
    # exposed as ``gpu_blocks`` for the data-plane backend.
    gpu_blocks_by_device: dict = field(default_factory=dict)
    host_blocks: List[int] = field(default_factory=list)
    reserved_upload_blocks: List[int] = field(default_factory=list)
    from_reserved_pool: int = 0          # blocks drawn from reserved quota
    cached_prefix_blocks: int = 0        # prefix-cache hits at admission
    # ref-counted shared-prefix state (kvcache.prefix_store): the first
    # ``shared_prefix_blocks`` entries of every device's block table are
    # store-pinned shared blocks (read-only, not offloadable); the first
    # ``prefix_cached_tokens`` positions hold KV the prefill must not
    # recompute. With the radix index the token count is NOT necessarily
    # block-aligned: a mid-block branch point leaves a COW-forked partial
    # block at table index ``shared_prefix_blocks`` whose leading
    # ``prefix_cached_tokens % block_tokens`` positions are valid.
    shared_prefix_blocks: int = 0
    prefix_cached_tokens: int = 0

    current_fc: Optional[FuncNode] = None
    fc_start: float = 0.0
    fc_predicted_end: float = 0.0
    fc_actual_end: float = 0.0

    enqueue_time: float = 0.0            # last time it entered the queue
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    preempt_count: int = 0
    migration_count: int = 0             # offload+upload round trips
    recompute_tokens: int = 0            # tokens recomputed after eviction

    priority: float = 0.0                # P_req, refreshed per batch (Eq. 5)
    prefill_pending: int = 0             # tokens to (re)compute at admission
    # host-tier promotion in flight: the suffix prefill depends on KV the
    # copy stream is still uploading, so compute is gated until this time
    # (0.0 = no gate). Set by engine._start_promotion, inert once passed.
    # The gate tracks the transfer's live booking: a priority insert on
    # the stream re-books the slot and the TransferManager's reschedule
    # hook moves the gate with it. ``promo_tid`` identifies the latest
    # such transfer (wait-attribution introspection; cleared on evict).
    promo_ready_at: float = 0.0
    promo_tid: Optional[int] = None

    # ---- derived -------------------------------------------------------------
    @property
    def gpu_blocks(self) -> List[int]:
        return self.gpu_blocks_by_device.setdefault(0, [])

    @property
    def num_gpu_blocks(self) -> int:
        return len(self.gpu_blocks_by_device.get(0, []))

    @property
    def offloadable_blocks(self) -> int:
        """Private device blocks (shared prefix blocks stay resident)."""
        return max(self.num_gpu_blocks - self.shared_prefix_blocks, 0)

    @property
    def agent_type(self) -> str:
        return self.node.agent_type

    @property
    def context_len(self) -> int:
        return len(self.prompt_tokens) + self.generated_total

    @property
    def target_in_segment(self) -> int:
        return self.node.decode_segments[self.segment]

    @property
    def segment_done(self) -> bool:
        return self.generated_in_segment >= self.target_in_segment

    @property
    def remaining_tokens(self) -> int:
        rest = sum(self.node.decode_segments[self.segment + 1:])
        return rest + self.target_in_segment - self.generated_in_segment

    @property
    def done(self) -> bool:
        return (self.segment == len(self.node.decode_segments) - 1
                and self.segment_done)

    def next_fc(self) -> Optional[FuncNode]:
        if self.segment < len(self.node.func_calls):
            return self.node.func_calls[self.segment]
        return None

    def completion_frac(self) -> float:
        total = self.node.total_decode or 1
        return self.generated_total / total

    def blocks_needed(self, block_tokens: int, extra_tokens: int = 0) -> int:
        return -(-(self.context_len + extra_tokens) // block_tokens)
