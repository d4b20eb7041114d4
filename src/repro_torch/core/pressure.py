"""Pressure-aware coordination protocol (paper §3.2).

Both schedulers read one shared ``PressureSnapshot`` per scheduling step so
they never optimize against different notions of pressure: every offload must
free blocks some waiting request can use, and every upload must not displace
a more important active request.

Multi-device (§5 Multi-GPU): the snapshot carries per-device entries; the
aggregate fields are mins/sums as appropriate for TP admission (a request is
admitted only if blocks fit on *all* participating devices).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass(frozen=True)
class DevicePressure:
    device: int
    total_blocks: int
    free_blocks: int
    reserved_quota: int          # total blocks in the reserved partition
    reserved_outstanding: int    # quota not yet consumed by its agent types
    shared_free: int             # free minus outstanding reservations


@dataclass(frozen=True)
class PressureSnapshot:
    time: float
    devices: List[DevicePressure]
    # waiting demand (blocks), split by criticality (Eq. 3's D_critical)
    waiting_demand_critical: int
    waiting_demand_total: int
    waiting_count: int
    # temporal state
    offloadable_stalled_blocks: int   # stalled, resident, not yet offloaded
    pending_upload_debt: int          # blocks still owed to pending uploads
    host_free_blocks: int
    running_count: int
    # transfer-plane state: seconds of work already booked on the shared
    # copy stream when the snapshot was taken (the prefetch phase prices
    # its lead time with this; admission keeps reading the live value)
    stream_backlog_s: float = 0.0

    @property
    def total_blocks(self) -> int:
        return sum(d.total_blocks for d in self.devices)

    @property
    def free_blocks(self) -> int:
        # TP admission is limited by the tightest device
        return min(d.free_blocks for d in self.devices)

    @property
    def shared_free(self) -> int:
        return min(d.shared_free for d in self.devices)

    @property
    def usage(self) -> float:
        tot = self.total_blocks or 1
        return 1.0 - sum(d.free_blocks for d in self.devices) / tot

    def describe(self) -> str:
        return (f"t={self.time:.2f}s usage={self.usage:.2%} "
                f"free={self.free_blocks} shared_free={self.shared_free} "
                f"wait={self.waiting_count}({self.waiting_demand_total}blk, "
                f"crit {self.waiting_demand_critical}) "
                f"stalled_offloadable={self.offloadable_stalled_blocks} "
                f"upload_debt={self.pending_upload_debt} "
                f"host_free={self.host_free_blocks} "
                f"stream_backlog={self.stream_backlog_s:.3f}s")
