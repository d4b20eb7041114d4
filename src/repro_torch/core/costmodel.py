"""Platform cost model (paper §4.2 Eq. 2, calibrated per §7.6).

The Temporal Scheduler's gate needs T_offload/T_upload per block and the
system decode throughput. Constants are calibrated per platform:

 * ``A100_PCIE`` reproduces the paper's Fig. 17 measurements for
   Qwen2.5-14B: 16 tok/block, 3 MiB/block bf16; 256 blocks -> 32.0 ms
   offload / 31.7 ms upload; recompute of 4096 tokens = 1815 ms
   (28.5x slower than the 63.7 ms round trip).
 * ``TPU_V5E`` is the target platform: same linear per-block model with the
   host-DMA bandwidth, plus ICI constants for the multi-pod path.

Key invariants:

* **One crossover rule everywhere** — ``promotion_cutoff`` (transfer
  time vs recompute time per block run) is the single source of the
  promote-vs-recompute decision; the host tier, the prefetcher and the
  cluster router all call it, the latter two on a ``make_link``-derived
  platform so the same rule prices PCIe, RDMA and TCP paths.
* **Precision reprices, never re-models** — int8 host/wire blocks halve
  ``block_bytes`` via ``KV_PRECISIONS``; every time formula is linear in
  bytes, so quantization changes inputs, not equations.
* **Virtual seconds only** — every function returns seconds on the
  engine's virtual clock; nothing here reads wall time.

The decision diagram lives in docs/ARCHITECTURE.md (promote vs
recompute); serving-level latency percentiles derived from these times
surface through ``GET /v1/report`` (docs/SERVING_API.md).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


# KV block precisions the transfer plane prices. ``fp16`` is the native
# device/pool precision (2 bytes/elem — the calibrated ``block_bytes``);
# ``int8_host`` halves the payload (1 byte/elem) for blocks that cooled
# into the host tier or ride a cross-replica wire. The per-(block, kv-head)
# fp32 scales add < 1% of the payload (2·Hkv floats vs bs·Hkv·D bytes) and
# are absorbed into the halved figure rather than modeled separately.
KV_PRECISIONS = ("fp16", "int8_host")

_PRECISION_DIVISOR = {"fp16": 1, "bf16": 1, "int8": 2, "int8_host": 2}


@dataclass(frozen=True)
class PlatformModel:
    name: str
    block_tokens: int           # tokens per KV block
    block_bytes: int            # bytes per block (all layers, bf16)
    offload_ms_per_block: float
    upload_ms_per_block: float
    transfer_fixed_ms: float    # per-transfer launch latency
    prefill_ms_per_token: float # recompute cost (linear regime)
    decode_ms_fixed: float      # per-iteration fixed cost
    decode_ms_per_seq: float    # marginal per-sequence cost per iteration
    hbm_bytes: int              # KV pool budget
    host_bytes: int             # CPU offload pool budget (paper: 100 GB)
    # transfer-stream chunking: platforms whose copy engine stages block
    # transfers through a fixed-size pinned staging buffer pay the launch
    # latency once per chunk of ``stream_chunk_blocks`` blocks, not once
    # per transfer (Mooncake-style swap granularity). 0 = unchunked: one
    # launch per transfer, bit-identical to the pre-economics model.
    stream_chunk_blocks: int = 0

    def _launches(self, n_blocks: int) -> int:
        """Per-transfer launch count: 1, or one per staging chunk."""
        if self.stream_chunk_blocks <= 0 or n_blocks <= 0:
            return 1
        return -(-n_blocks // self.stream_chunk_blocks)

    # ---- precision-tiered block sizing --------------------------------------
    def block_bytes_for(self, precision: str = "fp16") -> int:
        """Wire/storage bytes of one KV block at ``precision``.

        ``block_bytes`` is calibrated at the native fp16/bf16 pool layout;
        int8 tiers move half the payload. This single number is what every
        transfer-time and ledger path scales by, so the promote-vs-recompute
        crossover reprices automatically when blocks change precision."""
        div = _PRECISION_DIVISOR.get(precision)
        if div is None:
            raise ValueError(f"unknown KV precision {precision!r} "
                             f"(known: {sorted(_PRECISION_DIVISOR)})")
        return self.block_bytes // div

    def _per_block_ms(self, ms: float, precision: str) -> float:
        """Scale a calibrated per-block millisecond figure to ``precision``.

        fp16 returns the figure untouched (no float multiply — the legacy
        rows must stay bit-identical); other precisions scale by the
        byte ratio, since per-block copy time is bandwidth-bound."""
        if precision == "fp16":
            return ms
        return ms * (self.block_bytes_for(precision) / self.block_bytes)

    # ---- Eq. 2: T_transfer = T_offload(N) + T_upload(N) ---------------------
    def offload_time(self, n_blocks: int, precision: str = "fp16") -> float:
        return (self._launches(n_blocks) * self.transfer_fixed_ms
                + n_blocks * self._per_block_ms(self.offload_ms_per_block,
                                                precision)) / 1e3

    def upload_time(self, n_blocks: int, precision: str = "fp16") -> float:
        return (self._launches(n_blocks) * self.transfer_fixed_ms
                + n_blocks * self._per_block_ms(self.upload_ms_per_block,
                                                precision)) / 1e3

    def transfer_time(self, n_blocks: int, precision: str = "fp16") -> float:
        return (self.offload_time(n_blocks, precision)
                + self.upload_time(n_blocks, precision))

    def recompute_time(self, n_tokens: int) -> float:
        return n_tokens * self.prefill_ms_per_token / 1e3

    def decode_iter_time(self, batch_size: int) -> float:
        return (self.decode_ms_fixed
                + batch_size * self.decode_ms_per_seq) / 1e3

    def decode_throughput(self, batch_size: int) -> float:
        """System tokens/s at the given running batch.

        An empty batch produces no tokens: 0.0, not a fictitious floor
        (callers that need a progress rate for a *hypothetical* single
        request use :meth:`per_seq_decode_rate`, which clamps)."""
        if batch_size <= 0:
            return 0.0
        return batch_size / self.decode_iter_time(batch_size)

    def per_seq_decode_rate(self, batch_size: int) -> float:
        """tokens/s a single request progresses at (v_throughput in Alg. 1).

        This is the rate that decides whether a request admitted into freed
        blocks can COMPLETE within the scheduling window — using the system
        aggregate here admits long requests that still hold the blocks when
        the stalled agent's upload fires, causing preemption cascades.
        """
        return 1.0 / self.decode_iter_time(max(batch_size, 1))

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_tokens)

    def upload_lead_time(self, n_blocks: int,
                         stream_backlog: float = 0.0,
                         precision: str = "fp16") -> float:
        """Seconds between submitting an H2D upload of ``n_blocks`` now
        and its last byte landing: the serial stream's current backlog
        plus the copy itself. This is the minimum lead a *prefetch* needs
        over its target's activation to have the KV resident in time."""
        return max(stream_backlog, 0.0) + self.upload_time(n_blocks,
                                                           precision)

    # ---- transfer economics: promote-vs-recompute crossover -----------------
    def promote_gain(self, k: int, stream_backlog: float = 0.0,
                     precision: str = "fp16") -> float:
        """Seconds saved by uploading ``k`` host-cached blocks instead of
        recomputing their tokens in the suffix prefill.

        The upload side pays the earliest-stream-slot wait (``stream_
        backlog``: the shared copy stream is serial, so an admission that
        promotes while an offload/upload is in flight queues behind it)
        plus ``upload_time(k)``; the recompute side pays
        ``recompute_time(k * block_tokens)`` merged into the prefill the
        requester runs anyway. Positive = promoting beats recomputing.
        ``promote_gain(0)`` is 0 by definition (nothing moves, nothing
        recomputed). ``precision`` prices the *upload* side only — the
        recompute side regenerates full-precision KV either way — so an
        int8 host tier strictly widens the gain for every k."""
        if k <= 0:
            return 0.0
        return (self.recompute_time(k * self.block_tokens)
                - (max(stream_backlog, 0.0)
                   + self.upload_time(k, precision)))

    def promotion_cutoff(self, k_max: int, stream_backlog: float = 0.0,
                         precision: str = "fp16") -> int:
        """Blocks of a ``k_max``-block promotable run worth uploading: the
        argmax of cumulative ``promote_gain`` over ``0..k_max``.

        The promoted run must stay a contiguous table prefix, so the only
        free choice is where to cut it. Ties break toward the larger run
        (promoting at equal cost still populates the device tier), which
        also makes the zero-backlog unchunked decision the full run — the
        pre-economics (always-promote) behavior. A cut at 0 is a
        *recompute election*: the whole run is cheaper to recompute, e.g.
        when the stream is backlogged past the crossover. Interior cuts
        appear when the marginal block stops paying — on chunked-stream
        platforms a short tail past the last staging-chunk boundary costs
        a full extra launch for less than a chunk of saved recompute."""
        best_k, best_g = 0, 0.0
        for k in range(1, k_max + 1):
            g = self.promote_gain(k, stream_backlog, precision)
            if g >= best_g:
                best_k, best_g = k, g
        return best_k


# Qwen2.5-14B on A100-80GB PCIe — matches paper §7.6 within 1%.
# 3 MiB / 16-token block => 0.125 ms/block at ~24 GB/s effective PCIe.
A100_PCIE = PlatformModel(
    name="a100_pcie_qwen14b",
    block_tokens=16,
    block_bytes=3 * 1024 * 1024,
    offload_ms_per_block=0.1242,
    upload_ms_per_block=0.1230,
    transfer_fixed_ms=0.2,
    prefill_ms_per_token=0.443,      # 1815 ms / 4096 tokens
    # decode is weight-bandwidth-bound for 14B bf16 on A100 (28 GB / 1.9 TB/s
    # ~= 15 ms floor); the per-seq slope is the marginal KV-read cost
    decode_ms_fixed=16.0,
    decode_ms_per_seq=0.06,
    hbm_bytes=68 * 1024**3,          # KV pool after weights on 80 GB
    host_bytes=100 * 1024**3,        # paper reserves 100 GB CPU
)

# H20 96GB (Qwen2.5-32B single GPU) — lower compute, bigger HBM.
H20_QWEN32 = replace(
    A100_PCIE, name="h20_qwen32b",
    block_bytes=int(1.875 * 1024 * 1024),  # 64L 8kv 128dh 16tok bf16
    prefill_ms_per_token=0.95,
    decode_ms_fixed=33.0, decode_ms_per_seq=0.10,
    hbm_bytes=70 * 1024**3)

# 2xH20 TP2 (Qwen2.5-72B) — per §5 Multi-GPU both devices hold half the heads.
H20X2_QWEN72 = replace(
    A100_PCIE, name="2xh20_qwen72b",
    block_bytes=int(2.5 * 1024 * 1024),
    prefill_ms_per_token=1.6,
    decode_ms_fixed=42.0, decode_ms_per_seq=0.15,
    hbm_bytes=120 * 1024**3)

# TPU v5e target: KV offload rides the host DMA (~40 GB/s effective per
# chip), recompute uses the 197 TFLOP/s MXU. Blocks are 32 tokens to keep
# the Pallas paged-attention tiles MXU-aligned (DESIGN.md §2).
TPU_V5E = PlatformModel(
    name="tpu_v5e_qwen14b",
    block_tokens=32,
    block_bytes=6 * 1024 * 1024,
    offload_ms_per_block=0.155,
    upload_ms_per_block=0.155,
    transfer_fixed_ms=0.05,
    prefill_ms_per_token=0.30,
    decode_ms_fixed=5.0,
    decode_ms_per_seq=0.05,
    hbm_bytes=12 * 1024**3,          # 16 GB HBM minus weights shard
    host_bytes=100 * 1024**3,
)

PLATFORMS = {p.name: p for p in
             (A100_PCIE, H20_QWEN32, H20X2_QWEN72, TPU_V5E)}


# ---- inter-replica links ----------------------------------------------------
def remote_link(platform: PlatformModel, gbytes_per_s: float,
                fixed_ms: float = 0.5,
                chunk_blocks: int = 0) -> PlatformModel:
    """A cross-replica fabric as one more :class:`PlatformModel`.

    A remote replica is just another tier with its own bandwidth: the
    link's ``upload_time(k)`` is the wire time of pulling ``k`` KV blocks
    from a peer, so ``promote_gain`` / ``promotion_cutoff`` price
    pull-vs-recompute with the exact machinery the host-tier promotion
    cutoff uses — only the per-block milliseconds change. Precision
    awareness comes free: the link's per-block ms derives from
    ``block_bytes`` at fp16, and ``upload_time(k, precision)`` scales it
    by ``block_bytes_for(precision)/block_bytes`` — exactly the wire time
    of the smaller payload at the same GB/s. ``fixed_ms``
    models the pull RPC round-trip (summary validation + source pinning),
    ``chunk_blocks`` > 0 a fabric that stages through fixed-size bounce
    buffers (one launch per chunk, like the chunked PCIe stream).
    """
    ms_per_block = platform.block_bytes / (gbytes_per_s * 1e9) * 1e3
    return replace(
        platform,
        name=f"{platform.name}+link{gbytes_per_s:g}GBps",
        offload_ms_per_block=ms_per_block,
        upload_ms_per_block=ms_per_block,
        transfer_fixed_ms=fixed_ms,
        stream_chunk_blocks=chunk_blocks,
    )


# Named link presets (per-direction effective GB/s, not signaling rate):
# an RDMA NIC moving KV point-to-point, and a TCP fallback an order of
# magnitude slower — slow enough that short runs lose to recompute.
LINKS = {
    "rdma_100g": dict(gbytes_per_s=10.0, fixed_ms=0.5),
    "tcp_25g": dict(gbytes_per_s=2.5, fixed_ms=1.5),
}


def make_link(platform: PlatformModel, name: str = "rdma_100g")\
        -> PlatformModel:
    return remote_link(platform, **LINKS[name])
