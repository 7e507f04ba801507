"""Serving cost model per architecture (DESIGN.md §3 arch-applicability).

QUEST's optimizer prices an extraction by tokens; deploying it on a real
fleet needs tokens -> seconds/Joules per architecture. This module derives
first-order per-token costs from the ModelConfig (prefill FLOPs/token,
decode state bytes/token) and the roofline hardware constants, giving the
QUEST cost model its hardware-aware exchange rate (used by
benchmarks/common.derived_latency_s and reported per arch below).

SSM archs have O(1) decode state instead of a KV cache — exactly the
"cost-model constants change, technique unchanged" note of DESIGN.md.

The second half of this module is the *measured* side the async serving
tier needs (DESIGN.md §16): `LatencySeries` (bounded-reservoir percentile
estimates over whatever unit the caller samples in — wall seconds or the
frontend's deterministic pump ticks) and `TenantStats` (per-tenant queue
depth, admission/shed/cancel accounting, pool pages held, speculative
acceptance, and p50/p99 of queueing + completion latency). The frontend
maintains one `TenantStats` per tenant continuously; benchmarks snapshot
them as gateable counters.
"""
from __future__ import annotations

from bisect import insort
from dataclasses import dataclass, field

from repro_torch.models.config import ModelConfig

# published dense peaks of one H100 SXM: bf16 flop/s and HBM bytes/s
PEAK_FLOPS = 989e12      # bf16 / card
HBM_BW = 3.35e12         # bytes/s / card


class LatencySeries:
    """Streaming latency percentiles over a bounded window.

    Keeps the most recent `window` samples (FIFO) in sorted order, so
    `percentile` is exact over the window — deterministic for the tick-based
    benches, O(log w) insert, bounded memory for long-running frontends."""

    def __init__(self, window: int = 4096):
        self.window = max(1, int(window))
        self._fifo: list = []        # arrival order (for eviction)
        self._sorted: list = []      # value order (for percentiles)
        self.count = 0               # total samples ever observed
        self.total = 0.0

    def add(self, value) -> None:
        self.count += 1
        self.total += value
        self._fifo.append(value)
        insort(self._sorted, value)
        if len(self._fifo) > self.window:
            old = self._fifo.pop(0)
            self._sorted.remove(old)

    def percentile(self, p: float):
        """Exact percentile over the retained window (nearest-rank);
        None with no samples."""
        if not self._sorted:
            return None
        rank = max(0, min(len(self._sorted) - 1,
                          int(round((p / 100.0) * (len(self._sorted) - 1)))))
        return self._sorted[rank]

    @property
    def mean(self):
        return self.total / self.count if self.count else None

    def snapshot(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p99": self.percentile(99)}


@dataclass
class TenantStats:
    """Continuous per-tenant serving statistics (DESIGN.md §16). Counters
    are maintained by `serving/frontend.py` as requests move through the
    admission state machine; latency series sample in the frontend's time
    unit (pump ticks under the virtual clock, wall seconds otherwise)."""
    tenant: str
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    failed: int = 0
    shed: int = 0                  # backpressure: rejected with typed result
    cancelled: int = 0
    timeouts: int = 0
    queue_depth: int = 0           # currently waiting for admission
    queue_depth_peak: int = 0
    in_flight: int = 0             # admitted, not yet resolved
    pool_pages_held: int = 0       # estimated pages admitted-but-unfinished
    draft_tokens: int = 0          # speculative economy, summed at resolve
    accepted_tokens: int = 0
    queue_wait: LatencySeries = field(default_factory=LatencySeries)
    latency: LatencySeries = field(default_factory=LatencySeries)  # submit->done

    def note_queued(self) -> None:
        self.submitted += 1
        self.queue_depth += 1
        self.queue_depth_peak = max(self.queue_depth_peak, self.queue_depth)

    def acceptance_rate(self):
        return (self.accepted_tokens / self.draft_tokens
                if self.draft_tokens else None)

    def snapshot(self) -> dict:
        out = {k: getattr(self, k) for k in
               ("tenant", "submitted", "admitted", "completed", "failed",
                "shed", "cancelled", "timeouts", "queue_depth",
                "queue_depth_peak", "in_flight", "pool_pages_held",
                "draft_tokens", "accepted_tokens")}
        out["queue_wait"] = self.queue_wait.snapshot()
        out["latency"] = self.latency.snapshot()
        return out


@dataclass(frozen=True)
class ServingCosts:
    arch: str
    prefill_flops_per_token: float
    decode_flops_per_token: float
    kv_bytes_per_token: float        # cache growth per generated/ctx token
    state_bytes: float               # O(1) recurrent state (SSM), per seq
    prefill_tokens_per_s_chip: float
    decode_ms_per_token_chip: float  # memory-bound decode estimate @ ctx

    def extraction_seconds(self, prompt_tokens: int, output_tokens: int,
                           chips: int = 1) -> float:
        t_pre = prompt_tokens / (self.prefill_tokens_per_s_chip * chips)
        t_dec = output_tokens * self.decode_ms_per_token_chip / 1e3 / chips
        return t_pre + t_dec


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    if cfg.family == "ssm":
        return 0.0
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // max(cfg.attn_every, 1)
    elif cfg.family == "encdec":
        n_attn = cfg.num_layers
    else:
        n_attn = cfg.num_layers
    if cfg.use_mla:
        return n_attn * (cfg.kv_lora_rank + cfg.qk_rope_dim) * dtype_bytes
    return n_attn * 2 * nkv * hd * dtype_bytes


def recurrent_state_bytes(cfg: ModelConfig) -> float:
    if not cfg.mamba_version:
        return 0.0
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    conv_dim = di + (2 * N if cfg.mamba_version == 2 else 0)
    return cfg.num_layers * (di * N * 4 + (K - 1) * conv_dim * 2)


def serving_costs(cfg: ModelConfig, *, context: int = 4096,
                  mfu: float = 0.4) -> ServingCosts:
    """First-order costs at a given decode context length."""
    n_active = cfg.param_count(active_only=True)
    pre_flops = 2.0 * n_active
    dec_flops = 2.0 * n_active
    kv_tok = kv_bytes_per_token(cfg)
    state = recurrent_state_bytes(cfg)
    # decode: read all weights + the context's cache once per token
    weight_bytes = n_active * 2
    dec_bytes = weight_bytes + kv_tok * context + state
    return ServingCosts(
        arch=cfg.name,
        prefill_flops_per_token=pre_flops,
        decode_flops_per_token=dec_flops,
        kv_bytes_per_token=kv_tok,
        state_bytes=state,
        prefill_tokens_per_s_chip=mfu * PEAK_FLOPS / pre_flops,
        decode_ms_per_token_chip=1e3 * dec_bytes / HBM_BW,
    )


def cost_table(context: int = 4096) -> list[ServingCosts]:
    from repro_torch.configs import ARCH_IDS, get_config
    return [serving_costs(get_config(a), context=context) for a in ARCH_IDS]
