"""Adaptive sync-protocol planner: FULL_COPY vs DELTA vs CDC_DEDUP.

The reference picks a mover protocol statically per CR; "Enabling
Cost-Benefit Analysis of Data Sync Protocols" (PAPERS.md) shows the
optimal choice flips with change rate, dedup ratio, and link quality —
signals a live ``SyncStatsBook`` (engine/syncstats.py) now tracks. This
module prices every candidate protocol per file with an explicit cost
model and picks the cheapest:

    cost(p) = wire_bytes(p) / bandwidth
            + round_trips(p) * latency
            + device_s(p)

    FULL_COPY:  wire = size                          rt = 1  dev = 0
    DELTA:      wire = sig_bytes(size)               rt = 2  dev = scan
                     + change_rate * size
                     + op-stream overhead
    CDC_DEDUP:  wire = (1 - dedup_ratio) * size      rt = 2  dev = chunk
                     + per-chunk metadata

``sig_bytes`` comes from the engine's own geometry seam
(deltasync.signature_geometry) — the real wire cost of the signature
round trip, not a re-derived approximation. Every decision is timed as
a ``plan.decide`` span and bumps
``volsync_svc_protocol_selected_total{protocol,reason}``. The
``VOLSYNC_SYNC_PROTO=auto|full|delta|cdc`` env knob overrides the model
per call (reason ``override``); movers opt into probe runs that force
an unpriced protocol once to seed an empty book (reason ``probe``).

Ports ``volsync_tpu/engine/protoplan.py``: the same constants, scores
and rules. The port's ``obs.span`` times the ``plan.decide`` span but
keeps no attributes (the port has no flight recorder), so the losing
scores live on the returned ``PlanDecision`` only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from volsync_tpu_torch import envflags
from volsync_tpu_torch.engine.deltasync import signature_geometry
from volsync_tpu_torch.engine.syncstats import SyncStats
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.obs import span

#: Protocol names — also the VOLSYNC_SYNC_PROTO vocabulary and the
#: ``protocol`` label values of svc_protocol_selected_total.
FULL_COPY = "full"
DELTA = "delta"
CDC_DEDUP = "cdc"
PROTOCOLS = (FULL_COPY, DELTA, CDC_DEDUP)

#: Closed vocabulary of the ``reason`` label (metrics.py): why a
#: decision came out the way it did.
REASON_COST = "cost"          # the model won on price
REASON_OVERRIDE = "override"  # VOLSYNC_SYNC_PROTO pinned it
REASON_PROBE = "probe"        # exploration to seed an empty stat book
REASON_NO_BASIS = "no_basis"  # destination has no prior copy
REASON_SIZE_CAP = "size_cap"  # too large for a whole-file blob

#: Device-time model terms: sustained delta-scan and CDC chunk+hash
#: rates. Deliberately conservative constants rather than live
#: measurements — device time is the smallest cost term (the link
#: dominates by orders of magnitude on any realistic deployment), so a
#: rough floor is enough to break ties without letting a noisy kernel
#: timing flip protocol choice.
DEVICE_DELTA_BPS = 2.0 * (1 << 30)
DEVICE_CDC_BPS = 1.5 * (1 << 30)

#: DELTA op-stream framing overhead per source block (copy ops coalesce,
#: literal runs carry framing) and CDC per-chunk metadata on the wire
#: (blob id + offset/length in the chunk list).
DELTA_OP_OVERHEAD_PER_BLOCK = 8
CDC_CHUNK_META_BYTES = 64
#: Model's expected CDC chunk size (repo default target; only the
#: metadata term depends on it, so repo-config drift is second-order).
CDC_AVG_CHUNK_BYTES = 1 << 20


@dataclasses.dataclass(frozen=True)
class ProtocolScore:
    protocol: str
    wire_bytes: float
    round_trips: int
    device_s: float
    cost_s: float


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    protocol: str
    reason: str
    scores: dict  # protocol -> ProtocolScore, every scored candidate

    def losing(self) -> list:
        return [s for p, s in sorted(self.scores.items())
                if p != self.protocol]


def _safe_div(num: float, den: float, fallback: float) -> float:
    """num/den with the hostile-input contract of syncstats: a zero,
    negative, NaN, or infinite denominator prices as ``fallback``
    instead of raising or poisoning the comparison with inf/NaN."""
    if not (math.isfinite(num) and math.isfinite(den)) or den <= 0:
        return fallback
    return num / den


def score_protocols(size: int, stats: SyncStats, *,
                    candidates=PROTOCOLS,
                    block_len: Optional[int] = None) -> dict:
    """Price each candidate protocol for one ``size``-byte file under
    ``stats``. Returns {protocol: ProtocolScore}."""
    size = max(int(size), 0)
    latency = stats.latency_s if math.isfinite(stats.latency_s) else 0.0
    latency = max(latency, 0.0)
    #: a link whose bandwidth is unknown/zero/NaN prices every byte at
    #: this many seconds — large enough that wire bytes still dominate,
    #: finite so comparisons stay total-ordered.
    worst_s_per_byte = 1.0
    scores: dict = {}
    for proto in candidates:
        if proto == FULL_COPY:
            wire = float(size)
            rt = 1
            dev = 0.0
        elif proto == DELTA:
            geo = signature_geometry(size, block_len)
            change = min(max(stats.change_rate, 0.0), 1.0) \
                if math.isfinite(stats.change_rate) else 1.0
            wire = (geo.sig_bytes + change * size
                    + DELTA_OP_OVERHEAD_PER_BLOCK * geo.n_blocks)
            rt = 2  # signature exchange, then the op stream
            dev = _safe_div(size, DEVICE_DELTA_BPS, 0.0)
        elif proto == CDC_DEDUP:
            dedup = min(max(stats.dedup_hit_ratio, 0.0), 1.0) \
                if math.isfinite(stats.dedup_hit_ratio) else 0.0
            n_chunks = -(-size // CDC_AVG_CHUNK_BYTES) if size else 0
            wire = ((1.0 - dedup) * size
                    + CDC_CHUNK_META_BYTES * n_chunks)
            rt = 2  # batched dedup-index query, then the unique blobs
            dev = _safe_div(size, DEVICE_CDC_BPS, 0.0)
        else:
            raise ValueError(f"unknown protocol {proto!r}")
        transfer = _safe_div(wire, stats.bandwidth_bps,
                             wire * worst_s_per_byte)
        scores[proto] = ProtocolScore(
            protocol=proto, wire_bytes=wire, round_trips=rt,
            device_s=dev, cost_s=transfer + rt * latency + dev)
    return scores


#: Module-cached metric children (the shardedindex pattern): .labels()
#: is a lock + dict lookup per call — real money when the planner runs
#: per file. Both label sets are closed vocabularies, so the cache is
#: bounded at |PROTOCOLS| x |reasons|.
_SELECTED_CHILDREN: dict = {}


def _selected(protocol: str, reason: str):
    child = _SELECTED_CHILDREN.get((protocol, reason))
    if child is None:
        child = _SELECTED_CHILDREN[(protocol, reason)] = (
            GLOBAL_METRICS.svc_protocol_selected.labels(
                protocol=protocol, reason=reason))
    return child


def decide(size: int, stats: SyncStats, *,
           basis_exists: bool = True,
           candidates=PROTOCOLS,
           allow_probe: bool = False,
           full_cap: Optional[int] = None,
           block_len: Optional[int] = None) -> PlanDecision:
    """Pick a protocol for one file/segment and record the decision.

    ``basis_exists``: whether the destination holds a prior copy —
    without one DELTA has nothing to diff against and drops out.
    ``allow_probe``: movers that CAN run the fancier protocol set this
    so an empty book gets seeded by one forced run instead of the
    pessimistic cold priors locking the planner into FULL_COPY forever.
    ``full_cap``: hard byte ceiling for FULL_COPY on stores that would
    persist it as a single blob (envflags.plan_full_blob_cap()).
    """
    with span("plan.decide"):
        cand = tuple(p for p in candidates if p in PROTOCOLS) or (FULL_COPY,)
        if basis_exists is False and DELTA in cand and len(cand) > 1:
            cand = tuple(p for p in cand if p != DELTA)
            no_basis = True
        else:
            no_basis = False
        scores = score_protocols(size, stats, candidates=cand,
                                 block_len=block_len)
        ranked = sorted(scores.values(),
                        key=lambda s: (s.cost_s, s.protocol))
        chosen, reason = ranked[0].protocol, REASON_COST
        if no_basis and chosen == FULL_COPY:
            reason = REASON_NO_BASIS
        if allow_probe:
            if (DELTA in cand and stats.delta_samples == 0
                    and chosen != DELTA):
                chosen, reason = DELTA, REASON_PROBE
            elif (CDC_DEDUP in cand and stats.dedup_samples == 0
                    and chosen == FULL_COPY):
                chosen, reason = CDC_DEDUP, REASON_PROBE
        if (full_cap is not None and chosen == FULL_COPY
                and size > full_cap and len(ranked) > 1):
            chosen = next(s.protocol for s in ranked
                          if s.protocol != FULL_COPY)
            reason = REASON_SIZE_CAP
        override = envflags.sync_protocol()
        if override != "auto" and override in scores:
            chosen, reason = override, REASON_OVERRIDE
    _selected(chosen, reason).inc()
    return PlanDecision(protocol=chosen, reason=reason, scores=scores)
