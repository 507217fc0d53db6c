"""Pinned telemetry schemas (a copy of ``repro.telemetry.schema``).

Every exported artifact (the round-stats lane, the per-round JSONL event
log, the guard counters) has its field order pinned here, equal to the
reference's, so the two packages' logs diff line by line.  Changing any
tuple is a schema break and must update ``tests/test_torch_telemetry.py``
deliberately.
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# The round-stats lane (fused pipeline, ``SimConfig.telemetry >= 2``).
#
# One fp32 row per aggregation group per round, written by the round's
# device work into the chunk's lane buffer and copied to the host once per
# chunk.  The first ``N_LANE_HOST`` fields are known on the host at pack
# time and ride in the round's index block as fp32 bits (the device echoes
# them so the lane is self-contained); the rest are computed on the
# device.
LANE_FIELDS = (
    # host pass-through (packed into the round's index block)
    "round",                # simulated round index
    "sim_time",             # simulated clock at round end (hours)
    "cohort",               # learners selected this round
    "fresh",                # fresh (in-round) update rows aggregated
    "stale_landed",         # straggler rows landing this round (incl. replays)
    "cache_occupancy",      # stale-cache entries pending after scheduling
    # computed on the device, from the operand the guard screens
    "l2_min",               # update-row L2 norm, min over finite valid rows
    "l2_mean",              # ... mean
    "l2_max",               # ... max
    "nonfinite_rows",       # valid rows containing any non-finite entry
    # guard/robust columns (mirror gstats; zeros-but-survivors when
    # unguarded and non-robust)
    "rejected_nonfinite",   # rows rejected by the non-finite screen
    "rejected_norm",        # rows rejected by the norm-outlier screen
    "robust_rejected",      # rows the robust aggregator rejected (krum
                            # losers, norm_median_clip rejects)
    "robust_trimmed",       # rows trimmed per coordinate band (2*k_eff)
                            # or clipped by norm_median_clip
    "survivors",            # rows that entered the aggregate
    "applied",              # 1 if the update was applied (quorum met)
)
LANE_WIDTH = len(LANE_FIELDS)
# leading fields packed on the host into the round's index block
N_LANE_HOST = 6

# lane fields serialized as ints in round events (the rest stay floats)
LANE_INT_FIELDS = frozenset((
    "round", "cohort", "fresh", "stale_landed", "cache_occupancy",
    "nonfinite_rows", "rejected_nonfinite", "rejected_norm",
    "robust_rejected", "robust_trimmed", "survivors", "applied",
))

# ---------------------------------------------------------------------------
# Per-round JSONL event log (``<telemetry-dir>/rounds.jsonl``).
#
# One event per (cell, recorded round), keys exactly in this order.  Only
# deterministic fields — no wall-clock — so the log joins the bitwise
# crash→resume contract: uninterrupted and crash→resume runs produce
# byte-identical files.  NaN accuracy/loss serialize as null.
ROUND_EVENT_KEYS = (
    "event",                # always "round"
    "cell",                 # cell / run label
    *LANE_FIELDS,
    # host-side accounting joined from the RoundRecord
    "resource_used",
    "resource_wasted",
    "unique_participants",
    "accuracy",             # null on non-eval rounds
    "loss",
)

# ---------------------------------------------------------------------------
# Registry counter names (single source of truth for guard accounting and
# the dispatch/transfer profile; ``PipelineStats`` is a view over these).
GUARD_COUNTERS = (
    "guard_rejected_nonfinite",
    "guard_rejected_norm",
    "guard_quorum_skips",
    "guard_robust_rejected",
    "guard_robust_trimmed",
)
PIPELINE_COUNTERS = (
    "pipeline_rounds",
    "pipeline_h2d_bytes",
    "pipeline_d2h_bytes",
    "pipeline_init_h2d_bytes",
    "pipeline_cross_shard_landings",
    "pipeline_feedback_fetches",
)
DISPATCH_KINDS = ("round", "eval", "cache_grow", "repack")

# ---------------------------------------------------------------------------
# Host-side tracer span names (Chrome trace-event JSON, Perfetto-loadable).
SPAN_NAMES = (
    "schedule",     # host prescheduling of a chunk of rounds
    "pack",         # packing dispatch int32/fp32 buffers
    "dispatch",     # the chunk's rounds on the device (graph replays)
    "fetch",        # device-to-host copies: lane, feedback l2 stats
    "eval",         # deferred eval fill + early-stop bookkeeping
    "repack",       # early-stop sweep-bucket repacking (sharded runs)
    "checkpoint",   # snapshot write
)
