"""Observability of the port: spans, trace context, the flight
recorder, the copy ledger and the device trace.

Ports ``volsync_tpu/obs/__init__.py``: the same names, re-exported
from ``obs/tracing.py`` and ``obs/copyledger.py``, plus the port's
``triggers()``, ``copy_totals()`` and ``ring_stats()``. The
reference's ``stage_seconds_by_tenant()`` mirror is not ported: its
numbers are ``metrics.GLOBAL.svc_stage_seconds``.
"""

from volsync_tpu_torch.obs.copyledger import (
    SANCTIONED_SITES,
    copies_by_site,
    copy_totals,
    record_copy,
    reset_copies,
    total_copied,
)
from volsync_tpu_torch.obs.tracing import (
    TraceContext,
    begin_span,
    carry_context,
    chrome_trace,
    current_context,
    device_trace,
    dump_trace,
    format_trace_header,
    new_id,
    new_trace,
    parse_trace_header,
    record_trigger,
    reset_spans,
    reset_trace,
    ring_stats,
    span,
    span_totals,
    trace_context,
    trace_events,
    trace_instant,
    triggers,
    use_context,
)

__all__ = [
    "SANCTIONED_SITES",
    "TraceContext",
    "begin_span",
    "carry_context",
    "chrome_trace",
    "copies_by_site",
    "copy_totals",
    "current_context",
    "device_trace",
    "dump_trace",
    "format_trace_header",
    "new_id",
    "new_trace",
    "parse_trace_header",
    "record_copy",
    "record_trigger",
    "reset_copies",
    "reset_spans",
    "reset_trace",
    "ring_stats",
    "span",
    "span_totals",
    "total_copied",
    "trace_context",
    "trace_events",
    "trace_instant",
    "triggers",
    "use_context",
]
