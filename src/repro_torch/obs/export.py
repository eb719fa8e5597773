"""Trace + metrics exporters: Perfetto/Chrome JSON, Prometheus text.

The Chrome ``trace_event`` format (the JSON array Perfetto and
``chrome://tracing`` both load) maps directly onto the recorder's event
tuples: complete spans (``ph: "X"``), instants (``"i"``), and counter
samples (``"C"``, which Perfetto renders as timeline tracks — queue
depth, free pages).  Timestamps convert from clock seconds to the
format's microseconds.  Export is fully deterministic — events are
rendered in ring order with sorted JSON keys — so two VirtualClock runs
of the same workload produce byte-identical files (pinned by test).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Event

#: pid → human label shown by Perfetto's process track headers; pids are
#: replica indices, with CLUSTER_PID for cluster-scope events
CLUSTER_PID = 999


def _us(ts: float) -> float:
    """Seconds → microseconds, rounded to 0.1 µs so VirtualClock float
    arithmetic renders stably."""
    return round(ts * 1e6, 1)


def chrome_trace_events(events: Sequence[Event],
                        pid_names: Optional[Dict[int, str]] = None
                        ) -> List[dict]:
    """Render recorder event tuples as Chrome ``trace_event`` dicts."""
    out: List[dict] = []
    seen_pids = set()
    for ph, name, cat, ts, dur, pid, tid, args in events:
        seen_pids.add(pid)
        ev = {"ph": ph, "name": name, "cat": cat, "ts": _us(ts),
              "pid": pid, "tid": tid}
        if ph == "X":
            ev["dur"] = _us(dur)
            if args:
                ev["args"] = args
        elif ph == "i":
            ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = args
        elif ph == "C":
            ev["args"] = args
        out.append(ev)
    names = dict(pid_names or {})
    names.setdefault(CLUSTER_PID, "cluster")
    meta = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": names.get(pid, f"replica {pid}")}}
            for pid in sorted(seen_pids)]
    return meta + out


def chrome_trace_json(events: Sequence[Event],
                      pid_names: Optional[Dict[int, str]] = None) -> dict:
    return {"traceEvents": chrome_trace_events(events, pid_names),
            "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, recorder,
                       pid_names: Optional[Dict[int, str]] = None) -> int:
    """Write a Perfetto-loadable JSON file; returns the event count.

    ``recorder`` is a TraceRecorder or a raw event sequence.  Keys are
    sorted and floats rendered by ``json`` defaults, so identical event
    streams serialize to identical bytes.
    """
    events = recorder.events() if hasattr(recorder, "events") else recorder
    doc = chrome_trace_json(events, pid_names)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
    return len(events)


def queue_depth_timeline(events: Sequence[Event], name: str = "queue_depth",
                         max_points: int = 200) -> List[Tuple[float, float]]:
    """Extract a counter track as ``[(ts_s, value), ...]``, downsampled
    evenly to ``max_points`` — the benchmark's queue-depth timeline."""
    pts = [(ts, args.get(name, 0.0))
           for ph, n, _cat, ts, _dur, _pid, _tid, args in events
           if ph == "C" and n == name]
    if len(pts) <= max_points:
        return pts
    step = len(pts) / max_points
    return [pts[int(i * step)] for i in range(max_points)]


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def prometheus_text(registry: MetricsRegistry, prefix: str = "repro") -> str:
    """Prometheus exposition-format snapshot of a registry.

    Counters render as ``<prefix>_<name>_total``, gauges as value +
    ``_peak``, histograms as the conventional cumulative ``_bucket``
    series with ``le`` labels plus ``_sum`` / ``_count``.
    """
    snap = registry.snapshot()
    lines: List[str] = []
    for name, value in snap["counters"].items():
        full = f"{prefix}_{name}"
        lines.append(f"# TYPE {full} counter")
        lines.append(f"{full}_total {_fmt(value)}")
    for name, g in snap["gauges"].items():
        full = f"{prefix}_{name}"
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full} {_fmt(g['value'])}")
        lines.append(f"{full}_peak {_fmt(g['peak'])}")
    for name in snap["histograms"]:
        hist = registry.get(name)
        full = f"{prefix}_{name}"
        lines.append(f"# TYPE {full} histogram")
        cum = 0
        for i, edge in enumerate(hist.bounds):
            cum += hist.counts[i]
            if hist.counts[i]:
                lines.append(f'{full}_bucket{{le="{edge:.6g}"}} {cum}')
        lines.append(f'{full}_bucket{{le="+Inf"}} {hist.count}')
        lines.append(f"{full}_sum {_fmt(hist.total)}")
        lines.append(f"{full}_count {hist.count}")
    return "\n".join(lines) + "\n"


__all__ = [
    "CLUSTER_PID",
    "chrome_trace_events",
    "chrome_trace_json",
    "prometheus_text",
    "queue_depth_timeline",
    "write_chrome_trace",
]
