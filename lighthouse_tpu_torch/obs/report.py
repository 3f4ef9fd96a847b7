"""Stage-attribution math over trace events.

Shared by ``tools/trace_report.py`` (offline reports over dump files),
``bench.py`` (the ``BENCH_PIPELINE=1`` per-stage block), and the
scenario engine (the overlap-efficiency SLO gate).  All functions work
on *normalized events*: dicts with ``name`` (str), ``ts`` and ``dur``
(microseconds, Chrome trace-event convention) — exactly the shape
``Tracer.chrome_trace()["traceEvents"]`` emits, so a live tracer
snapshot and a dump file on disk feed the same code path.

Definitions
-----------

* **stage stats** — per-span-name count / total / p50 / p99 (seconds).
* **host vs device share** — host stages are the Python-side work
  (marshal, CPU fallback); device stages block on or run on the
  accelerator (resolve, device rung, compiles).
* **overlap efficiency** — ``wall / max(marshal_busy, device_busy)``
  over the pipelined window: 1.0 means the slower stage fully hides the
  other (perfect overlap); ~2.0 means the stages ran serially.  When no
  pipeline spans exist (the serial ladder path) the degenerate form is
  ``ladder_wall / engine_busy`` — how much verify wall time was actual
  engine work — which is the same "1.0 is perfect" scale.
"""

from __future__ import annotations

# Span names considered host-side vs device-side work for the share
# split.  Names absent from both sets (breaker events, scenario slots,
# block/sync lifecycle wrappers) are structural and attributed to
# neither side.
HOST_STAGES = frozenset({"pipeline.marshal", "verify.cpu"})
DEVICE_STAGES = frozenset({
    "pipeline.dispatch", "pipeline.resolve", "verify.device", "jit.compile",
})

# The stages the pipelined overlap window is computed over.
_PIPELINE_STAGES = frozenset({
    "pipeline.marshal", "pipeline.dispatch", "pipeline.resolve",
})


def _quantile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def stage_stats(events: list) -> dict:
    """Per-name stats: ``{name: {count, total_s, p50_s, p99_s}}``."""
    by_name: dict = {}
    for ev in events:
        by_name.setdefault(ev["name"], []).append(ev.get("dur", 0.0) / 1e6)
    out = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        out[name] = {
            "count": len(durs),
            "total_s": sum(durs),
            "p50_s": _quantile(durs, 0.50),
            "p99_s": _quantile(durs, 0.99),
        }
    return out


def host_device_share(events: list) -> dict:
    """Busy-seconds split into host / device / other buckets."""
    host = device = other = 0.0
    for ev in events:
        dur = ev.get("dur", 0.0) / 1e6
        if ev["name"] in HOST_STAGES:
            host += dur
        elif ev["name"] in DEVICE_STAGES:
            device += dur
        else:
            other += dur
    busy = host + device
    return {
        "host_s": host,
        "device_s": device,
        "other_s": other,
        "host_share": (host / busy) if busy > 0 else 0.0,
        "device_share": (device / busy) if busy > 0 else 0.0,
    }


def overlap_efficiency(events: list) -> dict:
    """Overlap ratio ``wall / max(stage busy)`` (1.0 = perfect overlap).

    Returns ``{"ratio": float|None, "mode": "pipeline"|"serial"|"empty",
    "wall_s": float, "marshal_s": float, "device_s": float}``.  ``ratio``
    is None when there is nothing to attribute.
    """
    pipe = [ev for ev in events if ev["name"] in _PIPELINE_STAGES]
    if pipe:
        t0 = min(ev["ts"] for ev in pipe)
        t1 = max(ev["ts"] + ev.get("dur", 0.0) for ev in pipe)
        wall = (t1 - t0) / 1e6
        marshal = sum(
            ev["dur"] for ev in pipe if ev["name"] == "pipeline.marshal"
        ) / 1e6
        device = sum(
            ev["dur"] for ev in pipe
            if ev["name"] in ("pipeline.dispatch", "pipeline.resolve")
        ) / 1e6
        busiest = max(marshal, device)
        return {
            "ratio": (wall / busiest) if busiest > 0 else None,
            "mode": "pipeline",
            "wall_s": wall,
            "marshal_s": marshal,
            "device_s": device,
        }
    # Serial ladder path: engine-busy share of the ladder wall.
    ladder = [ev for ev in events if ev["name"] == "verify.batch"]
    engine = [
        ev for ev in events if ev["name"] in ("verify.device", "verify.cpu")
    ]
    wall = sum(ev.get("dur", 0.0) for ev in ladder) / 1e6
    busy = sum(ev.get("dur", 0.0) for ev in engine) / 1e6
    if wall <= 0 or busy <= 0:
        return {
            "ratio": None, "mode": "empty",
            "wall_s": wall, "marshal_s": 0.0, "device_s": busy,
        }
    return {
        "ratio": wall / busy,
        "mode": "serial",
        "wall_s": wall,
        "marshal_s": 0.0,
        "device_s": busy,
    }


def compile_events(events: list) -> list:
    """``jit.compile`` events as ``[{fingerprint, seconds, ...fields}]``."""
    out = []
    for ev in events:
        if ev["name"] != "jit.compile":
            continue
        args = dict(ev.get("args") or {})
        args.pop("sid", None)
        args.pop("parent", None)
        row = {"seconds": ev.get("dur", 0.0) / 1e6}
        row.update(args)
        out.append(row)
    return out


def attribution(events: list) -> dict:
    """The full report: stages + share + overlap + compiles."""
    return {
        "stages": stage_stats(events),
        "share": host_device_share(events),
        "overlap": overlap_efficiency(events),
        "compiles": compile_events(events),
        "events": len(events),
    }


def unknown_names(events: list, registry) -> list:
    """Event names not present in the span registry (sorted, unique)."""
    return sorted({ev["name"] for ev in events} - set(registry))
