"""Chrome/Perfetto trace export for the serving engine.

Port of ``repro/telemetry/trace.py``: the same trace-event schema, tracks
and event shapes; the process is named ``repro_torch.engine``.
:class:`Tracer` records trace events host-side (timestamps from
``time.perf_counter`` relative to tracer construction, in microseconds —
the Chrome trace-event clock unit) and serializes them in the Chrome
trace-event JSON-object format::

    {"traceEvents": [...], "displayTimeUnit": "ms"}

Open the file in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.  One *track* (a named tid under one engine pid) per
subsystem — the engine uses ``admission``, ``dispatch``, ``spec``,
``prefill-chunk`` and ``eviction`` — plus counter tracks ("C" events)
sampled from the device counter tree after each dispatch.  Recording an
event is an O(1) list append of values already on the host; the tracer
never touches the device.
"""
from __future__ import annotations

import json
import time

TRACE_PID = 1   # one "process": the engine


class Tracer:
    """Host-side Chrome trace-event recorder.

    Events within a track are recorded in wall order with a monotonic
    clock, so per-track ``ts`` is non-decreasing (a schema property the
    tests pin).  Duration ("X") events take their start from
    :meth:`now_us`, captured by the caller before the spanned work.
    """

    def __init__(self):
        self._t0 = time.perf_counter()
        self._tids: dict[str, int] = {}
        self.events: list[dict] = []

    def now_us(self) -> float:
        """Microseconds since tracer construction (trace clock)."""
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[track] = tid
            self.events.append({
                "name": "thread_name", "ph": "M", "pid": TRACE_PID,
                "tid": tid, "args": {"name": track},
            })
        return tid

    def complete(self, track: str, name: str, start_us: float,
                 args: dict | None = None) -> None:
        """A duration ("X") event spanning ``start_us`` .. now."""
        now = self.now_us()
        ev = {
            "name": name, "ph": "X", "pid": TRACE_PID,
            "tid": self._tid(track), "ts": start_us,
            "dur": max(now - start_us, 0.0),
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, track: str, name: str,
                args: dict | None = None) -> None:
        """An instant ("i") event at the current time."""
        ev = {
            "name": name, "ph": "i", "pid": TRACE_PID,
            "tid": self._tid(track), "ts": self.now_us(), "s": "t",
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: dict) -> None:
        """A counter ("C") sample: ``values`` are series-name -> number,
        rendered by the viewer as a stacked area track."""
        self.events.append({
            "name": name, "ph": "C", "pid": TRACE_PID,
            "ts": self.now_us(),
            "args": {k: float(v) for k, v in values.items()},
        })

    def to_dict(self) -> dict:
        return {
            "traceEvents": [
                {"name": "process_name", "ph": "M", "pid": TRACE_PID,
                 "args": {"name": "repro_torch.engine"}},
                *self.events,
            ],
            "displayTimeUnit": "ms",
        }

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
            f.write("\n")
