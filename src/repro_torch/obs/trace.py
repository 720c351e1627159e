"""Zero-dependency request-lifecycle tracing with Chrome-trace export.

One process-global :class:`Tracer` (installed with :func:`set_tracer` or the
:func:`trace_to` context manager) collects **spans** (nested timed regions:
``with tracer.span("prefill_chunk", wave=4)``), **instants** (point events:
``tracer.instant("retire", req=rid)``) and **counters** (monotonic series:
``tracer.count("blocks_shipped", 8)``).  When tracing is off the global is
the :data:`NULL_TRACER` singleton whose ``span``/``instant``/``count`` are
allocation-free no-ops — the serving hot path pays ~nothing (every traced
region is per *dispatch*, never per token; the fused scans stay opaque).

Events carry a **track**: a ``(process, thread)`` label pair mapped to
Chrome ``pid``/``tid`` at export, so a disaggregated run renders as parallel
per-arm prefill/ship/decode rows in Perfetto.  ``JaxBackend`` labels each
scheduler's track ``(arm<i>:<mode>, <role>@<device>)``; events emitted
inside an open span inherit the span's track, so scheduler-internal instants
land on the right row without re-threading labels.

:meth:`Tracer.export_chrome_trace` writes the standard trace-event JSON
(``{"traceEvents": [...]}``, ``ph`` in ``X``/``i``/``C``/``M``, ``ts``/``dur``
in microseconds) — load it at ``ui.perfetto.dev`` or ``chrome://tracing``.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple, Union

#: default track for engine-level lifecycle events
ENGINE_TRACK = ("engine", "lifecycle")

Track = Union[str, Tuple[str, str]]


class _NullSpan:
    """Singleton no-op span/annotation context manager (also the disabled
    stand-in for ``torch.profiler.record_function``)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call is a no-op returning shared singletons,
    so call sites never branch on enablement and never allocate events."""

    __slots__ = ()
    enabled = False

    def span(self, name, *, track=None, **attrs):
        return NULL_SPAN

    def instant(self, name, *, track=None, **attrs):
        return None

    def count(self, name, value=1, *, track=None):
        return None

    def export_chrome_trace(self, path):
        raise RuntimeError("tracing is disabled (NullTracer has no events); "
                           "install a Tracer via set_tracer()/trace_to()")


NULL_TRACER = NullTracer()


class _Span:
    """One open timed region; records an ``X`` (complete) event on exit."""

    __slots__ = ("_tr", "name", "track", "args", "t0")

    def __init__(self, tr: "Tracer", name: str, track, args: dict):
        self._tr = tr
        self.name = name
        self.track = track
        self.args = args

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. admitted counts)."""
        self.args.update(attrs)
        return self

    def __enter__(self):
        tr = self._tr
        if self.track is None:
            self.track = tr._current_track()
        self.t0 = tr._now()
        tr._stack.append(self)
        return self

    def __exit__(self, *exc):
        tr = self._tr
        t1 = tr._now()
        tr._stack.pop()
        tr._record(("X", self.name, self.track, self.t0,
                    t1 - self.t0, self.args))
        return False


class Tracer:
    """Collects lifecycle events; export once with ``export_chrome_trace``.

    The event log is process-global host-side bookkeeping (one tuple append
    per span/instant); timestamps come from ``clock`` (default
    ``time.perf_counter``) rebased to the tracer's construction so traces
    start near zero.

    With ``stream_path`` set, events are converted and written to the file
    INCREMENTALLY instead of buffered — memory stays flat over arbitrarily
    long soak runs.  Call :meth:`close` (or let ``trace_to`` do it) to
    finalize the JSON; ``events()`` returns nothing in streaming mode (the
    log went to disk), while ``n_events`` still counts.
    """

    enabled = True

    def __init__(self, *, clock=time.perf_counter,
                 stream_path: Optional[str] = None):
        self._clock = clock
        self._t0 = clock()
        # (ph, name, track, ts_us, dur_us, args) tuples
        self._events: List[tuple] = []
        self._stack: List[_Span] = []
        self._counters: Dict[tuple, float] = {}
        self.stream_path = stream_path
        self._n_streamed = 0
        self._stream = None
        self._stream_first = True
        self._pids: Dict[str, int] = {}
        self._tids: Dict[tuple, int] = {}
        if stream_path is not None:
            self._stream = open(stream_path, "w")
            self._stream.write('{"displayTimeUnit": "ms", "traceEvents": [')

    def _record(self, ev: tuple) -> None:
        if self._stream is None:
            self._events.append(ev)
            return
        self._n_streamed += 1
        for d in self._chrome_dicts(ev):
            self._stream.write(("" if self._stream_first else ",\n")
                               + json.dumps(d))
            self._stream_first = False
        # per-record flush: a soak run killed mid-flight still leaves an
        # inspectable trace (append "]}" by hand); events are per dispatch,
        # so the syscall never sits on a per-token path
        self._stream.flush()

    def close(self) -> Optional[str]:
        """Finalize a streaming trace (idempotent); returns its path."""
        if self._stream is not None:
            self._stream.write("]}")
            self._stream.close()
            self._stream = None
        return self.stream_path

    # ------------------------------------------------------------ recording
    def _now(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _current_track(self):
        return self._stack[-1].track if self._stack else ENGINE_TRACK

    def span(self, name: str, *, track: Optional[Track] = None, **attrs):
        """Open a nested timed region: ``with tracer.span("decode_scan",
        track=..., lanes=4) as sp: ...; sp.set(retired=2)``."""
        return _Span(self, name, track, attrs)

    def instant(self, name: str, *, track: Optional[Track] = None, **attrs):
        """Point event (Perfetto arrow tick); inherits the open span's
        track when ``track`` is None."""
        if track is None:
            track = self._current_track()
        self._record(("i", name, track, self._now(), 0.0, attrs))

    def count(self, name: str, value: float = 1, *,
              track: Optional[Track] = None):
        """Accumulate a monotonic counter series (Chrome ``C`` events plot
        the running total per track)."""
        if track is None:
            track = self._current_track()
        key = (name, _track_pair(track)[0])
        total = self._counters.get(key, 0) + value
        self._counters[key] = total
        self._record(("C", name, track, self._now(), 0.0, {name: total}))

    @property
    def n_events(self) -> int:
        return len(self._events) + self._n_streamed

    def events(self, name: Optional[str] = None) -> List[tuple]:
        """Raw event tuples ``(ph, name, track, ts_us, dur_us, args)`` —
        the in-process query surface tests and tools use pre-export."""
        if name is None:
            return list(self._events)
        return [e for e in self._events if e[1] == name]

    # -------------------------------------------------------------- export
    def _chrome_dicts(self, event: tuple) -> List[dict]:
        """Convert one raw event tuple to its Chrome trace dicts — the
        event itself, preceded by ``M`` metadata events the first time a
        track's process/thread labels are seen."""
        ph, name, track, ts, dur, args = event
        out: List[dict] = []
        proc, thread = _track_pair(track)
        if proc not in self._pids:
            self._pids[proc] = len(self._pids) + 1
            out.append({"name": "process_name", "ph": "M",
                        "pid": self._pids[proc], "tid": 0,
                        "args": {"name": proc}})
        pid = self._pids[proc]
        tkey = (pid, thread)
        if tkey not in self._tids:
            self._tids[tkey] = sum(1 for (p, _t) in self._tids
                                   if p == pid) + 1
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": self._tids[tkey], "args": {"name": thread}})
        ev = {"name": name, "ph": ph, "ts": round(ts, 3), "pid": pid,
              "tid": self._tids[tkey], "cat": "repro"}
        if ph == "X":
            ev["dur"] = round(dur, 3)
        elif ph == "i":
            ev["s"] = "t"              # thread-scoped instant
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        out.append(ev)
        return out

    def export_chrome_trace(self, path: str) -> str:
        """Write Chrome/Perfetto trace-event JSON.  Track ``(process,
        thread)`` labels map to stable integer ``pid``/``tid`` in
        first-seen order, with ``M`` metadata events naming them.  A
        streaming tracer already wrote its events — this finalizes the
        stream file instead (``path`` is ignored)."""
        if self.stream_path is not None:
            return self.close()
        self._pids, self._tids = {}, {}     # repeat exports stay complete
        out: List[dict] = []
        for event in self._events:
            out.extend(self._chrome_dicts(event))
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
        return path


def _track_pair(track) -> Tuple[str, str]:
    if isinstance(track, str):
        return track, "main"
    proc, thread = track
    return str(proc), str(thread)


def _jsonable(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:                               # numpy scalars, 0-d arrays
        import numpy as np
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
    except ImportError:                # pragma: no cover
        pass
    return str(v)


# -------------------------------------------------------- process globals
_TRACER = NULL_TRACER
_ANNOTATE = False


def get_tracer():
    """The process-global tracer (the NullTracer singleton when disabled).
    Hot paths fetch it once per step and call ``span``/``instant`` without
    checking enablement."""
    return _TRACER


def set_tracer(tracer) -> object:
    """Install ``tracer`` (None restores the no-op singleton); returns the
    previous tracer so callers can restore it."""
    global _TRACER
    old = _TRACER
    _TRACER = NULL_TRACER if tracer is None else tracer
    return old


class trace_to:
    """``with trace_to("trace.json") as tr: ...`` — install a fresh Tracer,
    run the workload, export the Chrome trace on exit (even on error) and
    restore the previous tracer.  ``stream=True`` writes events to the file
    incrementally as they happen (flat memory for long soak runs) and
    finalizes the JSON on exit."""

    def __init__(self, path: str, *, stream: bool = False, **tracer_kw):
        self.path = path
        if stream:
            tracer_kw.setdefault("stream_path", path)
        self.tracer = Tracer(**tracer_kw)

    def __enter__(self) -> Tracer:
        self._old = set_tracer(self.tracer)
        return self.tracer

    def __exit__(self, *exc):
        set_tracer(self._old)
        self.tracer.export_chrome_trace(self.path)
        return False


def set_annotations(on: bool) -> None:
    """Toggle ``torch.profiler.record_function`` wrapping of kernel
    dispatches — device-timeline labels when profiling with
    ``torch.profiler.profile``."""
    global _ANNOTATE
    _ANNOTATE = bool(on)


def annotation(name: str):
    """Context manager labelling the enclosed dispatch on the device
    profile; the shared no-op singleton when annotations are off."""
    if _ANNOTATE:
        from torch.profiler import record_function
        return record_function(name)
    return NULL_SPAN
