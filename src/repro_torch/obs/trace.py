"""Flight-recorder span tracing, disarmed by default.

``with span("train_clients", round=t):`` wraps every host-level phase of
the round engine plus the driver seams (pipelined dispatch and join,
buffered-async fill and waves, the fault pipeline, logit-bank builds,
checkpoint writes, the distributed driver's wire phases).  Spans are host
spans: while disarmed, :func:`span` is one module-global ``is None``
check returning a shared no-op context manager, and an armed run computes
exactly what a disarmed one does.

Each finished span is one JSONL line, in the JAX package's format::

    {"name": "train_clients", "t0": 3.21, "t1": 4.05, "dur_s": 0.84,
     "depth": 1, "parent": "round", "thread": "MainThread",
     "round": 7, "driver": "buffered_async", "wave": 12}

Timestamps are ``time.perf_counter()`` offsets from the recorder's arm
time, so idle gaps between spans on different threads (the overlap the
pipelined drivers exist to create) subtract directly.  Nesting
(``depth`` / ``parent``) is tracked per thread; :func:`set_context`
stamps ambient keys (``driver=...``) on every span closed afterwards on
any thread.

A span is a host interval: it ends when the host leaves it, and work the
host queued on the card may still run.  The drivers synchronise the
issuing stream where they time a phase (``drivers/base.Driver._timed``).

Profiler passthrough: armed with ``profile_dir``, the recorder runs a
``torch.profiler.profile`` over the CPU (and CUDA, where the process has
a card), on every thread where the installed torch can, for as long as it
is armed, enters a ``record_function(name)``
with each span, so the span taxonomy shows on the profiler's timeline,
and writes ``trace.json`` (a Chrome trace) into ``profile_dir`` when
disarmed.  A profiler that was asked for and fails raises; nothing
degrades silently.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager returned while disarmed."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        pass


_NULL = _NullSpan()

#: module-global recorder slot; ``None`` == disarmed (the common case).
_RECORDER: Optional["FlightRecorder"] = None


class _Span:
    __slots__ = ("rec", "name", "attrs", "t0", "_fn")

    def __init__(self, rec: "FlightRecorder", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self._fn = None

    def annotate(self, **attrs) -> None:
        """Attach attributes discovered mid-span (fault stats etc.)."""
        self.attrs.update(attrs)

    def __enter__(self):
        self.rec._push(self.name)
        if self.rec.profiler is not None:
            import torch.profiler
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        self.rec._pop(self.name, self.t0, t1, self.attrs)
        return False


class FlightRecorder:
    """Collects finished spans in memory and, with ``path``, appends them
    to a JSONL file as they close.  One recorder is armed at a time
    (:func:`arm`); :func:`span` routes through it."""

    def __init__(self, path: Optional[str] = None,
                 profile_dir: Optional[str] = None):
        self.path = path
        self.profile_dir = profile_dir
        self.profiler = None
        self.spans: List[dict] = []
        self._epoch = time.perf_counter()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._context: Dict[str, object] = {}
        self._f = None
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._f = open(path, "a")

    # -- per-thread nesting stack -------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, name: str) -> None:
        self._stack().append(name)

    def _pop(self, name: str, t0: float, t1: float, attrs: dict) -> None:
        st = self._stack()
        parent = st[-2] if len(st) > 1 else None
        depth = len(st) - 1
        st.pop()
        rec = {"name": name,
               "t0": t0 - self._epoch, "t1": t1 - self._epoch,
               "dur_s": t1 - t0, "depth": depth, "parent": parent,
               "thread": threading.current_thread().name}
        with self._lock:
            rec.update(self._context)
            rec.update(attrs)
            self.spans.append(rec)
            if self._f is not None:
                self._f.write(json.dumps(rec) + "\n")
                self._f.flush()

    # -- ambient attribution ------------------------------------------
    def set_context(self, **attrs) -> None:
        """Stamp ``attrs`` onto every span closed afterwards (any thread)
        until overwritten; ``key=None`` removes a key."""
        with self._lock:
            for k, v in attrs.items():
                if v is None:
                    self._context.pop(k, None)
                else:
                    self._context[k] = v

    # -- torch.profiler passthrough -----------------------------------
    def _start_profiler(self) -> None:
        if not self.profile_dir:
            return
        import torch
        from torch.profiler import (ProfilerActivity, _ExperimentalConfig,
                                    profile)
        os.makedirs(self.profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            # the drivers' worker threads (the pipelined fusion) too
            config = _ExperimentalConfig(profile_all_threads=True)
        except TypeError:  # a torch without the option: the arming thread
            config = None
        prof = profile(activities=activities, experimental_config=config)
        prof.start()
        self.profiler = prof

    def _stop_profiler(self) -> None:
        prof, self.profiler = self.profiler, None
        if prof is None:
            return
        prof.stop()
        prof.export_chrome_trace(os.path.join(self.profile_dir,
                                              "trace.json"))

    # -- summaries -----------------------------------------------------
    def phase_totals(self) -> Dict[str, float]:
        """Total seconds per span name."""
        out: Dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                out[s["name"]] = out.get(s["name"], 0.0) + s["dur_s"]
        return out

    def per_round(self) -> Dict[int, Dict[str, float]]:
        """``{round: {span name: total seconds}}`` over round-stamped
        spans.  Buffered-async training runs in numbered waves inside a
        round's ``fill`` span; the engine phases inside a wave carry the
        wave number as ``round``, and a ``wave`` span carries both."""
        out: Dict[int, Dict[str, float]] = {}
        with self._lock:
            for s in self.spans:
                r = s.get("round")
                if r is None:
                    continue
                row = out.setdefault(int(r), {})
                row[s["name"]] = row.get(s["name"], 0.0) + s["dur_s"]
        return out

    def summary(self) -> dict:
        """The ``RunResult.summary()["obs"]`` payload: phase totals, the
        per-round phase breakdown, and the idle gap (the total time a
        driver spent blocked joining a fusion or a batch prefetch)."""
        totals = self.phase_totals()
        per_round = self.per_round()
        idle = totals.get("join_fusion", 0.0) + totals.get("join_batches",
                                                           0.0)
        return {"n_spans": len(self.spans),
                "phase_totals_s": totals,
                "idle_gap_s": idle,
                "per_round": {str(k): v
                              for k, v in sorted(per_round.items())}}

    def close(self) -> None:
        try:
            self._stop_profiler()
        finally:
            with self._lock:
                if self._f is not None:
                    self._f.close()
                    self._f = None


def arm(path: Optional[str] = None, profile_dir: Optional[str] = None
        ) -> FlightRecorder:
    """Install (and return) a recorder; closes any armed one first."""
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.close()
        _RECORDER = None
    rec = FlightRecorder(path=path, profile_dir=profile_dir)
    try:
        rec._start_profiler()
    except BaseException:
        rec.close()
        raise
    _RECORDER = rec
    return rec


def disarm() -> None:
    global _RECORDER
    rec, _RECORDER = _RECORDER, None
    if rec is not None:
        rec.close()


def recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def span(name: str, **attrs):
    """Context manager timing ``name``; a free no-op while disarmed."""
    rec = _RECORDER
    if rec is None:
        return _NULL
    return _Span(rec, name, attrs)


def set_context(**attrs) -> None:
    """Ambient span attribution (no-op while disarmed)."""
    rec = _RECORDER
    if rec is not None:
        rec.set_context(**attrs)


def load_spans(path: str) -> List[dict]:
    """Parse a span JSONL file back into dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
