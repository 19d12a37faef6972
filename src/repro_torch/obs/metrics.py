"""Unified metrics registry: typed counters, gauges and histograms.

One process-wide :data:`REGISTRY` holds every counter of the port under a
dotted name, so ``REGISTRY.snapshot()`` is the flat dict that per-round
metric records and ``RunResult.summary()["obs"]`` enumerate:

* ``core.logit_bank.teacher_forwards``: teacher batch forwards, from bank
  builds and on-the-fly distillation chunks alike;
* ``core.faults.corrupted`` / ``quarantined`` / ``retries``: the fault
  pipeline's decisions (docs/robustness.md);
* ``dist.*``: the distributed driver's wire telemetry and the
  ``dist.pods_alive`` gauge (docs/distributed.md).

The JAX package's ``core.client.compiles`` and ``core.feddf.
chunk_compiles`` count ``jit`` retraces; nothing compiles in the port, so
neither is registered here.  The kernels' ``LAUNCHES`` dicts stay in
their modules.

Three instrument types, cheap enough for the hot path:

* :class:`Counter`, monotonic within a reset window (``add`` / ``reset``
  / ``count``);
* :class:`Gauge`, the last value set;
* :class:`Histogram`, running count / total / min / max.

Per-round streaming rides the ``RoundEvent`` observer chain:
:class:`MetricsObserver` snapshots the registry (plus the event's own
fields) every round and hands the record to sinks (:class:`JSONLSink`,
:class:`CSVSink`, :class:`MemorySink`).  Sinks append, so a resumed run
pointed at the same path continues the stream.
"""
from __future__ import annotations

import csv
import json
import os
import threading
from typing import Dict, List, Optional

import torch


class Counter:
    """Monotonic counter (``add`` / ``reset`` / ``count``)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        # bumped from the driver thread and the fusion worker alike
        with self._lock:
            self.count += int(n)

    def reset(self) -> None:
        self.count = 0

    def value(self):
        return self.count


class Gauge:
    """Last-set value; ``None`` until the first :meth:`set`."""

    def __init__(self, name: str = ""):
        self.name = name
        self._value = None

    def set(self, v) -> None:
        self._value = v

    def reset(self) -> None:
        self._value = None

    def value(self):
        return self._value


class Histogram:
    """Streaming count / total / min / max of observations."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def reset(self) -> None:
        self.count, self.total = 0, 0.0
        self.vmin = self.vmax = None

    def value(self):
        if not self.count:
            return None
        return {"count": self.count, "total": self.total,
                "mean": self.total / self.count,
                "min": self.vmin, "max": self.vmax}


class MetricsRegistry:
    """Get-or-create home for named instruments.  Re-registering a name
    returns the existing instrument; asking for it under another type is
    a wiring bug and raises."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif type(inst) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, object]:
        """Flat ``{name: value}`` of every instrument with a value."""
        with self._lock:
            items = list(self._instruments.items())
        out = {}
        for name, inst in items:
            v = inst.value()
            if v is not None:
                out[name] = v
        return out

    def reset(self) -> None:
        with self._lock:
            items = list(self._instruments.values())
        for inst in items:
            inst.reset()


#: Process-wide registry.
REGISTRY = MetricsRegistry()


def device_memory_watermark() -> Optional[int]:
    """Peak bytes the caching allocator handed out on any card this
    process has used (``torch.cuda.max_memory_allocated``), or ``None``
    when the process never initialised CUDA (a CPU run)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return max(torch.cuda.max_memory_allocated(d)
               for d in range(torch.cuda.device_count()))


# ---------------------------------------------------------------------------
# sinks + per-round streaming
# ---------------------------------------------------------------------------

class MemorySink:
    """In-memory record list (the test sink)."""

    def __init__(self):
        self.records: List[dict] = []

    def write(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class JSONLSink:
    """One JSON object per line, append mode (a resume continues the
    file)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class CSVSink:
    """Flat CSV; nested values are JSON-encoded into their cell.  The
    first record fixes the header (an appending run must match it)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")
        self._writer = None
        self._fields = None

    def write(self, record: dict) -> None:
        flat = {k: (json.dumps(v) if isinstance(v, (dict, list)) else v)
                for k, v in record.items()}
        if self._writer is None:
            self._fields = list(flat)
            self._writer = csv.DictWriter(self._f, fieldnames=self._fields,
                                          extrasaction="ignore")
            if self._f.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow({k: flat.get(k, "") for k in self._fields})
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MetricsObserver:
    """RoundEvent observer streaming one record per round into sinks.
    Counters are emitted as deltas since the previous record, so a record
    says what its round cost; the running totals stay on the registry."""

    def __init__(self, sinks, registry: Optional[MetricsRegistry] = None):
        self.sinks = list(sinks)
        self.registry = registry or REGISTRY
        self._prev_counters: Dict[str, int] = {}

    def __call__(self, event) -> None:
        snap = self.registry.snapshot()
        record = {"round": int(event.round),
                  "group": int(getattr(event, "group", 0)),
                  "test_acc": float(event.log.test_acc),
                  "val_acc": float(event.log.val_acc)}
        wm = device_memory_watermark()
        if wm is not None:
            record["device_peak_bytes"] = wm
        for name, v in sorted(snap.items()):
            if isinstance(v, int):  # counters: per-round delta
                record[name] = v - self._prev_counters.get(name, 0)
                self._prev_counters[name] = v
            else:
                record[name] = v
        for sink in self.sinks:
            sink.write(record)

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()
