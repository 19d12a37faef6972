"""Perf history as a contract: one versioned JSONL every bench appends to.

The JAX package's record type, schema and all, so that one
``BENCH_history.jsonl`` and one gate read records from both packages::

    {"schema_version": 1,
     "bench": "driver",            # which bench produced it
     "case": "default",            # sub-case within the bench
     "created_unix": 1730000000.0,
     "machine": {"platform": ..., "python": ..., "cpus": ...,
                 "torch": ..., "cuda": ..., "device": ...},
     "config": {...},              # bench knobs (rounds, K, dims, ...)
     "metrics": {...}}             # the gated numbers

``machine`` names the card (``torch.cuda.get_device_name``) and the torch
and CUDA versions where the JAX package names its JAX version and
backend; the schema leaves ``machine``'s keys free.  ``load`` returns
every record, ``latest`` the newest per (bench, case).
"""
from __future__ import annotations

import json
import os
import platform
import time
from typing import Dict, List, Optional, Tuple

import torch

SCHEMA_VERSION = 1

DEFAULT_PATH = "BENCH_history.jsonl"

_REQUIRED = ("schema_version", "bench", "case", "created_unix", "machine",
             "config", "metrics")


def machine_fingerprint() -> dict:
    """Where the numbers came from: enough to explain a cross-machine
    delta, with the card's name when the process has one."""
    fp = {"platform": platform.platform(),
          "python": platform.python_version(),
          "cpus": os.cpu_count(),
          "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "backend": "cuda" if torch.cuda.is_available() else "cpu"}
    if torch.cuda.is_available():
        fp["device"] = torch.cuda.get_device_name(0)
    return fp


def make_record(bench: str, metrics: dict, config: Optional[dict] = None,
                case: str = "default") -> dict:
    rec = {"schema_version": SCHEMA_VERSION, "bench": str(bench),
           "case": str(case), "created_unix": time.time(),
           "machine": machine_fingerprint(),
           "config": dict(config or {}), "metrics": dict(metrics)}
    validate_record(rec)
    return rec


def validate_record(rec: dict) -> None:
    """Raise ``ValueError`` on any shape violation."""
    if not isinstance(rec, dict):
        raise ValueError(f"history record must be a dict, got {type(rec)}")
    missing = [k for k in _REQUIRED if k not in rec]
    if missing:
        raise ValueError(f"history record missing keys: {missing}")
    extra = [k for k in rec if k not in _REQUIRED]
    if extra:
        raise ValueError(f"history record has unknown keys: {extra}")
    if rec["schema_version"] != SCHEMA_VERSION:
        raise ValueError(
            f"history schema_version {rec['schema_version']!r} != "
            f"{SCHEMA_VERSION}")
    for k in ("bench", "case"):
        if not isinstance(rec[k], str) or not rec[k]:
            raise ValueError(f"history record {k!r} must be a non-empty str")
    for k in ("machine", "config", "metrics"):
        if not isinstance(rec[k], dict):
            raise ValueError(f"history record {k!r} must be a dict")
    if not isinstance(rec["created_unix"], (int, float)):
        raise ValueError("history record created_unix must be numeric")
    json.dumps(rec)  # must be losslessly serializable


def append(rec: dict, path: Optional[str] = None) -> str:
    """Validate and append one record; returns the path written."""
    validate_record(rec)
    path = path or DEFAULT_PATH
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return path


def load(path: Optional[str] = None) -> List[dict]:
    """Every record in the file, validated; ``[]`` if absent."""
    path = path or DEFAULT_PATH
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
            try:
                validate_record(rec)
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: {e}") from e
            out.append(rec)
    return out


def latest(path: Optional[str] = None) -> Dict[Tuple[str, str], dict]:
    """Newest record per ``(bench, case)``."""
    by_key: Dict[Tuple[str, str], dict] = {}
    for rec in load(path):
        key = (rec["bench"], rec["case"])
        prev = by_key.get(key)
        if prev is None or rec["created_unix"] >= prev["created_unix"]:
            by_key[key] = rec
    return by_key
