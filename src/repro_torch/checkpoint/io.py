"""Tree checkpointing: a flat ``.npz`` of ``leaf_{i}`` arrays + a JSON
manifest, in the JAX package's layout, so each package reads the other's
round snapshots.

``leaf_{i}`` numbers the leaves in the JAX package's order
(``common/pytree.tree_leaves_jax``: dict keys sorted), and the manifest
keeps the JAX package's keys (``treedef`` holds the port's own
description of the tree, which neither package parses back).  bfloat16
is stored as its uint16 bits (numpy has no bfloat16).

All writes are atomic: payload and manifest land in same-directory temp
files first and are moved into place with ``os.replace``, manifest LAST,
so a crash mid-write leaves either the previous complete checkpoint or a
stray ``.tmp`` file, never a truncated pair that loads garbage.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.common.pytree import (tree_leaves_jax, tree_paths_jax,
                                       tree_unflatten_jax)


def _atomic_savez(path: str, arrays: dict) -> None:
    """Write ``arrays`` to ``path`` through a same-directory temp file and
    ``os.replace`` (atomic on POSIX within one filesystem)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _atomic_json(path: str, payload: dict, **dump_kwargs) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, **dump_kwargs)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".manifest.json"


def _encode_leaf(x, name: str, dtypes: dict) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            dtypes[name] = "bfloat16"
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _decode_leaf(a: np.ndarray, name: str, dtypes: dict):
    """numpy, or for bfloat16 a CPU tensor (numpy has no bfloat16)."""
    if dtypes.get(name) == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16)).view(torch.bfloat16)
    return a


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Write ``tree``'s leaves (tensors on any device, arrays, scalars)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = tree_leaves_jax(tree)
    arrays, dtypes = {}, {}
    for i, x in enumerate(leaves):
        arrays[f"leaf_{i}"] = _encode_leaf(x, f"leaf_{i}", dtypes)
    _atomic_savez(_npz_path(path), arrays)
    # manifest last: its presence marks the checkpoint complete
    _atomic_json(_manifest_path(path), {
        "treedef": f"repro_torch leaf paths {tree_paths_jax(tree)}",
        "n_leaves": len(leaves),
        "dtypes": dtypes,
        "metadata": metadata or {},
    }, indent=2)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf comes back as a tensor on its template leaf's device, in the
    stored dtype."""
    with open(_manifest_path(path)) as f:
        dtypes = json.load(f).get("dtypes", {})
    want = tree_leaves_jax(like)
    with np.load(_npz_path(path)) as npz:
        loaded = []
        for i, w in enumerate(want):
            name = f"leaf_{i}"
            got = _decode_leaf(npz[name], name, dtypes)
            if tuple(got.shape) != tuple(w.shape):
                raise ValueError(f"checkpoint leaf shape {tuple(got.shape)}"
                                 f" != template {tuple(w.shape)}")
            loaded.append(torch.as_tensor(got).to(w.device))
    return tree_unflatten_jax(like, loaded)


def metadata(path: str) -> dict:
    with open(_manifest_path(path)) as f:
        return json.load(f)["metadata"]


# ---------------------------------------------------------------------------
# structure-aware object serialization (no template needed on restore)
# ---------------------------------------------------------------------------
#
# `save`/`restore` need a `like` template because the treedef string is not
# parsed back.  Server-strategy state has no natural template (fedavgm's
# momentum buffers only exist after the first round), so `save_obj` /
# `load_obj` record the structure explicitly: nested dict/list/tuple/None/
# scalars with array leaves swapped for npz references.  NamedTuples
# round-trip as tuples.

def save_obj(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: dict = {}
    dtypes: dict = {}

    def enc(o):
        if isinstance(o, (np.ndarray, np.generic, torch.Tensor)):
            i = len(arrays)
            arrays[f"leaf_{i}"] = _encode_leaf(o, f"leaf_{i}", dtypes)
            return {"__leaf__": i}
        if isinstance(o, dict):
            bad = [k for k in o if not isinstance(k, str)]
            if bad:
                raise TypeError(
                    f"save_obj requires string dict keys (JSON would "
                    f"silently coerce {bad[0]!r})")
            return {"__dict__": {k: enc(v) for k, v in o.items()}}
        if isinstance(o, (list, tuple)):
            return {"__seq__": [enc(v) for v in o],
                    "__tuple__": isinstance(o, tuple)}
        if o is None or isinstance(o, (bool, int, float, str)):
            return {"__val__": o}
        raise TypeError(f"save_obj cannot serialize {type(o).__name__}")

    structure = enc(obj)
    _atomic_savez(_npz_path(path), arrays)
    _atomic_json(_manifest_path(path),
                 {"structure": structure, "dtypes": dtypes})


def load_obj(path: str) -> Any:
    """The object :func:`save_obj` wrote; array leaves come back as numpy
    arrays (bfloat16 ones as CPU tensors), whatever device they left."""
    with open(_manifest_path(path)) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    with np.load(_npz_path(path)) as npz:
        def dec(node):
            if "__leaf__" in node:
                name = f"leaf_{node['__leaf__']}"
                return _decode_leaf(npz[name], name, dtypes)
            if "__dict__" in node:
                return {k: dec(v) for k, v in node["__dict__"].items()}
            if "__seq__" in node:
                seq = [dec(v) for v in node["__seq__"]]
                return tuple(seq) if node.get("__tuple__") else seq
            return node["__val__"]

        return dec(manifest["structure"])


# ---------------------------------------------------------------------------
# append-only binary record log (the distributed runtime's wire log)
# ---------------------------------------------------------------------------
#
# Each record is ``u32 length + u32 crc32 + payload``, appended with an
# fsync so accepted uploads survive a fusion-pod crash.  Appends are NOT
# atomic (the log outlives the process), so readers tolerate a torn tail:
# the first truncated or checksum-failing record ends the scan, returning
# every complete record before it.

_REC_HEADER = 8  # u32 length + u32 crc


def append_record(path: str, payload: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    with open(path, "ab") as f:
        f.write(struct.pack("<II", len(payload), crc) + payload)
        f.flush()
        os.fsync(f.fileno())


def read_records(path: str) -> list:
    out: list = []
    if not os.path.exists(path):
        return out
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + _REC_HEADER <= len(data):
        length, crc = struct.unpack_from("<II", data, off)
        start = off + _REC_HEADER
        if start + length > len(data):
            break  # torn tail: append died mid-record
        payload = data[start: start + length]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break  # corrupted tail record
        out.append(payload)
        off = start + length
    return out
