"""Versioned, checksummed wire format of the distributed runtime.

A copy of the JAX package's wire format (``repro/dist/frames.py``), so
that a frame either package encodes decodes in the other and the two
encode the same arrays to the same bytes.  A frame is ``(version, kind,
codec_id, round, wave, client_ids, meta, payload)`` plus a trailing CRC32
over everything after the magic, so a bit flip in transit is detected
before the payload is trusted; the version is checked before the CRC, so
a peer on another revision is reported as such.  The codecs are the
transport face of the quantizers: ``binarize`` applies the ``binarize``
quantizer's sign * mean|w| transform (``core/quantize.py``) and its bytes
match ``quantize.comm_bytes(params, binarized=True)``; ``int8`` is the
absmax codec of the int8 logit bank applied to params.

Frames are numpy bytes, whatever device the params live on; the wire
log rides the record log of ``checkpoint/io.py``.
"""
from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.checkpoint.io import append_record, read_records

MAGIC = b"RW"
WIRE_VERSION = 1

# frame kinds
HELLO = 0  # pod -> fusion: {"pod": j} introduction (tcp connection mapping)
TRAIN = 1  # fusion -> pod: round globals + the client ids to train
UPLOAD = 2  # pod -> fusion: trained client deltas, one blob per client id
HEARTBEAT = 3  # pod -> fusion: liveness beacon, every heartbeat_s
SHUTDOWN = 4  # fusion -> pod: drain and exit

KIND_NAMES = {HELLO: "hello", TRAIN: "train", UPLOAD: "upload",
              HEARTBEAT: "heartbeat", SHUTDOWN: "shutdown"}

_HEADER = struct.Struct("<HBBII")  # version, kind, codec_id, round, wave
_U32 = struct.Struct("<I")
_F32 = struct.Struct("<f")


class FrameError(Exception):
    """Malformed frame (bad magic, truncation, garbage lengths)."""


class CRCError(FrameError):
    """Checksum mismatch — payload corrupted in transit."""


class VersionError(FrameError):
    """Peer speaks a different wire version."""


@dataclass
class Frame:
    kind: int
    round: int = 0
    wave: int = 0
    client_ids: Sequence[int] = ()
    codec_id: int = 0
    meta: Dict = field(default_factory=dict)
    payload: bytes = b""
    version: int = WIRE_VERSION


def encode_frame(frame: Frame) -> bytes:
    ids = np.asarray(list(frame.client_ids), dtype=np.int64)
    meta = json.dumps(frame.meta, sort_keys=True).encode("utf-8")
    body = b"".join(
        [
            _HEADER.pack(frame.version, frame.kind, frame.codec_id,
                         frame.round, frame.wave),
            _U32.pack(ids.size),
            ids.tobytes(),
            _U32.pack(len(meta)),
            meta,
            _U32.pack(len(frame.payload)),
            frame.payload,
        ]
    )
    return MAGIC + body + _U32.pack(zlib.crc32(body) & 0xFFFFFFFF)


def decode_frame(data: bytes, *, verify_crc: bool = True) -> Frame:
    if len(data) < len(MAGIC) + _HEADER.size + 3 * _U32.size + _U32.size:
        raise FrameError(f"frame too short ({len(data)} bytes)")
    if data[: len(MAGIC)] != MAGIC:
        raise FrameError("bad magic")
    body, crc_bytes = data[len(MAGIC):-_U32.size], data[-_U32.size:]
    version, kind, codec_id, rnd, wave = _HEADER.unpack_from(body, 0)
    # version precedes CRC: a peer on another protocol revision is
    # reported as such, not as line noise
    if version != WIRE_VERSION:
        raise VersionError(f"wire version {version} != {WIRE_VERSION}")
    if verify_crc and _U32.unpack(crc_bytes)[0] != (zlib.crc32(body) & 0xFFFFFFFF):
        raise CRCError("frame CRC mismatch")
    off = _HEADER.size
    (n_ids,) = _U32.unpack_from(body, off)
    off += _U32.size
    if off + 8 * n_ids > len(body):
        raise FrameError("truncated client_ids")
    ids = np.frombuffer(body, dtype=np.int64, count=n_ids, offset=off)
    off += 8 * n_ids
    (meta_len,) = _U32.unpack_from(body, off)
    off += _U32.size
    if off + meta_len > len(body):
        raise FrameError("truncated meta")
    try:
        meta = json.loads(body[off: off + meta_len].decode("utf-8")) if meta_len else {}
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"undecodable meta: {e}")
    off += meta_len
    (payload_len,) = _U32.unpack_from(body, off)
    off += _U32.size
    if off + payload_len > len(body):
        raise FrameError("truncated payload")
    payload = bytes(body[off: off + payload_len])
    return Frame(kind=kind, round=rnd, wave=wave, client_ids=[int(i) for i in ids],
                 codec_id=codec_id, meta=meta, payload=payload, version=version)


# ---------------------------------------------------------------------------
# blob packing: an UPLOAD payload is one length-prefixed blob per client id


def pack_blobs(blobs: Sequence[bytes]) -> bytes:
    return b"".join(_U32.pack(len(b)) + b for b in blobs)


def unpack_blobs(data: bytes, n: int) -> List[bytes]:
    out, off = [], 0
    for _ in range(n):
        if off + _U32.size > len(data):
            raise FrameError("truncated blob stream")
        (ln,) = _U32.unpack_from(data, off)
        off += _U32.size
        if off + ln > len(data):
            raise FrameError("truncated blob")
        out.append(bytes(data[off: off + ln]))
        off += ln
    if off != len(data):
        raise FrameError(f"{len(data) - off} trailing bytes after {n} blobs")
    return out


# ---------------------------------------------------------------------------
# codec registry — the quantizer registry as a transport codec

# eligibility mirrors core/quantize.py: only float leaves with ndim >= 2
# and size >= _MIN_SIZE are binarized; everything else rides fp32
_MIN_SIZE = 32


def _binarizable(t: np.ndarray) -> bool:
    return np.issubdtype(t.dtype, np.floating) and t.ndim >= 2 and t.size >= _MIN_SIZE


class Codec:
    """Encodes a flat leaf list to bytes and back, with exact accounting.

    ``decode`` needs the leaf templates (shapes/dtypes of the current
    globals) — the stream itself carries no shape info, which keeps
    ``len(encode(leaves)) == nbytes(templates)`` an exact identity.
    """

    name: str = ""
    codec_id: int = -1

    def encode(self, leaves: Sequence[np.ndarray]) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes, templates: Sequence[np.ndarray]) -> List[np.ndarray]:
        raise NotImplementedError

    def nbytes(self, templates: Sequence[np.ndarray]) -> int:
        raise NotImplementedError


class Fp32Codec(Codec):
    """Exact: raw little-endian bytes per leaf. The degenerate codec —
    distributed + fp32 + zero faults is bit-identical to ``sync``."""

    name, codec_id = "fp32", 0

    def encode(self, leaves):
        return b"".join(np.ascontiguousarray(l).tobytes() for l in leaves)

    def decode(self, data, templates):
        out, off = [], 0
        for t in templates:
            t = np.asarray(t)
            n = t.size * t.dtype.itemsize
            if off + n > len(data):
                raise FrameError("fp32 blob shorter than templates")
            out.append(np.frombuffer(data, dtype=t.dtype, count=t.size,
                                     offset=off).reshape(t.shape).copy())
            off += n
        if off != len(data):
            raise FrameError("fp32 blob longer than templates")
        return out

    def nbytes(self, templates):
        return sum(np.asarray(t).size * np.asarray(t).dtype.itemsize for t in templates)


class BinarizeCodec(Codec):
    """sign * mean|w| one-bit codec; bytes match comm_bytes(binarized=True).

    Eligible leaves (float, ndim>=2, size>=32) ship one fp32 scale + one
    sign bit per weight; the rest ride fp32.  Decoded values are
    +-scale (an exact zero decodes as +scale — one bit has no zero).
    """

    name, codec_id = "binarize", 1

    def encode(self, leaves):
        parts = []
        for l in leaves:
            l = np.ascontiguousarray(l)
            if _binarizable(l):
                scale = np.float32(np.mean(np.abs(l)))
                bits = np.packbits((l >= 0).reshape(-1))
                parts.append(_F32.pack(float(scale)) + bits.tobytes())
            else:
                parts.append(l.tobytes())
        return b"".join(parts)

    def decode(self, data, templates):
        out, off = [], 0
        for t in templates:
            t = np.asarray(t)
            if _binarizable(t):
                (scale,) = _F32.unpack_from(data, off)
                off += _F32.size
                nb = (t.size + 7) // 8
                bits = np.unpackbits(
                    np.frombuffer(data, dtype=np.uint8, count=nb, offset=off),
                    count=t.size)
                off += nb
                vals = np.where(bits.astype(bool), scale, -scale)
                out.append(vals.astype(t.dtype).reshape(t.shape))
            else:
                n = t.size * t.dtype.itemsize
                out.append(np.frombuffer(data, dtype=t.dtype, count=t.size,
                                         offset=off).reshape(t.shape).copy())
                off += n
        if off != len(data):
            raise FrameError("binarize blob length mismatch")
        return out

    def nbytes(self, templates):
        total = 0
        for t in templates:
            t = np.asarray(t)
            if _binarizable(t):
                total += (t.size + 7) // 8 + 4  # packed bits + fp32 scale
            else:
                total += t.size * t.dtype.itemsize
        return total


class Int8Codec(Codec):
    """Low-bit absmax codec: int8 values + one fp32 scale per float leaf
    (the LogitBank int8-row layout applied to params). ~3.99x vs fp32."""

    name, codec_id = "int8", 2

    def encode(self, leaves):
        parts = []
        for l in leaves:
            l = np.ascontiguousarray(l)
            if np.issubdtype(l.dtype, np.floating):
                absmax = float(np.max(np.abs(l))) if l.size else 0.0
                scale = np.float32(absmax / 127.0) if absmax > 0 else np.float32(1.0)
                q = np.clip(np.rint(l / scale), -127, 127).astype(np.int8)
                parts.append(_F32.pack(float(scale)) + q.tobytes())
            else:
                parts.append(l.tobytes())
        return b"".join(parts)

    def decode(self, data, templates):
        out, off = [], 0
        for t in templates:
            t = np.asarray(t)
            if np.issubdtype(t.dtype, np.floating):
                (scale,) = _F32.unpack_from(data, off)
                off += _F32.size
                q = np.frombuffer(data, dtype=np.int8, count=t.size, offset=off)
                off += t.size
                out.append((q.astype(t.dtype) * t.dtype.type(scale)).reshape(t.shape))
            else:
                n = t.size * t.dtype.itemsize
                out.append(np.frombuffer(data, dtype=t.dtype, count=t.size,
                                         offset=off).reshape(t.shape).copy())
                off += n
        if off != len(data):
            raise FrameError("int8 blob length mismatch")
        return out

    def nbytes(self, templates):
        total = 0
        for t in templates:
            t = np.asarray(t)
            if np.issubdtype(t.dtype, np.floating):
                total += t.size + 4  # int8 values + fp32 scale
            else:
                total += t.size * t.dtype.itemsize
        return total


_CODECS: Dict[str, Codec] = {}
_BY_ID: Dict[int, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    if codec.name in _CODECS:
        raise ValueError(f"wire codec {codec.name!r} already registered")
    if codec.codec_id in _BY_ID:
        raise ValueError(f"wire codec id {codec.codec_id} already registered")
    _CODECS[codec.name] = codec
    _BY_ID[codec.codec_id] = codec
    return codec


def get_codec(name: str) -> Codec:
    if name not in _CODECS:
        raise KeyError(f"unknown wire codec {name!r}; have {available_codecs()}")
    return _CODECS[name]


def codec_by_id(codec_id: int) -> Codec:
    if codec_id not in _BY_ID:
        raise FrameError(f"unknown wire codec id {codec_id}")
    return _BY_ID[codec_id]


def available_codecs() -> List[str]:
    return sorted(_CODECS)


register_codec(Fp32Codec())
register_codec(BinarizeCodec())
register_codec(Int8Codec())


# ---------------------------------------------------------------------------
# wire log: append-only record of accepted UPLOAD frames, replayed on
# fusion-pod restart so in-flight work is not re-dispatched


class WireLog:
    def __init__(self, path: str):
        self.path = path

    def append(self, frame_bytes: bytes) -> None:
        append_record(self.path, frame_bytes)

    def replay(self, round_: int) -> List[Frame]:
        """Decoded UPLOAD frames of ``round_``; skips undecodable records
        (a torn tail from a crash mid-append is expected, not fatal)."""
        out = []
        for rec in read_records(self.path):
            try:
                f = decode_frame(rec)
            except FrameError:
                continue
            if f.kind == UPLOAD and f.round == round_:
                out.append(f)
        return out
