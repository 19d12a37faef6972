"""Distributed runtime: a fusion pod and client pods over a wire protocol
(docs/distributed.md).

Eagerly exposes only the dependency-light pieces (``DistConfig`` and the
wire format), so that ``core.engine`` can embed the config without
importing transports; the driver registers itself through
``repro_torch.drivers`` (importing it here would close an import cycle:
engine -> dist -> driver -> engine).
"""
from repro_torch.dist.config import DistConfig
from repro_torch.dist.frames import (available_codecs, codec_by_id,
                                     decode_frame, encode_frame, get_codec)

__all__ = ["DistConfig", "available_codecs", "codec_by_id", "decode_frame",
           "encode_frame", "get_codec"]


def __getattr__(name):
    if name == "DistributedDriver":
        from repro_torch.dist.driver import DistributedDriver
        return DistributedDriver
    if name in ("ClientPodRunner", "shard_clients"):
        import repro_torch.dist.pods as pods
        return getattr(pods, name)
    if name in ("LoopbackTransport", "TCPTransport", "TCPPodEndpoint"):
        import repro_torch.dist.transport as transport
        return getattr(transport, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
