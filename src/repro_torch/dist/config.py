"""Runtime config of the distributed fusion-pod / client-pod topology.

Dependency-free (stdlib only), so that ``FLConfig`` embeds it without
importing transports.  See ``docs/distributed.md`` for the pod topology
and the wire format.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.common.options import TRANSPORT_KINDS


@dataclass
class DistConfig:
    """Knobs of the ``distributed`` driver (``repro_torch.dist.driver``).

    transport          "loopback" (in-process pod threads over queue
                       pairs) or "tcp" (one OS process per client pod
                       over localhost).
    wire_codec         uplink codec name from ``repro_torch.dist.frames``:
                       "fp32" is exact (the degenerate config equals
                       ``sync`` bit for bit), "binarize" / "int8" are the
                       paper's low-bit uploads as bandwidth engineering.
                       The downlink (globals) is always fp32.
    n_pods             number of client pods; client k homes on pod
                       k % n_pods.
    heartbeat_s        pod heartbeat period; a pod silent for
                       3 * heartbeat_s is presumed dead and its clients
                       re-route to a live pod.
    upload_deadline_s  per-upload deadline of attempt 0; attempt a waits
                       upload_deadline_s * faults.backoff ** a.
    verify_crc         False disables CRC rejection (the undefended
                       transport, a benchmark ablation only).
    wire_log           optional path of the append-only accepted-upload
                       log; a restarted fusion pod replays the resumed
                       round's uploads from it instead of re-dispatching.
    kill_pod /         chaos hook (loopback only): kill pod ``kill_pod``
    kill_after_round   right after round ``kill_after_round``'s dispatch.
    spec_json          the serialized ExperimentSpec handed to tcp pod
                       subprocesses so that they rebuild an identical
                       engine; filled by ``api.experiment.to_fl_config``.
    """

    transport: str = "loopback"
    wire_codec: str = "fp32"
    n_pods: int = 2
    heartbeat_s: float = 5.0
    upload_deadline_s: float = 30.0
    verify_crc: bool = True
    wire_log: Optional[str] = None
    kill_pod: Optional[int] = None
    kill_after_round: int = 0
    spec_json: Optional[str] = None

    def validate(self) -> "DistConfig":
        if self.transport not in TRANSPORT_KINDS:
            raise ValueError(
                f"dist.transport must be one of {TRANSPORT_KINDS}, got "
                f"{self.transport!r}")
        from repro_torch.dist.frames import available_codecs

        if self.wire_codec not in available_codecs():
            raise ValueError(
                f"dist.wire_codec must be one of {available_codecs()}, got "
                f"{self.wire_codec!r}")
        if self.n_pods < 1:
            raise ValueError(f"dist.n_pods must be >= 1, got {self.n_pods}")
        if self.heartbeat_s <= 0:
            raise ValueError(
                f"dist.heartbeat_s must be > 0, got {self.heartbeat_s}")
        if self.upload_deadline_s <= 0:
            raise ValueError(
                f"dist.upload_deadline_s must be > 0, got "
                f"{self.upload_deadline_s}")
        return self
