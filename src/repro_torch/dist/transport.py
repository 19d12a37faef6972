"""Transports of the distributed runtime: loopback queues and TCP.

Both expose the same two faces:

- the **fusion side** (:class:`LoopbackTransport` / :class:`TCPTransport`):
  ``send(pod, data)`` plus a single merged inbox ``recv(timeout)`` that
  yields ``(pod, data)`` — sender attribution is transport-level, not
  frame-level, so a corrupted frame can still be attributed and retried
  against the right pod;
- the **pod side** (:class:`PodEndpoint`): ``send(data)`` /
  ``recv(timeout)`` / ``close()``, identical for an in-process pod thread
  and a TCP subprocess, so :class:`repro_torch.dist.pods.
  ClientPodRunner` is transport-agnostic.

TCP streams are length-prefixed (u32) raw frame bytes on localhost; pod
identity is established by the first HELLO frame on each connection.
"""
from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import List, Optional, Tuple

from repro_torch.dist import frames as fr

_LEN = struct.Struct("<I")
# cap a single wire message at 1 GiB: a corrupted length prefix must not
# turn into an attempted giant allocation
_MAX_MSG = 1 << 30


class TransportError(Exception):
    pass


class PodEndpoint:
    """The pod-side half of a transport: one send/recv pair."""

    def send(self, data: bytes) -> None:
        raise NotImplementedError

    def recv(self, timeout: float) -> Optional[bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# loopback: in-process queue pairs


class _LoopbackEndpoint(PodEndpoint):
    def __init__(self, transport: "LoopbackTransport", pod: int):
        self._t = transport
        self._pod = pod

    def send(self, data: bytes) -> None:
        self._t._to_fusion.put((self._pod, data))

    def recv(self, timeout: float) -> Optional[bytes]:
        try:
            return self._t._to_pod[self._pod].get(timeout=timeout)
        except queue.Empty:
            return None


class LoopbackTransport:
    """Single-machine transport: pods are threads, links are queues."""

    def __init__(self, n_pods: int):
        self.n_pods = int(n_pods)
        self._to_pod: List[queue.Queue] = [queue.Queue() for _ in range(n_pods)]
        self._to_fusion: queue.Queue = queue.Queue()

    def endpoint(self, pod: int) -> PodEndpoint:
        return _LoopbackEndpoint(self, pod)

    # -- fusion side -----------------------------------------------------

    def send(self, pod: int, data: bytes) -> None:
        self._to_pod[pod].put(data)

    def recv(self, timeout: float) -> Optional[Tuple[int, bytes]]:
        try:
            return self._to_fusion.get(timeout=max(timeout, 1e-3))
        except queue.Empty:
            return None

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# tcp: localhost sockets, one subprocess per pod


def _send_msg(sock: socket.socket, data: bytes) -> None:
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None  # peer closed
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> Optional[bytes]:
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > _MAX_MSG:
        raise TransportError(f"wire message of {n} bytes exceeds cap")
    return _recv_exact(sock, n)


class TCPTransport:
    """Fusion-side TCP listener; pods dial in and HELLO with their id."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.host, self.port = self._srv.getsockname()
        self._conns: dict = {}
        self._inbox: queue.Queue = queue.Queue()
        self._readers: List[threading.Thread] = []
        self._closed = threading.Event()

    def accept(self, n_pods: int, timeout: float = 60.0) -> None:
        """Block until all ``n_pods`` pods have dialed in and HELLO'd."""
        self._srv.settimeout(timeout)
        while len(self._conns) < n_pods:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                raise TransportError(
                    f"only {len(self._conns)}/{n_pods} pods connected "
                    f"within {timeout}s")
            data = _recv_msg(conn)
            if data is None:
                conn.close()
                continue
            hello = fr.decode_frame(data)
            if hello.kind != fr.HELLO:
                conn.close()
                raise TransportError(
                    f"expected HELLO, got kind {hello.kind}")
            pod = int(hello.meta["pod"])
            self._conns[pod] = conn
            th = threading.Thread(target=self._reader, args=(pod, conn),
                                  daemon=True)
            th.start()
            self._readers.append(th)

    def _reader(self, pod: int, conn: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                data = _recv_msg(conn)
                if data is None:
                    return
                self._inbox.put((pod, data))
        except (OSError, TransportError):
            return

    # -- fusion side -----------------------------------------------------

    def send(self, pod: int, data: bytes) -> None:
        conn = self._conns.get(pod)
        if conn is None:
            return  # pod never connected / already gone: deadline handles it
        try:
            _send_msg(conn, data)
        except OSError:
            pass  # dead peer: liveness tracking re-routes its clients

    def recv(self, timeout: float) -> Optional[Tuple[int, bytes]]:
        try:
            return self._inbox.get(timeout=max(timeout, 1e-3))
        except queue.Empty:
            return None

    def close(self) -> None:
        self._closed.set()
        for conn in self._conns.values():
            try:
                conn.close()
            except OSError:
                pass
        try:
            self._srv.close()
        except OSError:
            pass


class TCPPodEndpoint(PodEndpoint):
    """Pod-side TCP client; sends HELLO on connect."""

    def __init__(self, host: str, port: int, pod: int):
        self._sock = socket.create_connection((host, port), timeout=60.0)
        self._pod = int(pod)
        _send_msg(self._sock, fr.encode_frame(
            fr.Frame(kind=fr.HELLO, meta={"pod": self._pod})))

    def send(self, data: bytes) -> None:
        _send_msg(self._sock, data)

    def recv(self, timeout: float) -> Optional[bytes]:
        self._sock.settimeout(max(timeout, 1e-3))
        try:
            return _recv_msg(self._sock)
        except socket.timeout:
            return None

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
