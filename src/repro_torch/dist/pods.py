"""Client pods: the training half of the distributed runtime.

A :class:`ClientPodRunner` serves TRAIN frames against its engine: it
decodes the round globals off the wire, trains exactly the client ids the
frame names (``engine.build_round_batches`` + ``engine.train_clients`` on
the engine's device), and replies with one UPLOAD frame holding one
codec-encoded blob per client, the params in the JAX package's leaf
order.  It is transport-agnostic (one code path serves a loopback queue
pair and a TCP socket) and stateless across rounds: everything a round
needs arrives in the frame, so the fusion pod can re-route any client to
any live pod.

Client k homes on pod ``k % n_pods`` (:func:`shard_clients`); homing is
only a routing default.  Re-dispatch after a pod death sends the same ids
elsewhere and the trajectory is unchanged, because a client's training is
a function of (round, client, globals) alone: the engine pads every step
bucket's client axis to its run-fixed size, so a pod's products run at
the same shapes as the fusion pod's would.

``python -m repro_torch.dist.pods`` is the TCP subprocess entry: it
rebuilds the engine from the serialized ExperimentSpec on the device it
is told (``--device``, the fusion pod's; ``cuda`` raises without a card)
and serves until SHUTDOWN or socket close.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.pytree import tree_leaves_jax, tree_unflatten_jax
from repro_torch.dist import frames as fr
from repro_torch.dist.transport import PodEndpoint


def shard_clients(client_ids: Sequence[int], n_pods: int) -> List[List[int]]:
    """Home pod assignment: pod j serves [k for k in ids if k % n_pods ==
    j]."""
    out: List[List[int]] = [[] for _ in range(n_pods)]
    for k in client_ids:
        out[int(k) % n_pods].append(int(k))
    return out


class ClientPodRunner:
    """Serves TRAIN frames for one pod over a :class:`PodEndpoint`.

    ``lock`` serialises the training of loopback pod threads (one
    process, one device); a TCP pod owns its process and passes none.
    ``kill()`` stops the pod abruptly: a round in flight never uploads,
    heartbeats cease, and the fusion pod's liveness tracking must recover
    (the chaos harness's crash point)."""

    def __init__(self, engine, pod: int, endpoint: PodEndpoint, *,
                 heartbeat_s: float = 5.0,
                 lock: Optional[threading.Lock] = None):
        self.engine = engine
        self.pod = int(pod)
        self.endpoint = endpoint
        self.heartbeat_s = float(heartbeat_s)
        self.lock = lock if lock is not None else threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # per prototype: the tree to rebuild and the leaf templates
        # (shapes, dtypes) that decode the wire globals
        self._likes = [net.init(torch.Generator().manual_seed(0))
                       for net in engine.nets]
        self._templates = [[l.numpy() for l in tree_leaves_jax(like)]
                           for like in self._likes]

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ClientPodRunner":
        """Serve and heartbeat on daemon threads (loopback transport)."""
        for target in (self.serve, self._heartbeat_loop):
            th = threading.Thread(target=target, daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def serve_forever(self) -> None:
        """Heartbeat on a thread, serve inline (tcp subprocess entry)."""
        th = threading.Thread(target=self._heartbeat_loop, daemon=True)
        th.start()
        self._threads.append(th)
        self.serve()

    def kill(self) -> None:
        """Abrupt crash: stop serving and heartbeating immediately."""
        self._stop.set()

    def join(self, timeout: float) -> None:
        """Wait for the pod's threads after :meth:`kill`."""
        for th in self._threads:
            th.join(timeout)

    @property
    def killed(self) -> bool:
        return self._stop.is_set()

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self.endpoint.send(fr.encode_frame(fr.Frame(
                    kind=fr.HEARTBEAT, meta={"pod": self.pod})))
            except OSError:
                return

    # -- serving ---------------------------------------------------------

    def serve(self) -> None:
        while not self._stop.is_set():
            data = self.endpoint.recv(timeout=0.05)
            if data is None:
                continue
            try:
                frame = fr.decode_frame(data)
            except fr.FrameError:
                continue  # downlink garbage: the deadline re-dispatches
            if frame.kind == fr.SHUTDOWN:
                return
            if frame.kind != fr.TRAIN:
                continue
            reply = self._handle_train(frame)
            # checked AFTER training: a pod killed mid-round never uploads
            if self._stop.is_set():
                return
            self.endpoint.send(reply)

    def _handle_train(self, frame: fr.Frame) -> bytes:
        eng = self.engine
        t = int(frame.round)
        ids = [int(k) for k in frame.client_ids]
        codec = fr.get_codec(frame.meta.get("codec", "fp32"))
        fp32 = fr.get_codec("fp32")
        # the downlink globals are always fp32: decoding is exact, so the
        # pod trains from the fusion pod's params bit for bit
        blobs = fr.unpack_blobs(frame.payload, len(eng.nets))
        globals_ = [
            tree_unflatten_jax(self._likes[p], [
                torch.from_numpy(l).to(eng.device)
                for l in fp32.decode(blob, self._templates[p])])
            for p, blob in enumerate(blobs)]
        with self.lock:
            batches = eng.build_round_batches(t, np.asarray(ids, np.int64))
            groups = eng.train_clients(t, globals_, batches)
        per_client: Dict[int, bytes] = {}
        for g, rb in zip(groups, batches):
            if rb is None or g.stack is None:
                continue
            host = [l.detach().cpu().numpy()
                    for l in tree_leaves_jax(g.stack)]
            for i, k in enumerate(rb.ks):
                per_client[int(k)] = codec.encode([h[i] for h in host])
        reply = fr.Frame(
            kind=fr.UPLOAD, round=t, wave=int(frame.wave), client_ids=ids,
            codec_id=codec.codec_id,
            meta={"pod": self.pod, "req": frame.meta.get("req"),
                  "attempt": int(frame.meta.get("attempt", 0))},
            payload=fr.pack_blobs([per_client[k] for k in ids]))
        return fr.encode_frame(reply)


# ---------------------------------------------------------------------------
# tcp subprocess entry


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="repro_torch client pod (tcp transport)")
    ap.add_argument("--spec", required=True,
                    help="path of the serialized ExperimentSpec")
    ap.add_argument("--pod", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--heartbeat-s", type=float, default=5.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the fusion pod's device; cuda raises without a "
                         "card")
    args = ap.parse_args(argv)

    from repro_torch.api.experiment import build_engine
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.dist.transport import TCPPodEndpoint

    engine = build_engine(ExperimentSpec.load(args.spec), args.device)
    endpoint = TCPPodEndpoint(args.host, args.port, args.pod)
    try:
        ClientPodRunner(engine, args.pod, endpoint,
                        heartbeat_s=args.heartbeat_s).serve_forever()
    finally:
        endpoint.close()


if __name__ == "__main__":
    main()
