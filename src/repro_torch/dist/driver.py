"""The ``distributed`` driver: a fusion pod coordinating client pods.

The fusion pod owns everything the sync driver's loop owns (cohort
sampling, the only rng consumer; ``fault_pipeline``; ``aggregate`` and
with it the logit bank and kernels K1 / K2; ``guard_globals``;
``evaluate_round``; the checkpoint hook), while client training happens
in client pods behind the wire protocol of ``repro_torch.dist.frames``:

    sample_cohort -> shard the cohort over pods -> TRAIN frames (fp32
    globals downlink) -> collect UPLOAD frames (configured codec)
    against per-attempt deadlines -> assemble stacks in the cohort's
    order -> fault_pipeline -> quorum -> aggregate -> guard -> evaluate

Robustness ladder, outermost first (docs/distributed.md):

- **CRC / version check** on every frame; a checksum failure re-dispatches
  with ``attempt + 1`` (a fresh transport-fault draw), and exhausted
  retries escalate to quarantine (``sampler.penalize``).
- **Per-upload deadlines** ``upload_deadline_s * backoff ** attempt``; a
  miss re-dispatches the missing clients to the request's pod while it
  looks alive, else to the next live pod.
- **Heartbeat liveness**: a pod silent for ``3 * heartbeat_s`` is presumed
  dead; its clients re-route at dispatch time, and its outstanding
  requests as soon as it falls silent.  Unlike the JAX package's driver,
  which waits for their deadline, so that a short deadline, and with it
  the retry count, hangs on how fast the pods train; and unlike it, the
  dispatch and the round's ``n_pods_alive`` first drain the frames that
  queued during the fusion, so a fusion longer than ``3 * heartbeat_s``
  does not make every live pod look dead.
- **Quorum degradation**: wire losses count against ``faults.quorum`` as
  screened-out uploads do; below quorum the round skips fusion and
  carries the globals.
- **Wire log**: accepted UPLOAD frames append to ``dist.wire_log``; a
  restarted fusion pod replays the resumed round's uploads instead of
  re-dispatching them.

The degenerate config (loopback or tcp, fp32 codec, no faults) equals the
``sync`` driver bit for bit: every phase is the same function of the same
inputs, the wire round trips are exact, and a pod's training does not
depend on which clients share its shard (``core/engine.py`` pads the
client axis).  TCP pods are subprocesses (``python -m repro_torch.dist.
pods``) on the fusion pod's device: on the card each builds its own CUDA
context.

``phase_seconds`` records per round ``sample_cohort``, ``wire_collect``
(dispatch, the pods' training, collection), ``assemble``,
``fault_pipeline``, ``aggregate`` (with the guard) and ``evaluate_round``.
"""
from __future__ import annotations

import heapq
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.pytree import tree_leaves_jax, tree_unflatten_jax
from repro_torch.core.engine import RoundEngine
from repro_torch.core.strategies import GroupRound
from repro_torch.dist import frames as fr
from repro_torch.dist.config import DistConfig
from repro_torch.dist.pods import ClientPodRunner, shard_clients
from repro_torch.dist.transport import LoopbackTransport, TCPTransport
from repro_torch.drivers.base import _UNSET, Driver, register_driver
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import REGISTRY

# byte offset of the frame-kind field (magic + u16 version), used to
# classify a possibly-corrupted frame without decoding it
_KIND_OFF = len(fr.MAGIC) + 2

# seconds the fusion pod waits for tcp pods to dial in: each builds its
# engine (and, on the card, its CUDA context) first
_ACCEPT_TIMEOUT_S = 300.0


class _Runtime:
    """Pods, transport and the cross-round liveness state of one run."""

    def __init__(self, transport, n_pods: int):
        self.transport = transport
        self.n_pods = n_pods
        now = time.monotonic()
        self.last_seen: Dict[int, float] = {j: now for j in range(n_pods)}
        self.runners: List[ClientPodRunner] = []  # loopback only
        self.procs: List[subprocess.Popen] = []   # tcp only
        self.tmpdir: Optional[str] = None
        self.startup_s = 0.0

    def close(self) -> None:
        for j in range(self.n_pods):
            self.transport.send(j, fr.encode_frame(
                fr.Frame(kind=fr.SHUTDOWN)))
        for r in self.runners:
            r.kill()
        for r in self.runners:
            r.join(timeout=30.0)
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.transport.close()
        if self.tmpdir is not None:
            shutil.rmtree(self.tmpdir, ignore_errors=True)


@register_driver("distributed")
class DistributedDriver(Driver):
    """Fusion pod + client pods behind the versioned wire protocol."""

    def __init__(self, staleness: int = 0, prefetch: int = 1):
        if staleness != 0:
            raise ValueError(
                f"{type(self).__name__} runs sync-quorum semantics; "
                f"staleness={staleness} only applies to the "
                f"async_pipelined driver")
        super().__init__(staleness=staleness, prefetch=prefetch)
        self.pod_startup_s: Optional[float] = None

    # -- pod lifecycle ----------------------------------------------------

    def _start_pods(self, engine: RoundEngine, dcfg: DistConfig) -> _Runtime:
        t0 = time.perf_counter()
        if dcfg.transport == "loopback":
            transport = LoopbackTransport(dcfg.n_pods)
            rt = _Runtime(transport, dcfg.n_pods)
            # one process, one device: serialise the pods' training
            lock = threading.Lock()
            rt.runners = [
                ClientPodRunner(engine, j, transport.endpoint(j),
                                heartbeat_s=dcfg.heartbeat_s,
                                lock=lock).start()
                for j in range(dcfg.n_pods)]
            rt.startup_s = time.perf_counter() - t0
            return rt
        if dcfg.spec_json is None:
            raise ValueError(
                "dist.transport='tcp' needs dist.spec_json (run through "
                "the Experiment / spec API, so that client pods can "
                "rebuild the engine)")
        transport = TCPTransport()
        rt = _Runtime(transport, dcfg.n_pods)
        try:
            rt.tmpdir = tempfile.mkdtemp(prefix="repro_torch_dist_")
            spec_path = os.path.join(rt.tmpdir, "spec.json")
            with open(spec_path, "w") as f:
                f.write(dcfg.spec_json)
            src_root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env = dict(os.environ)
            env["PYTHONPATH"] = src_root + (
                os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
                else "")
            for j in range(dcfg.n_pods):
                rt.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.dist.pods",
                     "--spec", spec_path, "--pod", str(j),
                     "--host", transport.host,
                     "--port", str(transport.port),
                     "--heartbeat-s", str(dcfg.heartbeat_s),
                     "--device", engine.device.type],
                    env=env))
            transport.accept(dcfg.n_pods, timeout=_ACCEPT_TIMEOUT_S)
        except BaseException:
            for p in rt.procs:
                p.kill()
                p.wait()
            rt.close()
            raise
        now = time.monotonic()
        for j in range(dcfg.n_pods):
            rt.last_seen[j] = now
        rt.startup_s = time.perf_counter() - t0
        return rt

    # -- the loop ---------------------------------------------------------

    def run(self, engine: RoundEngine, *, log_fn=None, init_globals=None,
            init_state=_UNSET, start_round=1, init_logs=None,
            round_end_hook=None):
        dcfg: DistConfig = engine.cfg.dist
        dcfg.validate()
        codec = fr.get_codec(dcfg.wire_codec)
        faults = engine.cfg.faults
        wire_fm = None
        if faults.transport_enabled:
            from repro_torch.population.faults import FaultModel
            wire_fm = FaultModel(faults, engine.cfg.seed, dcfg.n_pods)
        wlog = fr.WireLog(dcfg.wire_log) if dcfg.wire_log else None

        globals_, state, logs, rng = self._setup(
            engine, init_globals, init_state, init_logs, start_round)
        n = engine.n_proto
        rounds_to_target = None
        rt = self._start_pods(engine, dcfg)
        self.pod_startup_s = rt.startup_s

        def timed(phases, name, fn, *args):
            return self._timed(engine, phases, name, fn, *args)

        def aggregate(t, groups, state, prev):
            globals_, state, infos = engine.aggregate(t, groups, state)
            globals_, rolled = engine.guard_globals(globals_, prev)
            return globals_, state, infos, rolled

        try:
            for t in range(start_round, engine.cfg.rounds + 1):
                phases: Dict[str, float] = {}
                active = timed(phases, "sample_cohort",
                               engine.sample_cohort, rng)
                received, st = timed(
                    phases, "wire_collect", self._collect, engine, t,
                    active, globals_, codec, wire_fm, dcfg, wlog, rt,
                    t == start_round)
                groups, ids_by_proto = timed(
                    phases, "assemble", self._assemble, engine, active,
                    received, globals_)
                fstats = timed(phases, "fault_pipeline",
                               engine.fault_pipeline, t, groups,
                               ids_by_proto)
                # wire losses count against the quorum as screened-out
                # uploads do: dispatched is the whole cohort
                qstats = fstats
                if qstats is not None:
                    qstats["dispatched"] = len(active)
                elif st["wire_lost"]:
                    qstats = {"dispatched": len(active),
                              "kept": len(active) - st["wire_lost"]}
                fuse = engine.quorum_met(qstats)
                if fuse:
                    globals_, state, infos, rolled = timed(
                        phases, "aggregate", aggregate, t, groups, state,
                        list(globals_))
                else:  # quorum shortfall: carry the globals, skip fusion
                    infos, rolled = [{} for _ in range(n)], [False] * n
                round_logs = timed(phases, "evaluate_round",
                                   engine.evaluate_round, t, globals_,
                                   groups, infos)
                self.phase_seconds.append(phases)
                self._drain(rt)
                n_alive = sum(1 for j in range(dcfg.n_pods)
                              if self._alive(rt, j, dcfg))
                for p, log in enumerate(round_logs):
                    if fstats is not None:
                        log.n_corrupted = fstats["corrupted"]
                        log.n_quarantined = fstats["quarantined"]
                        log.n_retries = fstats["retries"]
                        log.rolled_back = bool(log.rolled_back or rolled[p])
                    if qstats is not None:
                        log.fused = fuse
                    log.wire_bytes_up = st["bytes_up"]
                    log.wire_bytes_down = st["bytes_down"]
                    log.n_wire_retries = st["wire_retries"]
                    log.n_crc_failures = st["crc_failures"]
                    log.n_deadline_misses = st["deadline_misses"]
                    log.n_wire_lost = st["wire_lost"]
                    log.n_pods_alive = n_alive
                reached, stop = self._emit_round(engine, round_logs, logs,
                                                 log_fn)
                if reached:
                    rounds_to_target = t
                if round_end_hook is not None:
                    round_end_hook(t, globals_, state, logs,
                                   rounds_to_target)
                if rounds_to_target is not None or stop:
                    break
        finally:
            rt.close()

        return self._results(engine, logs, globals_, rounds_to_target)

    # -- liveness ---------------------------------------------------------

    @staticmethod
    def _drain(rt: _Runtime) -> None:
        """Consume the frames queued since the last collection: the pods'
        heartbeats (and late uploads of an earlier round, which the
        collection would ignore) refresh their liveness.  Judged on
        ``last_seen`` alone, every pod would look dead after a fusion
        longer than ``3 * heartbeat_s``."""
        while True:
            got = rt.transport.recv(0.0)
            if got is None:
                return
            rt.last_seen[got[0]] = time.monotonic()

    @staticmethod
    def _alive(rt: _Runtime, pod: int, dcfg: DistConfig) -> bool:
        return (time.monotonic() - rt.last_seen[pod]
                <= max(3.0 * dcfg.heartbeat_s, 0.05))

    # -- wire collection --------------------------------------------------

    def _collect(self, engine: RoundEngine, t: int, active, globals_,
                 codec, wire_fm, dcfg: DistConfig, wlog, rt: _Runtime,
                 replay: bool):
        """Dispatch TRAIN frames and gather UPLOADs for round ``t``.
        Returns ``(received, stats)``: client id -> decoded leaf list (the
        JAX package's leaf order), and the round's wire telemetry, which
        the ``wire_collect`` span carries (with ``rerouted``, the clients
        dispatched to a pod other than their home)."""
        faults = engine.cfg.faults
        proto = engine.client_proto
        active_set = {int(k) for k in active}
        tmpl = [[l.detach().cpu().numpy()
                 for l in tree_leaves_jax(globals_[p])]
                for p in range(engine.n_proto)]
        received: Dict[int, List[np.ndarray]] = {}
        st = {k: 0 for k in (
            "bytes_up", "bytes_down", "crc_failures", "deadline_misses",
            "wire_retries", "wire_lost", "frames", "replayed",
            "dispatches", "rerouted")}

        def store_upload(frame: fr.Frame) -> int:
            """Decode an accepted UPLOAD into ``received``; returns the
            number of newly covered clients."""
            c = fr.codec_by_id(frame.codec_id)
            blobs = fr.unpack_blobs(frame.payload, len(frame.client_ids))
            fresh = 0
            for k, blob in zip(frame.client_ids, blobs):
                k = int(k)
                if k in active_set and k not in received:
                    received[k] = c.decode(blob, tmpl[proto[k]])
                    fresh += 1
            return fresh

        # -- fusion-pod restart: replay this round's logged uploads ------
        if replay and wlog is not None:
            with _trace.span("wire_replay", round=int(t)) as sp:
                for frame in wlog.replay(t):
                    try:
                        st["replayed"] += store_upload(frame)
                    except fr.FrameError:
                        continue
                sp.annotate(replayed=st["replayed"])
            REGISTRY.counter("dist.wirelog_replayed").add(st["replayed"])

        # -- downlink: every prototype's globals, always fp32 (exact) ----
        fp32 = fr.get_codec("fp32")
        down_payload = fr.pack_blobs(
            [fp32.encode(tmpl[p]) for p in range(engine.n_proto)])

        reqs: Dict[int, dict] = {}
        next_rid = [0]
        dark: set = set()  # pods disconnect-faulted for this round

        def alive(j: int) -> bool:
            return j not in dark and self._alive(rt, j, dcfg)

        def pick_pod(home: int) -> Optional[int]:
            for j in [home] + [j for j in range(dcfg.n_pods) if j != home]:
                if alive(j):
                    return j
            return None

        def dispatch(ids: List[int], pod: int, attempt: int) -> None:
            rid = next_rid[0]
            next_rid[0] += 1
            data = fr.encode_frame(fr.Frame(
                kind=fr.TRAIN, round=t, wave=t, client_ids=ids,
                codec_id=codec.codec_id,
                meta={"req": rid, "attempt": attempt, "codec": codec.name},
                payload=down_payload))
            with _trace.span("wire_dispatch", round=int(t)) as sp:
                sp.annotate(pod=pod, attempt=attempt, n_clients=len(ids),
                            nbytes=len(data))
                rt.transport.send(pod, data)
            st["bytes_down"] += len(data)
            st["dispatches"] += 1
            # clients trained away from their home pod (a dead pod's)
            st["rerouted"] += sum(1 for k in ids if k % dcfg.n_pods != pod)
            deadline = time.monotonic() + (
                dcfg.upload_deadline_s * (faults.backoff ** attempt))
            reqs[rid] = {"pod": pod, "ids": list(ids), "attempt": attempt,
                         "deadline": deadline}

        def give_up(missing: List[int], why: str) -> None:
            st["wire_lost"] += len(missing)
            if why == "crc":
                # CRC-failure escalation: retries exhausted on a corrupting
                # link -> quarantine the clients' uploads
                engine.sampler.penalize([int(k) for k in missing], 0.5)

        def retry(rid: int, why: str) -> None:
            r = reqs.pop(rid, None)
            if r is None:
                return
            missing = [k for k in r["ids"] if k not in received]
            if not missing:
                return
            attempt = r["attempt"] + 1
            if attempt > faults.retries:
                give_up(missing, why)
                return
            # the request's pod while it still heartbeats, else the next
            # live one (re-routing never changes the trajectory)
            target = pick_pod(r["pod"])
            if target is None:
                give_up(missing, why)
                return
            st["wire_retries"] += 1
            REGISTRY.counter("dist.wire_retries").add(1)
            dispatch(missing, target, attempt)

        def oldest_req_of(pod: int) -> Optional[int]:
            rids = [rid for rid, r in reqs.items() if r["pod"] == pod]
            return min(rids) if rids else None

        with _trace.span("wire_collect", round=int(t)) as sp:
            self._drain(rt)
            for home, ids in enumerate(shard_clients(
                    [k for k in active_set if k not in received],
                    dcfg.n_pods)):
                if not ids:
                    continue
                target = pick_pod(home)
                if target is None:
                    give_up(ids, "dead")
                    continue
                dispatch(sorted(ids), target, 0)

            # chaos hook: crash a pod right after this round's dispatch;
            # the killed pod trains but never uploads, and recovery must
            # flow through the deadline and heartbeat liveness
            if (rt.runners and dcfg.kill_pod is not None
                    and t == dcfg.kill_after_round
                    and 0 <= dcfg.kill_pod < len(rt.runners)):
                rt.runners[dcfg.kill_pod].kill()

            delayed: list = []  # (release_time, seq, pod, data)
            seq = 0
            while reqs:
                now = time.monotonic()
                msg = None
                if delayed and delayed[0][0] <= now:
                    _, _, pod, data = heapq.heappop(delayed)
                    msg, preprocessed = (pod, data), True
                else:
                    got = rt.transport.recv(0.05)
                    if got is not None:
                        msg, preprocessed = got, False
                if msg is not None:
                    pod, data = msg
                    rt.last_seen[pod] = time.monotonic()
                    st["frames"] += 1
                    is_upload = (len(data) > _KIND_OFF
                                 and data[_KIND_OFF] == fr.UPLOAD)
                    if is_upload and wire_fm is not None and not preprocessed:
                        req = oldest_req_of(pod)
                        attempt = reqs[req]["attempt"] if req is not None \
                            else 0
                        fault = wire_fm.transport_fault(t, pod, attempt)
                        if fault == "disconnect":
                            dark.add(pod)
                            continue  # frame lost; the deadline re-routes
                        if fault == "drop":
                            continue
                        if fault == "corrupt":
                            data = wire_fm.corrupt_frame(t, pod, attempt,
                                                         data)
                        elif fault == "delay":
                            heapq.heappush(
                                delayed,
                                (now + faults.transport_delay_s, seq, pod,
                                 data))
                            seq += 1
                            continue
                    try:
                        frame = fr.decode_frame(
                            data, verify_crc=dcfg.verify_crc)
                    except fr.CRCError:
                        st["crc_failures"] += 1
                        REGISTRY.counter("dist.crc_failures").add(1)
                        rid = oldest_req_of(pod)
                        if rid is not None:
                            retry(rid, "crc")
                        continue
                    except fr.FrameError:
                        rid = oldest_req_of(pod)
                        if rid is not None:
                            retry(rid, "crc")
                        continue
                    if frame.kind == fr.HEARTBEAT:
                        continue
                    if frame.kind != fr.UPLOAD or frame.round != t:
                        continue  # stale round / unexpected kind
                    try:
                        store_upload(frame)
                    except (fr.FrameError, ValueError):
                        # a structurally broken payload (possible with
                        # verify_crc off): handled as a checksum failure
                        st["crc_failures"] += 1
                        rid = oldest_req_of(pod)
                        if rid is not None:
                            retry(rid, "crc")
                        continue
                    st["bytes_up"] += len(data)
                    if wlog is not None:
                        wlog.append(data)
                    for rid in list(reqs):
                        if all(k in received for k in reqs[rid]["ids"]):
                            del reqs[rid]
                # deadline sweep
                now = time.monotonic()
                for rid in [r for r in list(reqs)
                            if reqs[r]["deadline"] <= now]:
                    st["deadline_misses"] += 1
                    REGISTRY.counter("dist.deadline_misses").add(1)
                    retry(rid, "deadline")
                # liveness sweep: a request whose pod fell silent (or went
                # dark) re-routes now, not at its deadline
                for rid in [r for r in list(reqs)
                            if not alive(reqs[r]["pod"])]:
                    retry(rid, "dead")
            sp.annotate(**st)

        REGISTRY.counter("dist.train_dispatches").add(st["dispatches"])
        REGISTRY.counter("dist.bytes_up").add(st["bytes_up"])
        REGISTRY.counter("dist.bytes_down").add(st["bytes_down"])
        REGISTRY.gauge("dist.pods_alive").set(sum(
            1 for j in range(dcfg.n_pods) if self._alive(rt, j, dcfg)))
        return received, st

    # -- stack assembly ---------------------------------------------------

    @staticmethod
    def _assemble(engine: RoundEngine, active, received, globals_):
        """Received leaf lists -> per-prototype GroupRounds in the cohort's
        order: the inputs ``sync``'s ``train_clients`` gives aggregation
        for the surviving clients."""
        proto = engine.client_proto
        by_proto: List[List[int]] = [[] for _ in range(engine.n_proto)]
        for k in active:
            if int(k) in received:
                by_proto[proto[int(k)]].append(int(k))
        groups, ids_by_proto = [], []
        for p in range(engine.n_proto):
            ks = by_proto[p]
            if not ks:
                groups.append(GroupRound(engine.nets[p], globals_[p], None,
                                         np.zeros(0)))
                ids_by_proto.append(None)
                continue
            n_leaves = len(received[ks[0]])
            stack = tree_unflatten_jax(globals_[p], [
                torch.from_numpy(np.stack([received[k][li] for k in ks]))
                .to(engine.device) for li in range(n_leaves)])
            weights = np.array([float(len(engine.parts[k])) for k in ks])
            groups.append(GroupRound(engine.nets[p], globals_[p], stack,
                                     weights))
            ids_by_proto.append(ks)
        return groups, ids_by_proto
