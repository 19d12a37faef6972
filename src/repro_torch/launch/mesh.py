"""Device meshes over a ``torch.distributed`` world (the JAX package's
``launch/mesh.py`` in PyTorch).

JAX runs one controller over every device; PyTorch runs one process per
rank.  A mesh here is a ``torch.distributed.device_mesh.DeviceMesh``
over the current world with JAX's axis names, ``("data",)``,
``("data", "model")`` or ``("pod", "data", "model")``; every factory
defaults to every rank, as JAX's default to every device, and raises when
the world does not match its shape.  Axis sizes are read by name
(``common/sharding.axis_size``).

The world comes from one of two launchers:

* :func:`launch_ranks` spawns ``n`` ranks of ``fn``, rendezvousing through
  a ``file://`` store in a fresh temporary directory (no TCP port, so
  several launches can run side by side), joins them under a timeout and
  raises when a rank raises or hangs, after stopping every other rank;
* under ``torchrun`` :func:`init_world` reads ``RANK`` / ``WORLD_SIZE`` /
  ``LOCAL_RANK`` and the launcher's store.

The backend is chosen here, explicitly, and printed by rank 0:

* ``nccl`` when every rank has a card of its own: the ranks of each node
  (``LOCAL_WORLD_SIZE`` under ``torchrun``) number no more than its cards,
  and rank ``r`` takes card ``LOCAL_RANK``; a failed NCCL initialisation
  raises;
* ``gloo`` on the CPU;
* ``gloo`` when a node's ranks outnumber its visible cards: they share the
  cards round-robin and compute on them, and the collectives stage CUDA
  tensors through host memory (``common/sharding.py``).

No rank moves to the CPU while a card is present, and every process group
carries a timeout, so a rank that stops answering fails the launch.

The v5e constants of the JAX module are TPU figures and are not carried
over; the port's dry run (``launch/dryrun.py``) has the H100's.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

DEFAULT_TIMEOUT_S = 600.0

# this process's place in the world: set by init_world
_WORLD = {"device": None, "backend": None}


def choose_backend(device, local_world_size: int,
                   local_rank: int) -> Tuple[str, torch.device]:
    """``(backend, this rank's device)`` on ``device`` (``"cuda"`` or
    ``"cpu"``) for a rank of a world that puts ``local_world_size`` ranks
    on this node: the ranks of one node compete for its cards, whatever
    the size of the whole world."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo", torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the card unless the caller passes device='cpu'")
    if local_world_size <= cards:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % cards)


def init_world(device="cuda", *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` (from
    ``torchrun``'s environment when not given) and return this rank's
    device, which also becomes the current CUDA device."""
    import torch.distributed as dist
    # launch_ranks and one_rank_world put the whole world on this node
    local_rank, local_world_size = rank, world_size
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              world_size))
        init_method = init_method or "env://"
    backend, dev = choose_backend(device, local_world_size, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s), **kw)
    _WORLD.update(device=dev, backend=backend)
    if rank == 0:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        how = ("one card per rank" if backend == "nccl" else
               f"{local_world_size} rank(s) of this node sharing its "
               f"{cards} card(s) round-robin, "
               f"collectives staged through host memory" if cards else
               "the CPU")
        print(f"mesh world: {world_size} rank(s), backend {backend} "
              f"({how})", flush=True)
    return dev


def close_world() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.update(device=None, backend=None)


@contextlib.contextmanager
def one_rank_world(device="cpu"):
    """A world of this process alone, for a run that asks for a mesh
    without a launcher; the world ends with the block."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as d:
        dev = init_world(device, rank=0, world_size=1,
                         init_method="file://" + os.path.join(d, "store"))
        try:
            yield dev
        finally:
            close_world()


def world_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def under_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def _rank_main(fn, rank: int, n: int, device, init_method: str,
               out_path: str, timeout_s: float, threads: Optional[int],
               args: tuple) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        init_world(device, rank=rank, world_size=n, init_method=init_method,
                   timeout_s=timeout_s)
        _save({"result": fn(*args)}, out_path)
    except BaseException:
        _save({"error": traceback.format_exc()}, out_path)
        raise SystemExit(1)
    finally:
        close_world()


def _save(obj, path: str) -> None:
    """Write ``obj`` whole or not at all (the parent may read it while
    this rank is still exiting)."""
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def launch_ranks(fn: Callable, n: int, device="cuda", *,
                 args: Sequence = (), timeout_s: float = DEFAULT_TIMEOUT_S,
                 threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` spawned ranks of one world on
    ``device`` and return each rank's result, in rank order.  ``fn`` must
    be importable by name (a module-level function).  A rank that raises,
    exits or outlives ``timeout_s`` ends every other rank, and this call
    raises with every failed rank's traceback.  ``threads`` sets each rank's
    torch host threads."""
    import multiprocessing.connection as mpc
    import torch.multiprocessing as mp
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as d:
        init = "file://" + os.path.join(d, "store")
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(n)]
        procs = []
        deadline = time.monotonic() + timeout_s
        failed: Optional[str] = None
        try:
            for r in range(n):
                p = ctx.Process(target=_rank_main, args=(
                    fn, r, n, device, init, outs[r], timeout_s, threads,
                    tuple(args)))
                p.start()
                procs.append(p)
            while failed is None:
                running = [p for p in procs if p.exitcode is None]
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    # every rank that failed or reported an error: the
                    # first to fail may still be exiting while its peers
                    # already failed in their collectives
                    failed = "\n".join(filter(None, (
                        _rank_error(r, procs[r], outs)
                        for r in range(n))))
                elif not running:
                    break
                elif time.monotonic() > deadline:
                    failed = (f"ranks {[procs.index(p) for p in running]} "
                              f"of {n} still running after {timeout_s} s")
                else:
                    mpc.wait([p.sentinel for p in running],
                             timeout=min(1.0, max(
                                 0.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join()
        if failed is not None:
            raise RuntimeError(f"launch_ranks({getattr(fn, '__name__', fn)}"
                               f", n={n}, device={device}): {failed}")
        return [torch.load(o, weights_only=False)["result"] for o in outs]


def _rank_error(r: int, proc, outs: List[str]) -> Optional[str]:
    """Rank ``r``'s failure (exit code, traceback), or None if it has
    not failed."""
    got = torch.load(outs[r], weights_only=False) \
        if os.path.exists(outs[r]) else {}
    if proc.exitcode in (None, 0) and "error" not in got:
        return None
    what = (f"rank {r} failed" if proc.exitcode is None
            else f"rank {r} exited with code {proc.exitcode}")
    if "error" in got:
        what += f":\n{got['error']}"
    return what


# ---------------------------------------------------------------------------
# mesh factories over the current world
# ---------------------------------------------------------------------------

def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs a torch.distributed "
            f"world: start the ranks with launch/mesh.launch_ranks or "
            f"torchrun")
    need, have = math.prod(shape), dist.get_world_size()
    if need != have:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {need} "
                         f"ranks; this world has {have}")
    backend = _WORLD["backend"] or dist.get_backend()
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                            mesh_dim_names=names)


def make_mesh(shape: Sequence[int], names: Sequence[str]):
    """A mesh of ``shape`` with axis ``names`` over the whole world (JAX's
    ``jax.make_mesh``)."""
    return _mesh(tuple(shape), tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(data: int = 2, model: int = 2):
    """A small ("data", "model") mesh of ``data * model`` ranks."""
    return _mesh((data, model), ("data", "model"))


def make_host_mesh(hosts: Optional[int] = None, model: int = 1):
    """("data", "model") mesh for the fed-round driver
    (``drivers/multihost.drive_fed_rounds``): each "data" slice holds
    whole client replicas (clients shard over it), "model" is the
    within-client tensor-parallel width.  Defaults to every rank on the
    data axis."""
    hosts = hosts or world_size() // model
    return _mesh((hosts, model), ("data", "model"))


def make_client_mesh(n: Optional[int] = None):
    """1-D ("data",) mesh for the federated round engine: the stacked
    client axis of ``make_batched_local_update`` shards over it, so K
    active clients train data-parallel.  Unbucketed homogeneous runs need
    K to be a multiple of ``n``; heterogeneous / bucketed runs pad their
    client capacities up to it.  Defaults to every rank."""
    return _mesh((n or world_size(),), ("data",))
