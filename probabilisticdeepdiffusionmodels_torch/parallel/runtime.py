"""Multi-process runtime wiring over ``torch.distributed``.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/parallel/runtime.py``.
A data-parallel run is one process per rank, each on its own device (or
several on the CPU).  Two ways start one:

  * a launch declared in the environment (a multi-host job, ``torchrun``):
    :func:`runtime_from_env` reads the ``PDDM_*`` variables exactly as JAX
    does, and where JAX reads ``JAX_*`` the ones torch's launcher sets
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR:MASTER_PORT``), and
    :func:`initialize_runtime` joins the process group (``nccl`` for the
    card, ``gloo`` for the CPU).  As in JAX, each process then loads its
    disjoint shard of the data (``DataLoader(shard_id=, num_shards=)``);
  * :func:`spawn`, the CLIs' ``devices=N`` (Lightning's DDP spawn, which the
    reference's ``pl.Trainer(gpus=N)`` runs): N fresh processes on one
    machine (the ``spawn`` start method, since CUDA refuses ``fork``), a
    free port on localhost, rank r on ``cuda:r`` (or all on one given
    device, or on the CPU), the group joined before ``fn`` runs.

``RuntimeInfo.is_main`` gates what a run writes once (metric logs, media,
the config snapshot, checkpoints).  On one process all of this is a no-op:
no variables, no group, process 0 of 1.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import time
import traceback
from typing import Any, Callable, Mapping, Optional, Sequence

import torch

__all__ = ["RuntimeInfo", "initialize_runtime", "runtime_from_env", "spawn", "free_port",
           "backend_for"]


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    """Identity of this process within a (possibly 1-process) launch."""

    process_index: int = 0
    process_count: int = 1
    coordinator: Optional[str] = None

    @property
    def is_main(self) -> bool:
        return self.process_index == 0

    @property
    def is_distributed(self) -> bool:
        return self.process_count > 1


def runtime_from_env(env: Optional[Mapping[str, str]] = None) -> RuntimeInfo:
    """Parse the launch topology from env vars without side effects.

    Recognized (PDDM_* wins over torch's when both are set):
      PDDM_NUM_PROCESSES / WORLD_SIZE               -- processes in the launch
      PDDM_PROCESS_ID    / RANK                     -- this process's index
      PDDM_COORDINATOR   / MASTER_ADDR:MASTER_PORT  -- host:port of process 0
    """
    env = os.environ if env is None else env
    count = env.get("PDDM_NUM_PROCESSES") or env.get("WORLD_SIZE")
    if not count or int(count) <= 1:
        return RuntimeInfo()
    coordinator = env.get("PDDM_COORDINATOR")
    if not coordinator and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if not coordinator:
        raise ValueError("multi-process launch declared (NUM_PROCESSES>1) but no coordinator "
                         "address set (PDDM_COORDINATOR / MASTER_ADDR and MASTER_PORT)")
    index = env.get("PDDM_PROCESS_ID") or env.get("RANK")
    if index is None:
        raise ValueError("multi-process launch declared but no process id set "
                         "(PDDM_PROCESS_ID / RANK)")
    return RuntimeInfo(process_index=int(index), process_count=int(count),
                       coordinator=coordinator)


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_runtime(env: Optional[Mapping[str, str]] = None, device=None,
                       _distributed_initialize=None) -> RuntimeInfo:
    """Join the process group if this is a multi-process launch; return this
    process's :class:`RuntimeInfo` either way.

    ``device`` (None: cuda) picks the backend.  ``_distributed_initialize``
    is injectable for tests; it defaults to
    ``torch.distributed.init_process_group``.
    """
    info = runtime_from_env(env)
    if info.is_distributed:
        if _distributed_initialize is None:
            import torch.distributed as dist

            _distributed_initialize = dist.init_process_group
        from ..models import resolve_device

        _distributed_initialize(backend=backend_for(resolve_device(device)),
                                init_method=f"tcp://{info.coordinator}",
                                world_size=info.process_count, rank=info.process_index)
    return info


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str, device: str, fn: Callable,
               args: Sequence[Any], results) -> None:
    """One spawned rank: its device, the group, ``fn(rank, device, *args)``,
    its result (rank 0) or its traceback sent to the parent."""
    import torch.distributed as dist

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank if dev.index is None else dev.index)
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank, **kw)
        out = fn(rank, dev, *args)
        # by value: a tensor sent as a shared-memory handle dies with its rank
        results.put((rank, True, pickle.dumps(out if rank == 0 else None)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), *, device=None,
          backend: Optional[str] = None, join_timeout: Optional[float] = None) -> Any:
    """Run ``fn(rank, device, *args)`` in ``nprocs`` new processes joined in
    one process group and return rank 0's result (picklable).

    ``device`` (None: cuda): ``cuda`` puts rank r on ``cuda:r`` (more ranks
    than cards raise before anything starts), ``cuda:i`` puts every rank on
    card i (with ``backend="gloo"``: NCCL refuses two ranks on one card),
    ``cpu`` runs them all on the CPU.  ``backend`` defaults to
    :func:`backend_for` the device.  A rank that fails, or a run past
    ``join_timeout`` seconds, ends every rank and raises with the first
    failure's traceback.
    """
    import torch.multiprocessing as mp

    from ..models import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and nprocs > torch.cuda.device_count():
        raise RuntimeError(f"{nprocs} ranks need {nprocs} CUDA devices; only "
                           f"{torch.cuda.device_count()} available")
    backend = backend or backend_for(dev)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, port, backend, str(dev), fn, tuple(args), results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    got, failure = {}, None
    try:
        while len(got) < nprocs and failure is None:
            while not results.empty():
                rank, ok, value = results.get()
                got[rank] = pickle.loads(value) if ok else value
                if not ok:
                    failure = f"rank {rank} failed:\n{value}"
            dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                    and r not in got]
            if dead and failure is None and results.empty():
                failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
            if deadline is not None and time.monotonic() > deadline:
                failure = failure or f"ranks did not finish within {join_timeout} s"
            if len(got) < nprocs and failure is None:
                time.sleep(0.05)
    finally:
        for p in procs:
            p.join(None if failure is None else 10)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return got[0]
