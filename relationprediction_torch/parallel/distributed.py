"""The multi-process runtime: one process a rank, over a TCP store
(``relationprediction_tpu/parallel/distributed.py``).

The JAX package's process drives several local devices; here every rank
is a process of its own. A process started with ``--local-devices L``
(``launch``) spawns L local ranks, rank ``process_id * L + local``, each
of which joins the group (``init_runtime``) at the coordinator's address.
The backend is NCCL on cards and gloo on the CPU (``--cpu``) or where
several ranks share one card.

Every rank runs the same seeded batch pipeline and keeps its own rows
(``mesh.shard_batch``), so no batch moves between hosts. The params are
replicated: every rank starts from the same seeded init and takes rank
0's (``mesh.replicate``). A rank that fails makes ``launch`` stop the
others and raise, and a CLI that launched it exit non-zero.
"""
from __future__ import annotations

import multiprocessing
import os
import socket
import traceback
from datetime import timedelta
from multiprocessing.connection import wait
from typing import Callable, Optional, Sequence

import torch.distributed as dist

from .mesh import EdgeMesh, local_world_size, make_mesh

TIMEOUT = timedelta(minutes=10)


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_runtime(coordinator_address: Optional[str] = None,
                 num_processes: int = 1, process_id: int = 0,
                 local_device_count: int = 1,
                 platform: Optional[str] = None, local_rank: int = 0,
                 backend: Optional[str] = None) -> None:
    """Join this rank to the default process group (``init_runtime``,
    ``:42-70``): rank ``process_id * local_device_count + local_rank`` of
    ``num_processes * local_device_count``, over a TCP store at
    ``coordinator_address`` ("host:port", which global rank 0 binds).
    ``backend``: by default gloo for ``platform`` "cpu", else NCCL; gloo
    on cards puts several ranks on one card. Sets ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` for ``make_mesh``."""
    if coordinator_address is None:
        raise ValueError("init_runtime needs the coordinator's host:port")
    world = num_processes * local_device_count
    rank = process_id * local_device_count + local_rank
    if not (0 <= process_id < num_processes
            and 0 <= local_rank < local_device_count):
        raise ValueError(f"process {process_id} of {num_processes}, local "
                         f"rank {local_rank} of {local_device_count}")
    os.environ["LOCAL_RANK"] = str(local_rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(local_device_count)
    if backend is None:
        backend = "gloo" if platform == "cpu" else "nccl"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}", world_size=world,
        rank=rank, timeout=TIMEOUT)


def is_coordinator() -> bool:
    """True on rank 0, or without a group: the process that logs,
    checkpoints and evaluates for the record."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_global_mesh(n_devices: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> EdgeMesh:
    """``make_mesh(devices)`` over every process's ranks, with the JAX
    package's two rules (``:84-100``) on ``n_devices``, the mesh's size:
    it must be a multiple of the ranks a process and take every process;
    then it must be the world size (a rank cannot leave the group it was
    started in)."""
    if n_devices is not None:
        per_proc = local_world_size()
        n_proc = dist.get_world_size() // per_proc
        if n_devices % per_proc:
            raise ValueError(f"n_devices={n_devices} must be a multiple of "
                             f"the ranks a process ({per_proc}): every "
                             f"process contributes whole devices")
        if n_devices < per_proc * n_proc:
            raise ValueError(f"n_devices={n_devices} excludes whole "
                             f"processes ({n_proc} processes x {per_proc} "
                             f"ranks); every process must contribute")
        if n_devices != dist.get_world_size():
            raise ValueError(f"a mesh of {n_devices} devices in a world of "
                             f"{dist.get_world_size()} ranks")
    return make_mesh(devices)


# ---------------------------------------------------------------------------
# Starting the ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, args, coordinator, num_processes, process_id, local,
               local_rank, backend, devices, n_devices, results) -> None:
    """One rank's process: join the group, build the mesh, run
    ``fn(mesh, *args)`` and send its result (or its traceback) back."""
    try:
        init_runtime(coordinator, num_processes, process_id, local,
                     local_rank=local_rank, backend=backend)
        mesh = make_global_mesh(n_devices, devices)
        results.send((True, fn(mesh, *args)))
    except BaseException:
        results.send((False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, local_ranks: int, args: tuple = (), *,
           cpu: bool = False, backend: Optional[str] = None,
           devices: Optional[Sequence] = None,
           n_devices: Optional[int] = None,
           coordinator: Optional[str] = None, num_processes: int = 1,
           process_id: int = 0, timeout: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``local_ranks`` spawned processes, the
    ranks ``process_id * local_ranks + local`` of a group of
    ``num_processes * local_ranks``; return their results in local rank
    order. ``fn`` (a module-level function) and its arguments and result
    must pickle.

    By default every rank runs on its card, ``cuda:<local rank>``, over
    NCCL (one rank a card). ``cpu``: every rank on the CPU, over gloo.
    ``backend`` and ``devices`` (every rank's device, in rank order)
    choose otherwise, e.g. gloo with ["cuda:0"] * 4 for ranks that share
    a card. ``n_devices``: the mesh's size, held to ``make_global_mesh``'s
    rules. ``coordinator``: "host:port" of the group's store; by default
    a free port on localhost (one process). A rank that raises or dies
    makes this stop the others and raise RuntimeError with its traceback,
    as does ``timeout`` (seconds in which no rank finished) running
    out."""
    if backend is None:
        backend = "gloo" if cpu else "nccl"
    if cpu:
        if backend != "gloo" or devices is not None:
            raise ValueError("a CPU launch runs every rank on the CPU over "
                             "gloo")
        devices = ["cpu"] * (num_processes * local_ranks)
    if coordinator is None:
        if num_processes != 1:
            raise ValueError("several processes need a coordinator address")
        coordinator = f"localhost:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    pipes, procs = [], []
    try:
        for local_rank in range(local_ranks):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_rank_main, name=f"rank-{local_rank}",
                args=(fn, args, coordinator, num_processes, process_id,
                      local_ranks, local_rank, backend, devices, n_devices,
                      send))
            proc.start()
            send.close()
            pipes.append(recv)
            procs.append(proc)
        results, failures = {}, []
        pending = dict(enumerate(pipes))
        while pending and not failures:
            ready = wait(list(pending.values()), timeout)
            if not ready:
                failures.append(f"no rank finished in {timeout} s")
            for local_rank in [r for r, c in pending.items() if c in ready]:
                ok, value = _receive(pending.pop(local_rank),
                                     procs[local_rank])
                results[local_rank] = value
                if not ok:
                    failures.append(f"rank {local_rank} failed: {value}")
        # The others' words, where a failure brought them down too.
        for local_rank, conn in pending.items():
            if conn.poll(1.0):
                ok, value = _receive(conn, procs[local_rank])
                if not ok:
                    failures.append(f"rank {local_rank} failed: {value}")
        for proc in procs:
            proc.join(5 if failures else None)
            if not failures and proc.exitcode != 0:
                failures.append(f"{proc.name} exited with code "
                                f"{proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in pipes:
            conn.close()
    if failures:
        raise RuntimeError("distributed launch: " + "\n".join(failures))
    return [results[r] for r in range(local_ranks)]


def _receive(conn, proc) -> tuple:
    """(ok, result or traceback) from a rank's pipe; a rank that died
    without a word fails with its exit code."""
    try:
        return conn.recv()
    except EOFError:
        proc.join(5)
        return False, f"exited with code {proc.exitcode}"
