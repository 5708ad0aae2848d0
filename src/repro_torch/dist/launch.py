"""One process per rank: joining a process group, or spawning one.

The sharded solve (``gmres(..., shard=P)``) runs on a live
``torch.distributed`` group of P ranks, one process per GPU: NCCL on the
card, gloo on the CPU.  :func:`init_rank` joins this process to a group,
on ``cuda:<local rank>`` unless the CPU is asked for.  :func:`spawn` starts
P ranks of a function on this host with ``torch.multiprocessing`` and a
``file://`` rendezvous in a fresh directory (so that concurrent worlds
never share one), waits for all of them under a deadline, and returns rank
0's result; a rank that fails or a world that outlives the deadline
raises, and every process it started is stopped.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import rank_device

__all__ = ["init_rank", "spawn"]

#: seconds the ranks get to exit once all of them have reported
TEARDOWN_S = 30.0


def init_rank(rank: int | None = None, world_size: int | None = None,
              init_method: str = "env://", device="cuda",
              timeout_s: float = 120.0) -> torch.device:
    """Join this process to the default group as ``rank`` of
    ``world_size`` and return its device.  Without a rank, the group is
    the one torchrun describes: ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
    from the environment, ``init_method="env://"``.  On CUDA the group is
    NCCL, initialized eagerly on the rank's card (``device_id``), so that a
    CUDA graph can capture its collectives; on the CPU it is gloo."""
    local_rank = rank
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, local_rank=local_rank)
    kw = dict(init_method=init_method, world_size=world_size, rank=rank,
              timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return dev


def _rank_main(rank, world_size, init_method, device, timeout_s, fn, args,
               results):
    try:
        torch.set_num_threads(1)
        dev = init_rank(rank, world_size, init_method, device, timeout_s)
        out = fn(rank, dev, *args)
        results.put((rank, True, out if rank == 0 else None))
    except Exception:                            # reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, device="cuda",
          timeout_s: float | None = 120.0):
    """Run ``fn(rank, device, *args)`` on ``world_size`` new processes, one
    rank each, and return rank 0's result.

    ``fn`` and ``args`` must be picklable (``fn`` a module-level function).
    Raises ``RuntimeError`` with the failing rank's traceback, or
    ``TimeoutError`` when the world has not finished within ``timeout_s``
    seconds (``None``: no deadline); in both cases every rank still running
    is terminated, as is a rank still tearing down :data:`TEARDOWN_S`
    seconds after the last one reported.  The group's own collectives time
    out after ``timeout_s`` too (two minutes without a deadline).
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rdv = tempfile.mkdtemp(prefix="repro_torch_rdv_")
    init_method = "file://" + os.path.join(rdv, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, init_method, device,
                               timeout_s or 120.0, fn, args, results),
                         daemon=True)
             for r in range(world_size)]
    deadline = time.monotonic() + (timeout_s or float("inf"))
    try:
        for p in procs:
            p.start()
        out, done = None, 0
        while done < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size} ranks did not finish within {timeout_s} s")
            try:
                rank, ok, res = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"a rank died with exit code {dead[0]} before "
                        "reporting") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            if rank == 0:
                out = res
            done += 1
        # every rank has reported: give their teardown a short grace,
        # then stop what is left (the finally below)
        grace = time.monotonic() + TEARDOWN_S
        for p in procs:
            p.join(max(grace - time.monotonic(), 0.1))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
        shutil.rmtree(rdv, ignore_errors=True)
