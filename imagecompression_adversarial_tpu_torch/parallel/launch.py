"""Start an SPMD program: one process per rank over ``torch.distributed``.

``run_spmd(fn, world_size)`` spawns the ranks, rendezvouses them through a
``FileStore`` in a temporary directory (no TCP port, so concurrent runs
cannot collide), places rank ``r`` on ``cuda:{r % device_count}``, calls
``fn(*args)`` in each and returns each rank's (picklable) result, in rank
order.  It raises if any rank raises, exits or outlives ``timeout``; it
never moves a rank to the CPU when ``cuda`` was asked for.

Backends: NCCL where each rank has a GPU of its own; gloo where ranks share
one (NCCL refuses two ranks on one device), or on the CPU.  The parallel
layer uses ``all_reduce``, ``all_gather_into_tensor`` and ``broadcast``,
which gloo also runs on CUDA tensors; ``collective_report``, run in the
ranks, says which collectives a backend runs.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from ..ops import shard


def choose_backend(world_size: int, device_type: str = "cuda",
                   backend: Optional[str] = None) -> str:
    """The backend for ``world_size`` ranks on ``device_type``: ``backend``
    if given and possible, else NCCL when every rank gets its own GPU and
    gloo otherwise."""
    if device_type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} does not run on the CPU; use gloo")
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r} not in ('cuda', 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' but torch.cuda.is_available() is False")
    shared = world_size > torch.cuda.device_count()
    if backend is None:
        return "gloo" if shared else "nccl"
    if backend == "nccl" and shared:
        raise ValueError(f"NCCL needs a GPU a rank: {world_size} ranks, "
                         f"{torch.cuda.device_count()} GPUs; use gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} not in ('nccl', 'gloo')")
    return backend


def _rank_main(rank: int, fn: Callable, args: Sequence, world_size: int, backend: str,
               device_type: str, tmp: str, timeout: float) -> None:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device_type='cuda' but no CUDA device is visible")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    out = os.path.join(tmp, f"rank{rank}.pkl")
    with open(out + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".part", out)


def run_spmd(fn: Callable, world_size: int, backend: Optional[str] = None,
             device_type: str = "cuda", args: Sequence = (),
             timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` spawned ranks; return their
    results in rank order.  ``fn`` must be importable by name (spawn)."""
    backend = choose_backend(world_size, device_type, backend)
    with tempfile.TemporaryDirectory(prefix="icat_spmd_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), world_size, backend, device_type, tmp, timeout),
            nprocs=world_size, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        failure = None
        try:
            while not ctx.join(timeout=max(0.1, min(1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"run_spmd: {world_size} ranks of {fn.__name__} did not "
                                       f"finish within {timeout:.0f} s")
        except ProcessException as e:
            failure = e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failure is not None:
            # every rank that raised, not only the first one seen to exit
            errors = []
            for r in range(world_size):
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"-- rank {r}:\n{f.read()}")
            raise RuntimeError(f"run_spmd: {fn.__name__} failed ({failure.__class__.__name__}: "
                               f"{str(failure).strip().splitlines()[0]})\n"
                               + "\n".join(errors)) from failure
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def collective_report(device_type: str) -> Dict[str, str]:
    """Each collective on a small tensor of this rank's device: ``'ok'``
    when it ran and gave the right values, else the error."""
    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else "cpu"
    want_sum = float(sum(range(1, world + 1)))

    def all_reduce():
        t = torch.full((4,), rank + 1.0, device=device)
        dist.all_reduce(t)
        return bool((t == want_sum).all())

    def broadcast():
        t = torch.full((4,), rank + 1.0, device=device)
        dist.broadcast(t, src=0)
        return bool((t == 1.0).all())

    def all_gather():
        out = [torch.zeros(4, device=device) for _ in range(world)]
        dist.all_gather(out, torch.full((4,), rank + 1.0, device=device))
        return all(bool((o == i + 1.0).all()) for i, o in enumerate(out))

    def all_gather_into_tensor():
        out = shard.all_gather(torch.full((4,), rank + 1.0, device=device), None, world)
        return bool((out[:, 0] == torch.arange(1.0, world + 1, device=device)).all())

    def reduce_scatter_tensor():
        out = torch.zeros(4, device=device)
        dist.reduce_scatter_tensor(out, torch.full((world * 4,), rank + 1.0, device=device))
        return bool((out == want_sum).all())

    report = {}
    for name, op in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather), ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor)):
        try:
            report[name] = "ok" if op() else "wrong values"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            report[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        if device_type == "cuda":
            torch.cuda.synchronize()
    return report
