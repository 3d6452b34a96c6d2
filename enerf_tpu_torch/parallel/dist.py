"""The process group of a data-parallel run; counterpart of
``enerf_tpu/parallel/mesh.py`` (``make_mesh``, ``local_batch_slice``).

One process a GPU, started by ``torch.distributed.run``::

    python -m torch.distributed.run --nproc_per_node N \\
        -m enerf_tpu_torch.train --distributed --cfg_file ...

which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous
(``MASTER_ADDR`` / ``MASTER_PORT``). NCCL carries the collectives between
CUDA devices, gloo those of CPU processes (the CPU tests spawn gloo ranks
with a ``file://`` rendezvous). Every collective of the port is an
``all_reduce``, which both backends take on CPU and CUDA tensors alike.

Outside a process group every query answers for one process: rank 0 of a
world of 1.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def init_distributed(device=None, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``device``: None or ``"cuda"`` puts each rank on ``cuda:{LOCAL_RANK}``
    (the rank without a launcher); ``"cuda:k"`` puts it on card k;
    ``"cpu"`` runs it on the CPU. ``backend`` defaults to NCCL on a card
    and gloo on the CPU; ``"gloo"`` on a card lets several ranks share it
    (NCCL refuses two ranks on one card). Without ``init_method`` the
    rank, the world size and the rendezvous come from
    ``torch.distributed.run``'s environment, and a missing ``RANK`` or
    ``WORLD_SIZE`` raises; with one (``file://...`` or ``tcp://...``),
    ``rank`` and ``world_size`` must be given. A failed init raises, and
    so does a card asked for where there is none."""
    if init_method is None:
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"--distributed needs the launcher's environment "
                f"({', '.join(missing)} unset): start it with python -m "
                "torch.distributed.run --nproc_per_node N -m "
                "enerf_tpu_torch.train --distributed ...")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    elif rank is None or world_size is None:
        raise ValueError("init_distributed: an init_method needs rank and "
                         "world_size")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device='cpu' for gloo ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


_this_rank = rank


def is_main() -> bool:
    """Rank 0 logs, records, validates and writes checkpoints."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing outside a process group)."""
    if world_size() > 1:
        dist.barrier()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place and return it (``t`` as it is in
    a world of 1)."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def unwrap(model: nn.Module) -> nn.Module:
    """The module inside a ``DistributedDataParallel`` wrapper, else
    ``model``: its ``state_dict`` keys carry no ``module.`` prefix."""
    return model.module if isinstance(
        model, nn.parallel.DistributedDataParallel) else model


def local_batch_slice(total: int, rank: Optional[int] = None,
                      world: Optional[int] = None) -> slice:
    """This rank's contiguous share of ``total`` items
    (``mesh.py:local_batch_slice``'s arithmetic): ``total // world`` items
    from ``rank * (total // world)``."""
    r = _this_rank() if rank is None else rank
    w = world_size() if world is None else world
    per = total // w
    return slice(r * per, (r + 1) * per)


def spawn_ranks(fn: Callable, world: int, args: Sequence = (),
                device="cpu", backend: Optional[str] = None,
                timeout: float = 600.0) -> List[Any]:
    """Run ``fn(device, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method) joined in one process group by a ``file://``
    rendezvous in a temporary directory; return each rank's result, by
    rank. ``fn`` must be importable (a module-level function) and its
    result picklable. Each rank runs one torch thread; ``device`` and
    ``backend`` are ``init_distributed``'s (gloo on the CPU by default).
    A rank that raises, dies or outlasts ``timeout`` seconds raises here
    with its traceback; the other ranks are then killed."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, init, device, backend,
                                   tuple(args), q))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                try:
                    r, ok, value = q.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank died (exit codes {dead})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"the ranks did not finish in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {r} raised:\n{value}")
                results[r] = value
        finally:
            for p in procs:
                p.join(timeout=30.0 if len(results) == world else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world)]


def _rank_main(fn, r, world, init, device, backend, args, q) -> None:
    torch.set_num_threads(1)
    try:
        dev = init_distributed(device, init_method=init, rank=r,
                               world_size=world, backend=backend)
        q.put((r, True, fn(dev, *args)))
    except Exception:
        q.put((r, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
