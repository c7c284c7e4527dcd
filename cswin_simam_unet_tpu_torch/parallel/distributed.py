"""The process group of a data-parallel run, and per-process data slicing.

Counterpart of ``cswin_simam_unet_tpu/parallel/distributed.py``.  JAX runs
one process per host and lets XLA emit the collectives; the port runs one
process per card (a rank) over ``torch.distributed``, and the step makes
its collectives itself (``parallel/mesh.py``, ``train/engine.py``).

A single process never needs :func:`initialize_runtime`: every helper
degrades to world size 1.  Several processes::

    python -m torch.distributed.run --nproc-per-node N -m cswin_simam_unet_tpu_torch.cli train ...

(``initialize_runtime()`` reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT``), or ``initialize_runtime("host0:8476", N, i)`` in
process i, or :func:`run_ranks`, which starts the ranks of one host itself.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits this long has lost a rank
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``,
    which ``torch.distributed.run`` sets), else its global rank."""
    value = _env_int("LOCAL_RANK")
    if value is not None:
        return value
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` where it names one (``cpu``,
    ``cuda:1``), else this rank's card, ``cuda:{local rank % device count}``
    (for None and ``cuda`` alike; ranks beyond the host's cards share them).
    No card is an error, as for every entry point of the port."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def _backend(device: torch.device, local_world: int) -> str:
    """NCCL for ranks on cards of their own, gloo on the CPU and where ranks
    share a card (NCCL refuses two ranks on one device)."""
    if device.type != "cuda":
        return "gloo"
    cards = torch.cuda.device_count()
    if local_world > cards:
        print(f"initialize_runtime: {local_world} ranks share {cards} CUDA device(s); "
              f"NCCL needs a device per rank, so the process group uses gloo", flush=True)
        return "gloo"
    return "nccl"


def initialize_runtime(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       device=None) -> tuple[int, int]:
    """Join the process group of a data-parallel run; a no-op for a single
    process.  Returns (rank, world size).

    Explicit arguments work as JAX's do: ``coordinator_address``
    (``host:port``, or a ``tcp://`` or ``file://`` URL) with
    ``num_processes`` and ``process_id``.  Without them the variables that
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``) decide.  ``device`` is the device this
    rank computes on (:func:`rank_device` by default): the backend is NCCL
    on CUDA, gloo on the CPU and where ranks share a card, which is said
    when it is chosen."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if world is None or world <= 1:
        return 0, 1
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None:
        raise ValueError(f"a run of {world} processes needs process_id (or RANK)")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    backend = _backend(rank_device(device), local_world)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    return rank, world


def process_local_indices(indices: Sequence[int], global_batch: int,
                          process: Optional[int] = None,
                          count: Optional[int] = None) -> np.ndarray:
    """This process's contiguous slice of every global batch of a global
    index order, JAX's semantics exactly: every process walks the same order
    and takes rows [p * b, (p + 1) * b) of each batch of ``global_batch``
    (b = global_batch / count); a ragged last batch is kept only when it
    still splits evenly over the processes, else dropped on every one.
    ``process`` / ``count`` default to this rank and the world size."""
    indices = np.asarray(indices)
    initialized = dist.is_initialized()
    p = process if process is not None else (dist.get_rank() if initialized else 0)
    n = count if count is not None else (dist.get_world_size() if initialized else 1)
    if n == 1:
        return indices
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    out = []
    for start in range(0, len(indices), global_batch):
        chunk = indices[start:start + global_batch]
        b = len(chunk)
        if b % n:  # a ragged tail that cannot split evenly: dropped everywhere
            break
        out.append(chunk[p * (b // n):(p + 1) * (b // n)])
    return np.concatenate(out) if out else indices[:0]


def global_batch_from_local(local_batch, mesh) -> torch.Tensor:
    """This rank's rows of the logically global batch, on its device: in the
    port each rank holds its own rows (JAX assembles a global array from
    them)."""
    t = local_batch if isinstance(local_batch, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(local_batch))
    return t.to(mesh.device, non_blocking=True)


def _rank_main(rank: int, fn: Callable, world: int, init_method: str, out_dir: str,
               device, args: tuple) -> None:
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(world)
    initialize_runtime(init_method, world, rank, device=device)
    try:
        torch.save(fn(rank, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: tuple = (), device=None,
              timeout_s: float = 600.0, store_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, *args)`` in ``world`` new processes (the ``spawn``
    start method) that form one process group, and return each rank's
    result (``torch.save``-able).  ``fn`` must be importable by name.  The
    group meets in a ``file://`` store under ``store_dir`` (a temporary
    directory by default), so no port is taken.  ``device`` is the device
    the ranks compute on (``"cpu"``, or None for :func:`rank_device`), which
    picks the backend as :func:`initialize_runtime` does.  A rank that
    raises, or a run past ``timeout_s``, stops every rank and raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(_rank_main, args=(fn, world, init_method, tmp, device, tuple(args)),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {world} ranks still running after "
                                       f"{timeout_s:.0f} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join(timeout=30)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
