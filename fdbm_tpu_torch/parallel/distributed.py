"""Process groups and host-level collectives.

Port of ``fdbm_tpu/parallel/distributed.py`` on ``torch.distributed``. The
reference trains with DDP over NCCL and shards evaluation and inference
files by rank (SURVEY.md section 2.7); the port does the same:

* :func:`initialize` wires the processes into one group: from the
  arguments, or with none from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). The
  backend is NCCL for processes on the card and gloo on the CPU;
* :func:`spawn` starts the processes of ``-D N`` on one machine;
* :func:`process_index` / :func:`process_count` drive the file sharding,
  as the reference's ``dist.get_rank()`` / ``get_world_size()`` do;
* :func:`all_gather_host_metrics` reduces per-process scalar metrics over
  a fixed key set (the reference's ``sync_dist=True`` logging).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# The key set of a validation epoch's metrics. Every process passes the
# same ordered keys to the collective, also where its evaluation shard gave
# no value for a key (count 0): the reduced buffer has one shape everywhere.
VALID_METRIC_SCHEMA = ("valid_loss", "si_sdr", "pesq", "estoi")


def under_launcher() -> bool:
    """Whether a launcher (torchrun) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(init_method: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device="cuda") -> None:
    """Join the process group; a no-op once joined, and without arguments
    outside a launcher. ``backend`` defaults to NCCL for a CUDA ``device``
    and gloo for the CPU; for NCCL this process's card is
    ``cuda:LOCAL_RANK`` (or ``cuda:process_id``). All of ``init_method``,
    ``num_processes`` and ``process_id`` or none: a partial set raises. A
    failed initialisation raises: a run meant for several processes never
    goes on as one."""
    if dist.is_initialized():
        return
    explicit = (init_method, num_processes, process_id)
    if all(a is None for a in explicit):
        if not under_launcher():
            return
        init_method = "env://"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(a is None for a in explicit):
        raise ValueError("initialize needs all of init_method, num_processes and process_id "
                         f"(got {init_method!r}, {num_processes!r}, {process_id!r})")
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA device and none is available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


@contextlib.contextmanager
def launched(device="cuda") -> Iterator[None]:
    """A CLI's block under a launcher: the group of torchrun's environment
    joined for it (:func:`initialize`; nothing outside a launcher) and left
    after it, unless it was joined before."""
    joined = dist.is_initialized()
    initialize(device=device)
    try:
        yield
    finally:
        if not joined:
            shutdown()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_device(device) -> torch.device:
    """This process's device for ``device``: in a group, a CUDA device is
    its card (``cuda:LOCAL_RANK`` or ``cuda:rank``, made current by
    :func:`initialize`)."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: this process's
    card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with process ``src``'s value, in place."""
    if not dist.is_initialized():
        return
    # gloo takes CPU and CUDA tensors, NCCL only this process's card.
    dev = comm_device() if dist.get_backend() == "nccl" else None
    with torch.no_grad():
        for t in tensors:
            buf = t.detach() if dev is None or t.device == dev else t.detach().to(dev)
            dist.broadcast(buf, src)
            if buf.data_ptr() != t.data_ptr():
                t.copy_(buf)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Process ``src``'s ``obj`` (picklable) on every process."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, device=comm_device())
    return box[0]


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], nprocs: int, device, *args: Any) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes joined in one group
    (``torch.multiprocessing.spawn``; rank r on ``cuda:r`` over NCCL for a
    CUDA ``device``, on the CPU over gloo otherwise), rendezvousing through
    a file store in a fresh temporary directory. Returns when every process
    has ended; raises with the traceback of a process that failed (the
    others are stopped)."""
    import torch.multiprocessing as mp

    store_dir = tempfile.mkdtemp(prefix="fdbm_group_")
    try:
        mp.spawn(_spawned, args=(nprocs, os.path.join(store_dir, "store"), str(device), fn,
                                 args), nprocs=nprocs, join=True)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def _spawned(rank: int, nprocs: int, store: str, device: str, fn: Callable[..., Any],
             args: Tuple[Any, ...]) -> None:
    initialize(f"file://{store}", nprocs, rank, device=device)
    try:
        fn(*args)
    finally:
        shutdown()


def all_gather_host_metrics(metrics: Dict[str, float], counts: Optional[Dict[str, int]] = None,
                            schema: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Count-weighted means of scalar metrics over the processes.

    One process: ``metrics`` unchanged. Several: each key's value times its
    count (from ``counts``, else 1 where ``metrics`` has the key and 0
    where it lacks it) and the count are summed over the processes in
    float64 by one ``all_reduce``; keys whose total count is 0 are dropped
    (``fdbm_tpu/parallel/distributed.py:all_gather_host_metrics``). ``schema``
    fixes the keys and their order, and every process must call this with
    the same schema (e.g. :data:`VALID_METRIC_SCHEMA`), also with an empty
    ``metrics``; without one the keys are ``sorted(metrics)``, which is
    safe only where every process has the same keys."""
    if process_count() == 1:
        return dict(metrics)
    keys = list(schema) if schema is not None else sorted(metrics)
    counts = counts or {}
    cnt = [float(counts.get(k, 1 if k in metrics else 0)) for k in keys]
    val = [float(metrics.get(k, 0.0)) * c for k, c in zip(keys, cnt)]
    buf = torch.tensor([val, cnt], dtype=torch.float64, device=comm_device())
    dist.all_reduce(buf)
    total_v, total_c = buf.cpu().tolist()
    return {k: total_v[i] / total_c[i] for i, k in enumerate(keys) if total_c[i] > 0}
