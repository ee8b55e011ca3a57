"""Multi-process scale-out for virtual screens.

Counterpart of the JAX package's gnina_tpu/parallel/multihost.py, on a
torch.distributed process group (gloo: the group carries only the
rendezvous, barriers and end-of-run scalars, never a tensor of the dock):

  - every process calls :func:`init` (a rendezvous at the coordinator's
    address; a no-op for one process), then docks its own slice of the
    ligand stream on its own cards: docking needs no communication
    between ligands;
  - the ligand stream is split round-robin (:func:`host_shard`), which
    keeps each ligand's global index, so the output order is the
    one-process screen's.  The docked poses are not: a screen docks each
    batch with the one --seed and the kernels key their random streams on
    a ligand's lane within its batch, so a ligand that moves to another
    batch position draws other numbers (the JAX docstring's claim that a
    multi-host screen "scores identically" does not hold there either;
    ROADMAP "Found in the JAX package").  Each process's output equals a
    one-process screen of its own subset;
  - each process writes ``{out}.part{pid}`` and process 0 merges them
    after a barrier (:func:`merge_part_outputs`), on a shared filesystem;
  - :func:`allgather_scalars` gathers a list of floats from every process.

Env contract (set by the launcher, e.g. one process per host):
  GNINA_TPU_COORDINATOR=host0:8476  GNINA_TPU_NPROCS=4  GNINA_TPU_PROCID=0
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Iterator, List, Optional, Tuple, TypeVar

T = TypeVar("T")

_initialized = False
# seconds a rendezvous, barrier or gather may wait for the other processes
# before it raises
TIMEOUT_S = 600.0


def env_config() -> Tuple[Optional[str], int, int]:
    """(coordinator, num_processes, process_id) from the environment."""
    coord = os.environ.get("GNINA_TPU_COORDINATOR")
    nprocs = int(os.environ.get("GNINA_TPU_NPROCS", "1"))
    pid = int(os.environ.get("GNINA_TPU_PROCID", "0"))
    return coord, nprocs, pid


def init(coordinator: Optional[str] = None, num_processes: int = 1,
         process_id: int = 0, timeout: Optional[float] = None) -> bool:
    """Join the gloo process group at tcp://coordinator; returns True if a
    multi-process group was set up (one process: a no-op, False).  A
    rendezvous that does not complete within `timeout` seconds (default
    TIMEOUT_S) raises."""
    global _initialized
    if num_processes <= 1:
        return False
    if _initialized:
        return True
    if not coordinator:
        raise ValueError("a multi-process screen needs a coordinator "
                         "address host:port")
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(
            seconds=TIMEOUT_S if timeout is None else timeout))
    _initialized = True
    return True


def shutdown() -> None:
    """Leave the process group (a no-op when none was set up)."""
    global _initialized
    if not _initialized:
        return
    import torch.distributed as dist

    dist.destroy_process_group()
    _initialized = False


def host_shard(items: Iterable[T], process_id: int,
               num_processes: int) -> Iterator[Tuple[int, T]]:
    """Round-robin slice of an (index, item) stream for this process.

    Yields (global_index, item), so the merged output keeps the input
    order of a one-process run of the same file.
    """
    for i, it in enumerate(items):
        if i % num_processes == process_id:
            yield i, it


def barrier(name: str = "gnina_tpu") -> None:
    """Wait for every process (a no-op without a process group)."""
    del name  # gloo barriers are anonymous
    if not _initialized:
        return
    import torch.distributed as dist

    dist.barrier()


def allgather_scalars(values: List[float]) -> List[float]:
    """Gather every process's list of floats (all of one length), in
    process order; one process: the list itself."""
    if not _initialized:
        return list(values)
    import torch
    import torch.distributed as dist

    t = torch.as_tensor(list(values), dtype=torch.float32)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [float(v) for v in torch.cat(out)]


def part_path(out: str, process_id: int) -> str:
    return f"{out}.part{process_id}"


def merge_part_outputs(out: str, num_processes: int,
                       block_index_prefix: str = "#GNINA_TPU_IDX ") -> int:
    """Merge the per-process ``{out}.part{pid}`` files into ``out`` in
    global ligand order.  Each part file holds blocks introduced by an
    index header line (the screen checkpoint format).  Returns the number
    of blocks merged.

    Call from process 0 after :func:`barrier`; a shared filesystem is
    assumed (per-host local disks are not supported).
    """
    blocks = {}
    for pid in range(num_processes):
        path = part_path(out, pid)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            idx = None
            buf: List[str] = []
            for line in f:
                if line.startswith(block_index_prefix):
                    if idx is not None:
                        blocks[idx] = "".join(buf)
                    idx = int(line[len(block_index_prefix):].split()[0])
                    buf = []
                else:
                    buf.append(line)
            if idx is not None:
                blocks[idx] = "".join(buf)
    with open(out, "w") as f:
        for idx in sorted(blocks):
            f.write(blocks[idx])
    return len(blocks)
