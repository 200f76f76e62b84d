"""`--distributed`: data parallelism over processes with torch.distributed.

Counterpart of the jax.distributed part of hipstr_tpu/cli.py (:275-292,
:319-326, :424-448).  Every process (rank) genotypes its share of the
loci (the BED and FASTA are replicated, loci are sharded by rank through
`--locus-shard`) into shard files of its own; the run's seven counters are
summed over the ranks, and after a barrier rank 0 merges the shards.

The process group is gloo on the host: it carries only those counters and
the barrier, never tensors of the card, and two ranks on one card (which
NCCL refuses as a duplicate GPU) work as well as one rank per card.  Each
rank runs its loci on card `local_rank mod device_count`.

Rendezvous: `--coordinator host:port` with `--num-processes` and
`--process-id` (a `tcp://` init), or else the `env://` variables that
torchrun sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  With neither
the run is refused; it never carries on as a single process.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Tuple

import torch
import torch.distributed as dist

# Ranks wait at the counter reduction for the slowest rank's shard, which
# on a real call set can take hours; a rank that dies closes its sockets,
# which ends the others' wait at once.
TIMEOUT = datetime.timedelta(hours=24)
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


class RendezvousError(ValueError):
    """The command line names no process group to join."""


def init_method(coordinator: str, num_processes: int,
                process_id: int) -> Tuple[str, int, int]:
    """(init_method, world_size, rank) for init_process_group; raises
    RendezvousError when neither a coordinator nor the env:// variables
    are given, or the coordinator's world is not well formed."""
    if coordinator:
        if num_processes < 1 or not 0 <= process_id < num_processes:
            raise RendezvousError(
                "--coordinator needs --num-processes N >= 1 and "
                "--process-id in [0, N)")
        return f"tcp://{coordinator}", num_processes, process_id
    missing = [v for v in ENV_VARS if v not in os.environ]
    if missing:
        raise RendezvousError(
            "--distributed needs --coordinator host:port with "
            "--num-processes and --process-id, or the env:// variables "
            f"of torchrun (missing: {', '.join(missing)})")
    return ("env://", int(os.environ["WORLD_SIZE"]),
            int(os.environ["RANK"]))


def init(coordinator: str, num_processes: int,
         process_id: int) -> Tuple[int, int]:
    """Join the gloo process group; returns (rank, world size)."""
    method, world, rank = init_method(coordinator, num_processes, process_id)
    dist.init_process_group("gloo", init_method=method, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def place(device: torch.device, rank: int) -> torch.device:
    """This rank's device: on `cuda`, card local_rank mod device_count (made
    the current device, so every kernel launches on its stream)."""
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    index = local % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def sum_counters(values: List[int]) -> List[int]:
    """The counters summed over every rank (an int64 all-reduce)."""
    t = torch.tensor(values, dtype=torch.int64)
    dist.all_reduce(t)
    return t.tolist()


def barrier() -> None:
    dist.barrier()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
