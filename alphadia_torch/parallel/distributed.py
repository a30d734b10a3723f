"""Several processes: the process group, the file split and the barriers.

Work is split two ways, as in the JAX package:

- **file-parallel**: every process joins one ``torch.distributed`` group
  and searches its slice of the raw-file list (``shard_files_for_host``:
  file i goes to process i % n) on its own cards; the runs meet on a shared
  filesystem (``--quant-dir``), and process 0 builds the cross-run outputs
  once every process has passed a barrier;
- **batch-parallel**: within a process, candidate batches are split across
  its local cards (``search.common.data_parallel_devices``); across
  processes, ``process_rows`` gives each process its rows of a batch and
  ``all_gather_rows`` / ``all_sum`` bring the results together.

The group uses ``gloo``: every collective of the engine is a host barrier or
a gather of host arrays, and ``gloo`` also serves processes that share one
card (NCCL refuses two ranks on one GPU).

Environment contract, the first that is set wins:

- the coordinator ``host:port``: ``ALPHADIA_TPU_COORDINATOR``, else
  ``MASTER_ADDR`` and ``MASTER_PORT`` (``torchrun``; port 29500 if unset);
- the number of processes: ``ALPHADIA_TPU_NUM_PROCESSES``, ``WORLD_SIZE``,
  ``SLURM_NTASKS``;
- this process's rank: ``ALPHADIA_TPU_PROCESS_ID``, ``RANK``,
  ``SLURM_PROCID``;
- its cards: the visible cards split among the host's processes by
  ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (``local_devices``).

A single process with no coordinator joins nothing. Unlike the JAX
package, ``SLURM_JOB_ID`` or ``KUBERNETES_SERVICE_HOST`` alone start no
group: a batch job or a pod runs one search unless a coordinator is named.
A process asked to join a group that it cannot join raises; it never
searches alone. ``DEFAULT_TIMEOUT_S`` bounds joining and every collective
but the barriers, which wait up to ``BARRIER_TIMEOUT_S`` for the slowest
process's files.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from alphadia_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 1800.0
BARRIER_TIMEOUT_S = 24 * 3600.0


def _first(env, *names) -> str | None:
    for name in names:
        value = env.get(name)
        if value not in (None, ""):
            return value
    return None


def environment_contract(env=None) -> tuple[str | None, int, int]:
    """``(coordinator "host:port" or None, number of processes, rank)`` from
    the environment (the JAX package's, ``torchrun``'s or Slurm's)."""
    env = os.environ if env is None else env
    address = _first(env, "ALPHADIA_TPU_COORDINATOR")
    if address is None and _first(env, "MASTER_ADDR") is not None:
        address = f"{env['MASTER_ADDR']}:{_first(env, 'MASTER_PORT') or 29500}"
    n = int(_first(env, "ALPHADIA_TPU_NUM_PROCESSES", "WORLD_SIZE", "SLURM_NTASKS") or 1)
    rank = int(_first(env, "ALPHADIA_TPU_PROCESS_ID", "RANK", "SLURM_PROCID") or 0)
    return address, n, rank


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout_s: float | None = None,
) -> bool:
    """Join the process group (``gloo`` over TCP). Safe to call again: a
    joined group is kept. No-op for one process. Returns True when this
    process is one of several."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env_address, env_n, env_rank = environment_contract()
    address = coordinator_address or env_address
    n = num_processes or env_n
    rank = process_id if process_id is not None else env_rank
    if n <= 1:
        return False
    if address is None:
        raise RuntimeError(
            f"{n} processes asked for, but no coordinator: set MASTER_ADDR and MASTER_PORT, or "
            "ALPHADIA_TPU_COORDINATOR=host:port"
        )
    if not 0 <= rank < n:
        raise ValueError(f"process rank {rank} outside 0..{n - 1}")
    timeout = timedelta(seconds=DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
    dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=n, rank=rank, timeout=timeout)
    logger.log(25, "distributed: process %d/%d, %d local devices", rank, n, len(_local_card_indices()))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_files_for_host(
    raw_files: list[str], process_id: int | None = None, num_processes: int | None = None
) -> list[str]:
    """This process's raw files: file i goes to process i % n, balanced to
    within one file."""
    pid = process_index() if process_id is None else process_id
    n = num_processes or process_count()
    return [f for i, f in enumerate(raw_files) if i % n == pid]


def barrier(name: str) -> None:
    """Wait until every process of the group reaches this point (no-op for
    one process). A process that has left the group, or has not arrived
    within ``BARRIER_TIMEOUT_S``, makes it raise, naming the barrier."""
    if process_count() <= 1:
        return
    logger.info("distributed: barrier %s", name)
    try:
        dist.monitored_barrier(timeout=timedelta(seconds=BARRIER_TIMEOUT_S), wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"distributed barrier {name!r} failed on process {process_index()}: {e}") from e


def split_cards(n_cards: int, local_rank: int, local_world_size: int) -> list[int]:
    """Indices of the cards of local process ``local_rank`` of
    ``local_world_size``: every ``local_world_size``-th card from its rank,
    or, with fewer cards than processes, card ``local_rank % n_cards``
    (processes then share a card)."""
    if n_cards >= local_world_size:
        return list(range(n_cards))[local_rank::local_world_size]
    return [local_rank % n_cards]


def _local_card_indices() -> list[int]:
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards == 0:
        return []
    local_rank = int(os.environ.get("LOCAL_RANK") or 0)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE") or 1)
    return split_cards(n_cards, local_rank, local_world)


def local_devices() -> list[torch.device]:
    """This process's cards (``split_cards`` of the visible cards by
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``). Raises without a card."""
    cards = _local_card_indices()
    if not cards:
        resolve_device(None)  # raises, naming the missing card
    return [torch.device("cuda", i) for i in cards]


# ---------------------------------------------------------------------------
# batch-parallel across processes (the counterpart of JAX's global mesh)
# ---------------------------------------------------------------------------
def process_rows(n_rows: int) -> slice:
    """This process's contiguous rows of an ``n_rows`` batch (the first
    ``n_rows % n`` processes take one row more)."""
    n, rank = process_count(), process_index()
    size, extra = divmod(n_rows, n)
    start = rank * size + min(rank, extra)
    return slice(start, start + size + (rank < extra))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's rows of ``t`` concatenated in rank order (on the
    CPU; shards may differ in length)."""
    if process_count() <= 1:
        return t.cpu()
    parts: list = [None] * process_count()
    dist.all_gather_object(parts, t.cpu().numpy())
    return torch.from_numpy(np.concatenate(parts))


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes (on the CPU)."""
    out = t.detach().cpu().clone()
    if process_count() > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out
