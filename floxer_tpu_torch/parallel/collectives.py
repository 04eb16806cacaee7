"""The process set of a multi-process run, on torch.distributed (gloo).

Counterpart of floxer_tpu/parallel/multihost.py:maybe_initialize_distributed
and floxer_tpu/parallel/mesh.py:allreduce_stats. The processes find each
other through the reference's variables: JAX_COORDINATOR_ADDRESS
(host:port of process 0's TCP store), JAX_NUM_PROCESSES and
JAX_PROCESS_ID. Unlike jax.distributed the port detects no cluster, so a
coordinator without the other two is an error.

gloo, not NCCL: the only collective is the statistics merge, a few hundred
int64 values on the host, and NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import numpy as np
import torch

COORDINATOR = "JAX_COORDINATOR_ADDRESS"
NUM_PROCESSES = "JAX_NUM_PROCESSES"
PROCESS_ID = "JAX_PROCESS_ID"
# how long a process waits for the others to join, and in each collective
TIMEOUT = datetime.timedelta(seconds=600)


class ProcessSetError(RuntimeError):
    """The environment names a process set the port cannot join."""


def maybe_initialize_distributed() -> tuple[int, int]:
    """Join the process set when a coordinator is configured; returns
    (rank, world size), (0, 1) without a coordinator. Safe to call again
    in a process that has joined (returns the live process set)."""
    import torch.distributed as dist

    coordinator = os.environ.get(COORDINATOR)
    if not coordinator:
        return 0, 1
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    missing = [
        name for name in (NUM_PROCESSES, PROCESS_ID) if not os.environ.get(name)
    ]
    if missing:
        raise ProcessSetError(
            f"{COORDINATOR} is set but {' and '.join(missing)} "
            f"{'is' if len(missing) == 1 else 'are'} not: the port joins a "
            f"process set only with {NUM_PROCESSES} and {PROCESS_ID} given "
            "(it detects no cluster)"
        )
    try:
        world_size = int(os.environ[NUM_PROCESSES])
        rank = int(os.environ[PROCESS_ID])
    except ValueError as error:
        raise ProcessSetError(
            f"{NUM_PROCESSES} and {PROCESS_ID} must be integers: {error}"
        ) from None
    if not 0 <= rank < world_size:
        raise ProcessSetError(
            f"{PROCESS_ID}={rank} is outside 0..{world_size - 1}"
        )
    try:
        with stdout_to_stderr():
            dist.init_process_group(
                "gloo",
                init_method=f"tcp://{coordinator}",
                world_size=world_size,
                rank=rank,
                timeout=TIMEOUT,
            )
    except Exception as error:  # noqa: BLE001 - any failed join fails the run
        raise ProcessSetError(
            f"joining the process set at {coordinator} as process {rank} of "
            f"{world_size} failed: {error}"
        ) from error
    return rank, world_size


def allreduce_stats(sums, mins, maxs):
    """Cross-process stats merge: SUM for the sum-mergeable slots, MIN and
    MAX for the order statistics, over every process's
    stats.to_merge_arrays(); each process receives the merged triple."""
    import torch.distributed as dist

    merged = []
    for values, op in (
        (sums, dist.ReduceOp.SUM),
        (mins, dist.ReduceOp.MIN),
        (maxs, dist.ReduceOp.MAX),
    ):
        tensor = torch.from_numpy(np.asarray(values, dtype=np.int64).copy())
        dist.all_reduce(tensor, op=op)
        merged.append(tensor.numpy())
    return tuple(merged)


def barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


def leave_process_set() -> None:
    """Destroy the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def stdout_to_stderr():
    """Route fd 1 to stderr: gloo may write to raw stdout when its context
    forms, and the aligner's stdout stays empty."""
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        yield
    finally:
        os.dup2(saved, 1)
        os.close(saved)
