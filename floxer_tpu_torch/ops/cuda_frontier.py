"""K11: the per-query masked-frontier scheme search on the card.

Counterpart of floxer_tpu/search_device.py's _frontier_search. The kernel
(csrc/frontier_search.cu) runs F independent frontiers of one shape, one
cluster of B thread blocks each (B picked here by cluster_size, or given),
and gives what ops/frontier.frontier_search_plain, its plain version,
gives for each of them bit for bit, whatever B: the reports in the final
frontier's slot order, their count and the overflow flag. This wrapper
takes CUDA tensors only (ops/frontier.frontier_search_batch runs the
plain version for CPU tensors); it does not synchronize, and raises when
the launch is refused (a cluster the card cannot place). Over the
row-sharded index (a ShardedDeviceIndex) it launches the kernel's
instance over the shard tables (frontier_kernel<FmShardedRankTable>, the
counterpart of floxer_tpu/parallel/sharded_index.py's
sharded_frontier_search), counted apart in SHARDED_LAUNCHES.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..alphabet import SIGMA
from ._build import check_operand, launch
from .frontier import is_sharded

SOURCE = "floxer_tpu_torch/csrc/frontier_search.cu"
REPLACES = "floxer_tpu/search_device.py:921"
SHARDED_REPLACES = "floxer_tpu/parallel/sharded_index.py:371"
# the kernel's block, the int32 fields of one frontier slot and the
# largest cluster the kernel takes
THREADS = 512
FIELDS = 10
MAX_CLUSTER = 16
# cluster_size's rule: the largest cluster it picks, and the states an
# iteration it expects for each initial state of a frontier that starts
# past one block's round
PICK_MAX_CLUSTER = 8
FRONTIER_GROWTH = 2
# columns of a frontier's stats row
_REPORTS, _OVERFLOW, _ITERATIONS, _EXPANDED = range(4)
# kernel launches in this process, over the index and over its shards
# (read and reset by chip_smoke.py)
LAUNCHES = 0
SHARDED_LAUNCHES = 0


def _check_operands(index, patterns, seed_class, scheme, num_searches,
                    num_parts):
    device = patterns.device
    if device.type != "cuda":
        raise ValueError(f"a CUDA kernel got operands on {device}")
    F, S, L = patterns.shape
    check_operand(patterns, "patterns", (F, S, L), torch.int32, device)
    check_operand(seed_class, "seed_class", (F, S), torch.int32, device)
    check_operand(scheme, "scheme", (scheme.shape[0], 8), torch.int32, device)
    if scheme.shape[0] % (num_searches * num_parts):
        raise ValueError("scheme rows are not classes x searches x parts")
    check_operand(index.C, "C", (SIGMA + 1,), torch.int32, device)
    if is_sharded(index):
        S = index.num_shards
        check_operand(index.rank_rows, "rank_rows",
                      (S, index.rank_rows.shape[1], 32), torch.int32, device)
        for single in (index.fwd, index.rev):
            for tensor, name in ((single.shard_starts, "shard_starts"),
                                 (single.shard_lengths, "shard_lengths")):
                check_operand(tensor, name, (S,), torch.int32, device)
            check_operand(single.shard_before, "shard_before", (S, SIGMA),
                          torch.int32, device)
    elif index.rank_rows is not None:
        check_operand(index.rank_rows, "rank_rows",
                      (index.rank_rows.shape[0], 32), torch.int32, device)
    else:
        for single in (index.fwd, index.rev):
            nb = single.planes.shape[0]
            check_operand(single.occ, "occ", (nb + 1, SIGMA), torch.int32,
                          device)
            check_operand(single.planes, "planes", (nb, SIGMA, 4),
                          torch.int32, device)


@functools.lru_cache(maxsize=None)
def max_clusters(device: torch.device, cluster: int, sharded: bool) -> int:
    """Clusters of `cluster` blocks of the instance over the index (or
    over the shard tables) the card holds at once; 0 when none fits."""
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device):
        launch("floxer_frontier_max_clusters", int(sharded), cluster,
               ctypes.addressof(clusters))
    return clusters.value


def cluster_size(device: torch.device, num_frontiers: int,
                 init_count: int) -> int:
    """The blocks of a frontier's cluster: one when its initial states fit
    one block's round (a cluster's exchanges cost more than the few
    iterations that pass it), else the smallest power of two whose round
    (B x THREADS slots) holds FRONTIER_GROWTH x the initial states, at
    most PICK_MAX_CLUSTER; halved while the launch's blocks would pass
    the card's SMs (a launch of many frontiers fills the card with one
    block each)."""
    cluster = 1
    while (init_count > THREADS and cluster < PICK_MAX_CLUSTER
           and cluster * THREADS < init_count * FRONTIER_GROWTH):
        cluster *= 2
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    while cluster > 1 and num_frontiers * cluster > sms:
        cluster //= 2
    return cluster


def frontier_search_cuda(index, patterns, seed_class, scheme, num_searches,
                         num_parts, frontier_capacity, report_capacity,
                         max_iterations, cluster=None):
    """K11 on CUDA operands: patterns int32 [F, S, L], seed_class int32
    [F, S], the fused scheme rows int32 [classes * searches * parts, 8].
    One launch, each frontier on a cluster of `cluster` blocks
    (cluster_size's pick unless given); returns an
    ops.frontier.FrontierBatch of device tensors."""
    from .frontier import FrontierBatch

    global LAUNCHES, SHARDED_LAUNCHES
    _check_operands(index, patterns, seed_class, scheme, num_searches,
                    num_parts)
    device = patterns.device
    F, S, L = patterns.shape
    sharded = is_sharded(index)
    if cluster is None:
        cluster = cluster_size(device, F, S * num_searches)
    reports = torch.zeros((F, report_capacity, 5), dtype=torch.int32,
                          device=device)
    stats = torch.zeros((F, 4), dtype=torch.int32, device=device)
    if F:
        frontier = torch.empty(F * 2 * FIELDS * frontier_capacity,
                               dtype=torch.int32, device=device)
        rows = index.rank_rows
        # the operands after the index's: C, n, the frontiers, the
        # scheme, the capacities and the buffers
        common = (
            index.C.data_ptr(), int(index.n), patterns.data_ptr(),
            seed_class.data_ptr(), F, S, L, scheme.data_ptr(), num_searches,
            num_parts, frontier_capacity, report_capacity, max_iterations,
            frontier.data_ptr(), reports.data_ptr(), stats.data_ptr(),
            cluster, torch.cuda.current_stream(device).cuda_stream,
        )
        with torch.cuda.device(device):
            if sharded:
                fwd, rev = index.fwd, index.rev
                launch(
                    "floxer_frontier_search_sharded", rows.data_ptr(),
                    rows.shape[1], int(index.rev_block_offset),
                    fwd.shard_starts.data_ptr(), fwd.shard_lengths.data_ptr(),
                    fwd.shard_before.data_ptr(), rev.shard_starts.data_ptr(),
                    rev.shard_lengths.data_ptr(), rev.shard_before.data_ptr(),
                    index.num_shards, *common,
                )
                SHARDED_LAUNCHES += 1
            else:
                launch(
                    "floxer_frontier_search",
                    None if rows is None else rows.data_ptr(),
                    index.fwd.occ.data_ptr(), index.fwd.planes.data_ptr(),
                    index.rev.occ.data_ptr(), index.rev.planes.data_ptr(),
                    int(index.rev_block_offset), *common,
                )
                LAUNCHES += 1
    return FrontierBatch(
        reports,
        stats[:, _REPORTS],
        (stats[:, _OVERFLOW] > 0)[:, None].expand(F, S),
        stats[:, _ITERATIONS].to(torch.int64),
        stats[:, _EXPANDED].to(torch.int64),
    )
