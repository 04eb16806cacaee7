"""K11: the per-query masked-frontier scheme search on the card.

Counterpart of floxer_tpu/search_device.py's _frontier_search. The kernel
(csrc/frontier_search.cu) runs F independent frontiers of one shape, one
thread block each, and gives what ops/frontier.frontier_search_plain, its
plain version, gives for each of them bit for bit: the reports in the
final frontier's slot order, their count and the overflow flag. This
wrapper takes CUDA tensors only (ops/frontier.frontier_search_batch runs
the plain version for CPU tensors); it does not synchronize. Over the
row-sharded index (a ShardedDeviceIndex) it launches the kernel's
instance over the shard tables (frontier_kernel<FmShardedRankTable>, the
counterpart of floxer_tpu/parallel/sharded_index.py's
sharded_frontier_search), counted apart in SHARDED_LAUNCHES.
"""

from __future__ import annotations

import torch

from ..alphabet import SIGMA
from ._build import check_operand, launch
from .frontier import is_sharded

SOURCE = "floxer_tpu_torch/csrc/frontier_search.cu"
REPLACES = "floxer_tpu/search_device.py:921"
SHARDED_REPLACES = "floxer_tpu/parallel/sharded_index.py:371"
# the kernel's block and the int32 fields of one frontier slot
THREADS = 512
FIELDS = 10
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


def frontier_search_cuda(index, patterns, seed_class, scheme, num_searches,
                         num_parts, frontier_capacity, report_capacity,
                         max_iterations):
    """K11 on CUDA operands: patterns int32 [F, S, L], seed_class int32
    [F, S], the fused scheme rows int32 [classes * searches * parts, 8].
    One launch; returns an ops.frontier.FrontierBatch of device tensors."""
    from .frontier import FrontierBatch

    global LAUNCHES, SHARDED_LAUNCHES
    _check_operands(index, patterns, seed_class, scheme, num_searches,
                    num_parts)
    device = patterns.device
    F, S, L = patterns.shape
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
            torch.cuda.current_stream(device).cuda_stream,
        )
        with torch.cuda.device(device):
            if is_sharded(index):
                fwd, rev = index.fwd, index.rev
                launch(
                    "floxer_frontier_search_sharded", rows.data_ptr(),
                    rows.shape[1], int(index.rev_block_offset),
                    fwd.shard_starts.data_ptr(), fwd.shard_lengths.data_ptr(),
                    rev.shard_starts.data_ptr(), rev.shard_lengths.data_ptr(),
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
