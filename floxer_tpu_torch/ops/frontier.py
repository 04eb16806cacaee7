"""The per-query masked-frontier scheme search (K11 and its plain version).

Counterpart of floxer_tpu/search_device.py's _frontier_search, with
_frontier_block and _compact_done_rows (:921-1409): a block of seeds
(patterns int32 [num_seeds, max_len], each with its scheme class) starts
one state per (seed, search), and every iteration replaces each state of
the frontier by its ordered block of children, in the host DFS's edge
order: the state itself (a done row, a finishing row or a part advance),
the match, substitutions by symbol (the pattern's own symbol skipped),
insertions by symbol, the deletion. So the frontier is a DFS-prefix
ordering at every step, done rows hold their slot, and the done rows of
the final frontier in slot order are each seed's reports in host-DFS
order. A frontier whose children pass its capacity keeps the first
`frontier_capacity` of them and sets the overflow flag, which stops the
loop; the truncated frontier still yields its done rows.

frontier_search_plain is the reference's program in torch ops;
frontier_search_batch runs F independent frontiers of one shape: K11
(ops/cuda_frontier.py, csrc/frontier_search.cu, one thread block a
frontier) for CUDA operands, the plain version for CPU operands. Both
take the device index or the row-sharded one
(index/device_index.ShardedDeviceIndex, the reference's
sharded_frontier_search), whose ranks sum the shards' counts (K13's rank
inside K11).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..alphabet import SIGMA
from ..search_queue import initial_positions
from .cuda_fm_index import OCC_BLOCK, fm_rank_plain
from .cuda_sharded import fm_sharded_rank_plain

_EDIT_SYMBOLS = (1, 2, 3, 4, 5)
# last_op codes
_OP_M, _OP_I, _OP_D = 0, 1, 2
# edge kinds of a state, in the host DFS's order: itself, the match, 5
# substitutions, 5 insertions, the deletion
NUM_KINDS = 13
# columns of a fused scheme row (search_device.SchemeTables.fused)
_S_DIR, _S_START, _S_END, _S_LOWER, _S_UPPER, _S_NDIR, _S_NSTART, \
    _S_NEND = range(8)


@dataclass
class FrontierBatch:
    """F frontiers' results: reports int32 [F, R, 5] (lb, lb_rev, length,
    errors, block-local seed; the first num_reports[f] rows of frontier f
    valid, the rest 0), num_reports int32 [F], overflow bool [F, S] (a
    frontier's flag on each of its seeds), and the iterations and
    expanded states of each frontier (int64 [F])."""

    reports: torch.Tensor
    num_reports: torch.Tensor
    overflow: torch.Tensor
    iterations: torch.Tensor
    expanded: torch.Tensor


def is_sharded(index) -> bool:
    """A row-sharded index (duck-typed: it counts its shards)."""
    return hasattr(index, "num_shards")


def _ranks(index, base_fwd, base_rev, left, length_m):
    """(lo, hi) int64 [C, SIGMA]: the occurrences before each state's
    interval bounds on the direction it extends (the forward index going
    left at lb, the reverse one going right at lb_rev)."""
    if is_sharded(index):
        def rank(single, positions):
            return fm_sharded_rank_plain(
                positions, single.rank_rows, single.block_offset,
                single.shard_starts, single.shard_lengths,
            )

        fwd, rev = index.fwd, index.rev
        lo = torch.where(left[:, None], rank(fwd, base_fwd),
                         rank(rev, base_rev))
        hi = torch.where(left[:, None], rank(fwd, base_fwd + length_m),
                         rank(rev, base_rev + length_m))
    elif index.rank_rows is not None:
        # the combined table, reverse positions after rev_block_offset rows
        pos_lo = torch.where(left, base_fwd,
                             base_rev + index.rev_block_offset * OCC_BLOCK)
        lo = fm_rank_plain(pos_lo, index.rank_rows)
        hi = fm_rank_plain(pos_lo + length_m, index.rank_rows)
    else:
        fwd, rev = index.fwd, index.rev
        lo = torch.where(
            left[:, None],
            fm_rank_plain(base_fwd, None, 0, fwd.occ, fwd.planes),
            fm_rank_plain(base_rev, None, 0, rev.occ, rev.planes),
        )
        hi = torch.where(
            left[:, None],
            fm_rank_plain(base_fwd + length_m, None, 0, fwd.occ, fwd.planes),
            fm_rank_plain(base_rev + length_m, None, 0, rev.occ, rev.planes),
        )
    return lo.to(torch.int64), hi.to(torch.int64)


def frontier_search_plain(
    index,
    patterns: torch.Tensor,  # int32 [num_seeds, max_len]
    seed_class: torch.Tensor,  # int32 [num_seeds]
    scheme: torch.Tensor,  # int32 [classes * searches * parts, 8]
    num_searches: int,
    num_parts: int,
    frontier_capacity: int,
    report_capacity: int,
    max_iterations: int,
    stats: dict | None = None,
):
    """The reference's _frontier_search in torch ops, on whatever device
    the operands lie: (reports int32 [R, 5] = lb, lb_rev, length, errors,
    seed in the final frontier's slot order; num_reports; overflow bool
    [num_seeds]). `stats`, when given, receives the iterations and the
    expanded states."""
    device = patterns.device
    num_seeds, L = patterns.shape
    C, R = frontier_capacity, report_capacity
    scheme = scheme.to(torch.int64)
    classes = seed_class.to(torch.int64)
    pattern_rows = patterns.to(torch.int64)
    C_sym = index.C.to(torch.int64)

    # initial frontier: one state per (seed, search), search-minor
    init_count = num_seeds * num_searches
    overflow = init_count > C
    fill = min(init_count, C)
    slots = torch.arange(fill, device=device)
    seed0 = torch.div(slots, num_searches, rounding_mode="floor")
    search0 = slots % num_searches

    # the frontier's present slots are a prefix, and the slots past it make
    # no children: the state tensors hold the prefix only
    lb, lb_rev, errors, part, last_op = (
        torch.zeros(fill, dtype=torch.int64, device=device) for _ in range(5)
    )
    length = torch.full((fill,), index.n, dtype=torch.int64, device=device)
    search, seed = search0, seed0
    pos = initial_positions(scheme, classes, seed0, search0, num_searches,
                            num_parts)
    done = torch.zeros(fill, dtype=torch.bool, device=device)
    present = torch.ones(fill, dtype=torch.bool, device=device)

    iterations = expanded_states = 0
    while (iterations < max_iterations and not overflow
           and bool((present & ~done).any())):
        alive = present & ~done
        part_c = part.clamp(0, num_parts - 1)
        row = scheme[(classes[seed] * num_searches + search) * num_parts
                     + part_c]
        direction = row[:, _S_DIR]
        at_boundary = torch.where(
            direction > 0, pos >= row[:, _S_END], pos < row[:, _S_START]
        ) & alive
        meets_lower = errors >= row[:, _S_LOWER]
        # the raw part decides the finish; the clipped one read the row
        finished = at_boundary & meets_lower & (part == num_parts - 1)
        advancing = at_boundary & meets_lower & ~finished
        next_first = torch.where(row[:, _S_NDIR] > 0, row[:, _S_NSTART],
                                 row[:, _S_NEND] - 1)
        self_keep = (done & present) | finished | advancing
        part_self = torch.where(advancing, part + 1, part)
        pos_self = torch.where(advancing, next_first, pos)
        done_self = (done & present) | finished

        expanding = alive & ~at_boundary
        expanded_states += int(expanding.sum())
        left = direction < 0
        lo, hi = _ranks(index, torch.where(expanding, lb, 0),
                        torch.where(expanding, lb_rev, 0), left,
                        torch.where(expanding, length, 0))
        counts = hi - lo  # [count, SIGMA]
        prefix = torch.cumsum(counts, dim=1) - counts
        primary = C_sym[None, :SIGMA] + lo
        secondary = torch.where(left, lb_rev, lb)[:, None] + prefix
        child_lb = torch.where(left[:, None], primary, secondary)
        child_lb_rev = torch.where(left[:, None], secondary, primary)

        pattern_symbol = pattern_rows[seed, pos.clamp(0, L - 1)]
        match_symbol = torch.where(
            (pattern_symbol >= 1) & (pattern_symbol < SIGMA),
            pattern_symbol, 0,
        )
        budget_left = errors < row[:, _S_UPPER]

        def at_match(table):
            return table.gather(1, match_symbol[:, None])[:, 0]

        sym = list(_EDIT_SYMBOLS)
        zero = torch.zeros_like(lb)
        valid = torch.stack(
            [self_keep, expanding & (at_match(counts) > 0)]
            + [expanding & budget_left & (pattern_symbol != s)
               & (counts[:, s] > 0) for s in sym]
            + [expanding & budget_left & (counts[:, s] > 0)
               & (last_op != _OP_D) for s in sym]
            + [expanding & budget_left & (last_op != _OP_I)], dim=1,
        )  # [count, 13], row-major = (parent slot, edge) order
        step = pos + direction
        fields = torch.stack([torch.stack(columns, dim=1) for columns in (
            [lb, at_match(child_lb)] + [child_lb[:, s] for s in sym] * 2
            + [lb],
            [lb_rev, at_match(child_lb_rev)]
            + [child_lb_rev[:, s] for s in sym] * 2 + [lb_rev],
            [length, at_match(counts)] + [counts[:, s] for s in sym] * 2
            + [length],
            [pos_self, step] + [step] * 5 + [pos] * 5 + [step],
            [errors, errors] + [errors + 1] * 11,
            [last_op] + [zero + _OP_M] * 6 + [zero + _OP_I] * 5
            + [zero + _OP_D],
            [part_self] + [part] * 12,
            [search] * NUM_KINDS,
            [seed] * NUM_KINDS,
            [done_self.long()] + [zero] * 12,
        )], dim=2)  # [count, 13, 10]

        children = fields[valid]  # [total, 10] in (slot, edge) order
        total = children.shape[0]
        overflow = overflow or total > C
        count = min(total, C)
        packed = children[:count]
        lb, lb_rev, length, pos, errors, last_op, part, search, seed = (
            packed[:, f] for f in range(9)
        )
        done = packed[:, 9] > 0
        present = torch.ones(count, dtype=torch.bool, device=device)
        iterations += 1

    # the done rows of the final frontier in slot order: host-DFS order
    rows = torch.stack([lb, lb_rev, length, errors, seed], dim=1)[
        done & present
    ]
    num_done = rows.shape[0]
    reports = torch.zeros((R, 5), dtype=torch.int32, device=device)
    kept = min(num_done, R)
    reports[:kept] = rows[:kept].to(torch.int32)
    flags = torch.full((num_seeds,), overflow or num_done > R,
                       dtype=torch.bool, device=device)
    if stats is not None:
        stats["iterations"] = iterations
        stats["expanded"] = expanded_states
    return reports, kept, flags


def frontier_search_batch(
    index,
    patterns: torch.Tensor,  # int32 [F, num_seeds, max_len]
    seed_class: torch.Tensor,  # int32 [F, num_seeds]
    scheme: torch.Tensor,  # int32 [classes * searches * parts, 8]
    num_searches: int,
    num_parts: int,
    frontier_capacity: int,
    report_capacity: int,
    max_iterations: int,
) -> FrontierBatch:
    """F independent frontiers of one shape, each with its own capacity
    and flag: K11 for CUDA operands (asynchronous), the plain version, one
    frontier after another, for CPU operands."""
    if patterns.device.type != "cpu":
        from .cuda_frontier import frontier_search_cuda

        return frontier_search_cuda(
            index, patterns, seed_class, scheme, num_searches, num_parts,
            frontier_capacity, report_capacity, max_iterations,
        )
    results = []
    for f in range(patterns.shape[0]):
        stats = {}
        reports, num_reports, flags = frontier_search_plain(
            index, patterns[f], seed_class[f], scheme, num_searches,
            num_parts, frontier_capacity, report_capacity, max_iterations,
            stats,
        )
        results.append((reports, num_reports, flags, stats))
    F, S = patterns.shape[:2]
    if not results:
        return FrontierBatch(
            torch.zeros((0, report_capacity, 5), dtype=torch.int32),
            torch.zeros(0, dtype=torch.int32),
            torch.zeros((0, S), dtype=torch.bool),
            torch.zeros(0, dtype=torch.int64),
            torch.zeros(0, dtype=torch.int64),
        )
    return FrontierBatch(
        torch.stack([r[0] for r in results]),
        torch.tensor([r[1] for r in results], dtype=torch.int32),
        torch.stack([r[2] for r in results]),
        torch.tensor([r[3]["iterations"] for r in results],
                     dtype=torch.int64),
        torch.tensor([r[3]["expanded"] for r in results], dtype=torch.int64),
    )
