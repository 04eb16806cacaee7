"""Counterpart of floxer_tpu/search_queue.py: the work-queue device seed
search of --device-search.

For S seeds (int32 [S, L] padded patterns) and their scheme classes, the
search gives every finished search state as a report row int32 [6 + KW]:
(lb, lb_rev, length, errors, seed, search, DFS path-key words), plus the
report count, an overflow flag and the number of expanded nodes. Every
expansion step writes its edge kind (1 match, 2..6 substitutions by
symbol, 7..11 insertions, 12 deletion: the host DFS's edge order) as a
4-bit nibble at the parent's depth, earlier depths in more significant
bits, so comparing the key words as uint32 compares DFS paths; a boundary
advance writes none. sort_reports restores host-DFS order per seed, which
is all the keep-first dedup and cap replay of the searcher need.

On the card the search is K10 (csrc/workqueue_search.cu, one thread per
(seed, search) root running the host's DFS); on the CPU it is
workqueue_search_plain, the reference's windowed LIFO work queue (pop a
quantum of the deepest states, expand the longest suffix whose children
fit the push block, push the survivors, then a tail phase with a small
quantum) in torch ops. Both give the same set of rows, so the same rows
once sorted.

R1 is repaired here: the reference leaves `overflow` False when its loops
stop at max_iterations with states still on the stack, so truncated
reports pass as complete; the plain version sets overflow then.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from . import tracing
from .alphabet import SIGMA

logger = logging.getLogger("floxer-tpu")

_EDIT_SYMBOLS = (1, 2, 3, 4, 5)
# last_op codes
_OP_M, _OP_I, _OP_D = 0, 1, 2

# pop quantum, push block and iteration bound of the plain version (the
# reference's defaults; K10 has none of them)
QUANTUM = 1 << 16
PUSH_FACTOR = 3
MAX_ITERATIONS = 1 << 16
# searches retried at 4x capacity in this process (read by chip_smoke.py
# and the tests: each retry on the card is a second K10 launch)
RETRIES = 0

# state row layout of the plain version's stack: 10 scalars + KW key words
_F_LB, _F_LBREV, _F_LEN, _F_POS, _F_ERR, _F_OP, _F_PART, _F_SEARCH, \
    _F_SEED, _F_DEPTH = range(10)
_NUM_SCALARS = 10
# columns of a fused scheme row (SchemeTables.fused)
_S_DIR, _S_START, _S_END, _S_LOWER, _S_UPPER, _S_NDIR, _S_NSTART, \
    _S_NEND = range(8)
_MASK32 = 0xFFFFFFFF


@dataclass
class QueueRun:
    """One search's result: report rows (int32 [R, 6 + KW], the first
    num_reports valid, in completion order), the overflow flag, the
    expanded nodes; and, of K10 only, the largest tree of one root, the
    entries spilled to its work lists, its launches (generations) and the
    most entries one generation spilled."""

    reports: torch.Tensor
    num_reports: int
    overflow: bool
    nodes: int
    largest_tree: int | None = None
    spilled: int | None = None
    launches: int | None = None
    list_peak: int | None = None


def key_words_needed(max_len: int, max_errors: int) -> int:
    """Key words for a seed class: one nibble per expansion step; a path
    expands at most pattern_length + errors (insertions) times."""
    return -(-(max_len + max_errors + 2) // 8)


def frames_needed(max_len: int, max_errors: int) -> int:
    """K10's frame stack per root: a path has at most max_len +
    max_errors expanded nodes, one frame at most each."""
    return max_len + max_errors + 2


def _to_int32(values: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit values (uint32 key words) -> int32, same bits."""
    values = values & _MASK32
    return torch.where(values >= 1 << 31, values - (1 << 32), values).to(
        torch.int32
    )


def initial_positions(scheme, seed_class, seeds, searches, num_searches,
                      num_parts):
    """First pattern position of each root (part 0 of its search)."""
    row = scheme[(seed_class[seeds] * num_searches + searches) * num_parts]
    direction = row[:, _S_DIR]
    return row[:, _S_START] * (direction > 0) + (row[:, _S_END] - 1) * (
        direction < 0
    )


def workqueue_search_plain(
    index,
    patterns: torch.Tensor,  # int32 [S, L]
    seed_class: torch.Tensor,  # int32 [S]
    scheme: torch.Tensor,  # int32 [classes * searches * parts, 8]
    num_searches: int,
    num_parts: int,
    quantum: int,
    push_rows: int,
    stack_capacity: int,
    report_capacity: int,
    key_words: int,
    max_iterations: int,
) -> QueueRun:
    """The reference's _workqueue_search in torch ops (on whatever device
    the operands lie), with R1 repaired."""
    from .ops.cuda_fm_index import fm_rank_plain

    device = patterns.device
    num_seeds, L = patterns.shape
    CAP, R, KW = stack_capacity, report_capacity, key_words
    F = _NUM_SCALARS + KW
    n = index.n
    scheme = scheme.to(torch.int64)
    seed_class = seed_class.to(torch.int64)
    patterns = patterns.to(torch.int64)
    C = index.C.to(torch.int64)
    offset = index.rev_block_offset * 128

    init_count = num_seeds * num_searches
    overflow = init_count > CAP
    init_fill = min(init_count, CAP)
    # seed-major, search-minor, reversed so seed 0 / search 0 is on top
    rev = init_count - 1 - torch.arange(init_fill, device=device)
    seed0 = torch.div(rev, num_searches, rounding_mode="floor")
    search0 = rev % num_searches
    stack = torch.zeros((CAP + push_rows, F), dtype=torch.int64,
                        device=device)
    stack[:init_fill, _F_LEN] = n
    stack[:init_fill, _F_POS] = initial_positions(
        scheme, seed_class, seed0, search0, num_searches, num_parts
    )
    stack[:init_fill, _F_OP] = _OP_M
    stack[:init_fill, _F_SEARCH] = search0
    stack[:init_fill, _F_SEED] = seed0
    reports = torch.zeros((R, 6 + KW), dtype=torch.int64, device=device)
    top, num_reports, nodes, iterations = init_fill, 0, 0, 0

    def body(K, P):
        nonlocal stack, top, num_reports, overflow, nodes
        start = max(top - K, 0)
        win = stack[start:start + K]
        present = start + torch.arange(K, device=device) < top
        lb, lb_rev, length, pos, errors, last_op, part_raw, search, seed, \
            depth = (win[:, f] for f in range(_NUM_SCALARS))
        keys = win[:, _NUM_SCALARS:]

        cls = seed_class[seed.clamp(0, num_seeds - 1)]
        part = part_raw.clamp(0, num_parts - 1)
        row = scheme[(cls * num_searches + search) * num_parts + part]
        direction = row[:, _S_DIR]
        at_boundary = torch.where(
            direction > 0, pos >= row[:, _S_END], pos < row[:, _S_START]
        ) & present
        meets_lower = errors >= row[:, _S_LOWER]
        finished = at_boundary & meets_lower & (part_raw == num_parts - 1)
        advancing = at_boundary & meets_lower & ~finished
        next_first = torch.where(row[:, _S_NDIR] > 0, row[:, _S_NSTART],
                                 row[:, _S_NEND] - 1)
        expanding = present & ~at_boundary

        # the two rank gathers of each expanded state
        left = direction < 0
        base = torch.where(left, torch.where(expanding, lb, 0),
                           torch.where(expanding, lb_rev, 0))
        length_m = torch.where(expanding, length, 0)
        if index.rank_rows is not None:
            pos_lo = base + torch.where(left, 0, offset)
            lo = fm_rank_plain(pos_lo, index.rank_rows)
            hi = fm_rank_plain(pos_lo + length_m, index.rank_rows)
        else:
            lo, hi = (
                torch.where(
                    left[:, None],
                    fm_rank_plain(p, None, 0, index.fwd.occ, index.fwd.planes),
                    fm_rank_plain(p, None, 0, index.rev.occ, index.rev.planes),
                )
                for p in (base, base + length_m)
            )
        lo, hi = lo.to(torch.int64), hi.to(torch.int64)
        counts = hi - lo  # [K, SIGMA]
        prefix = torch.cumsum(counts, dim=1) - counts
        primary = C[None, :SIGMA] + lo
        secondary = torch.where(left, lb_rev, lb)[:, None] + prefix
        child_lb = torch.where(left[:, None], primary, secondary)
        child_lb_rev = torch.where(left[:, None], secondary, primary)

        pattern_symbol = patterns[seed.clamp(0, num_seeds - 1),
                                  pos.clamp(0, L - 1)]
        match_symbol = torch.where(
            (pattern_symbol >= 1) & (pattern_symbol < SIGMA),
            pattern_symbol, 0,
        )
        budget_left = errors < row[:, _S_UPPER]

        def at_symbol(table):
            return table.gather(1, match_symbol[:, None])[:, 0]

        # the 13 kinds in host-DFS edge order: the advance (no nibble),
        # match, substitutions, insertions, deletion; [K, 13] each
        zero = torch.zeros_like(lb)
        sym = list(_EDIT_SYMBOLS)
        valid = torch.stack(
            [advancing, expanding & (at_symbol(counts) > 0)]
            + [expanding & budget_left & (pattern_symbol != s)
               & (counts[:, s] > 0) for s in sym]
            + [expanding & budget_left & (counts[:, s] > 0)
               & (last_op != _OP_D) for s in sym]
            + [expanding & budget_left & (last_op != _OP_I)], dim=1,
        )
        num_kinds = valid.shape[1]
        child_fields = {
            "lb": [lb, at_symbol(child_lb)]
            + [child_lb[:, s] for s in sym] * 2 + [lb],
            "lb_rev": [lb_rev, at_symbol(child_lb_rev)]
            + [child_lb_rev[:, s] for s in sym] * 2 + [lb_rev],
            "length": [length, at_symbol(counts)]
            + [counts[:, s] for s in sym] * 2 + [length],
            "pos": [next_first, pos + direction]
            + [pos + direction] * 5 + [pos] * 5 + [pos + direction],
            "errors": [errors, errors] + [errors + 1] * 11,
            "last_op": [last_op] + [zero + _OP_M] * 6 + [zero + _OP_I] * 5
            + [zero + _OP_D],
            "part": [part_raw + 1] + [part_raw] * 12,
        }
        bump = torch.ones(num_kinds, dtype=torch.bool, device=device)
        bump[0] = False

        # expand the deepest rows whose exact child count fits the push
        # block and whose finishers fit the report block; the rest stay
        child_count = valid.sum(dim=1)
        suffix = torch.flip(torch.cumsum(torch.flip(child_count, [0]), 0),
                            [0])
        P_REP = max(K // 4, 256)
        suffix_rep = torch.flip(
            torch.cumsum(torch.flip(finished.long(), [0]), 0), [0]
        )
        take = (suffix <= P) & (suffix_rep <= P_REP) & present
        n_exp = int(take.sum())
        nodes += int((take & expanding).sum())

        # reports: finished states among the expanded rows
        rep_valid = finished & take
        rep_rows = torch.cat(
            [torch.stack([lb, lb_rev, length, errors, seed, search], 1),
             keys], dim=1,
        )[rep_valid]
        n_rep = rep_rows.shape[0]
        kept = max(0, min(n_rep, R - num_reports))
        reports[num_reports:num_reports + kept] = rep_rows[:kept]
        overflow = overflow or num_reports + n_rep > R
        num_reports = min(num_reports + n_rep, R)

        # children: the kind nibble at the parent's depth, row-major order
        valid_k = valid & take[:, None]
        kind = torch.arange(num_kinds, device=device)
        shift = 4 * (7 - depth % 8)
        word = torch.div(depth, 8, rounding_mode="floor")
        child_keys = keys[:, None, :].expand(K, num_kinds, KW).clone()
        for w in range(KW):
            updated = keys[:, w, None] | (kind[None, :] << shift[:, None])
            child_keys[:, :, w] = torch.where(
                (word[:, None] == w) & bump[None, :], updated,
                keys[:, w, None],
            )
        child_depth = depth[:, None] + bump.long()[None, :]
        overflow = overflow or bool(
            ((child_depth >= 8 * KW) & valid_k & bump[None, :]).any()
        )
        fields = torch.stack(
            [torch.stack(child_fields[name], dim=1) for name in
             ("lb", "lb_rev", "length", "pos", "errors", "last_op", "part")]
            + [search[:, None].expand(K, num_kinds),
               seed[:, None].expand(K, num_kinds), child_depth],
            dim=2,
        )  # [K, 13, 10]
        push = torch.cat([fields, child_keys], dim=2)[valid_k]  # [total, F]
        new_top_base = top - n_exp
        stack[new_top_base:new_top_base + push.shape[0]] = push
        top = new_top_base + push.shape[0]
        overflow = overflow or top > CAP

    K_TAIL = min(quantum, 1 << 13)
    P_TAIL = min(push_rows, (push_rows // quantum) * K_TAIL)
    while top > K_TAIL and not overflow and iterations < max_iterations:
        body(quantum, push_rows)
        iterations += 1
    while top > 0 and not overflow and iterations < max_iterations:
        body(K_TAIL, P_TAIL)
        iterations += 1
    # R1 repaired: states left on the stack mean truncated reports
    overflow = overflow or top > 0
    return QueueRun(_to_int32(reports), num_reports, bool(overflow), nodes)


def sort_reports(raw: np.ndarray) -> np.ndarray:
    """Sort report rows [n, 6 + KW] into host-DFS order: seed, then search
    index, then the path-key words compared as uint32 (word 0 most
    significant)."""
    if raw.shape[0] == 0:
        return raw
    kw = raw.shape[1] - 6
    cols = [raw[:, 6 + w].astype(np.uint32) for w in range(kw)]
    # np.lexsort: LAST key is primary
    order = np.lexsort(tuple(reversed(cols)) + (raw[:, 5], raw[:, 4]))
    return raw[order]


def make_runner(device_index, max_errors: int):
    """Adapter with the per-query device search's `runner` signature:
    returns (reports [n, 5] = (lb, lb_rev, length, errors, seed) in
    host-DFS order, num_reports, overflow flags [num_seeds])."""

    def runner(padded, seed_class, tables, _frontier_cap, report_cap,
               _max_iter):
        rows, overflow = workqueue_runner(
            device_index, padded, seed_class, tables, report_cap,
            padded.shape[1], max_errors,
        )
        reports = rows[:, :5].astype(np.int32)
        flags = np.full(padded.shape[0], overflow, dtype=bool)
        return reports, reports.shape[0], flags

    return runner


def workqueue_runner(
    index,
    padded: np.ndarray,
    seed_class: np.ndarray,
    tables,
    report_capacity: int,
    max_len: int,
    max_errors: int,
    budget: int | None = None,
    list_capacity: int | None = None,
):
    """One work-queue search on the index's device: K10 on the card (its
    node budget and work list as given, else the wrapper's defaults), the
    plain version on the CPU. Returns (sorted report rows [n, 6 + KW] in
    host-DFS order, overflow). On overflow it retries once at 4x the
    capacities (K10's work list among them) before the caller concedes
    the seeds to the host redo."""
    from .ops.cuda_search_queue import (
        BUDGET,
        list_entries,
        workqueue_search_cuda,
    )

    global RETRIES
    device = index.device
    num_seeds = padded.shape[0]
    init = num_seeds * tables.num_searches
    K = QUANTUM
    P = PUSH_FACTOR * K
    KW = key_words_needed(max_len, max_errors)
    cap = 2 * init + P + K
    r_cap = report_capacity
    budget = BUDGET if budget is None else budget
    list_cap = list_entries(init) if list_capacity is None else list_capacity
    with tracing.span("search.device.work_queue.upload"):
        patterns = torch.from_numpy(
            np.ascontiguousarray(padded, dtype=np.int32)
        ).to(device)
        classes = torch.from_numpy(
            np.ascontiguousarray(seed_class, dtype=np.int32)
        ).to(device)
        scheme = torch.from_numpy(tables.fused()).to(device)
    for attempt in range(2):
        # the launch reads the counters of its last generation back, so
        # it holds the search's device time
        with tracing.span("search.device.work_queue.launch",
                          seeds=num_seeds, attempt=attempt):
            if device.type == "cuda":
                run = workqueue_search_cuda(
                    index, patterns, classes, scheme, tables.num_searches,
                    tables.num_parts, r_cap, KW,
                    frames_needed(max_len, max_errors), budget, list_cap,
                )
            else:
                run = workqueue_search_plain(
                    index, patterns, classes, scheme, tables.num_searches,
                    tables.num_parts, K, P, cap, r_cap, KW, MAX_ITERATIONS,
                )
        if not run.overflow or attempt:
            break
        RETRIES += 1
        cap *= 4
        r_cap *= 4
        list_cap *= 4
    logger.debug(
        "workqueue search: %d seeds, %d reports, %d nodes, overflow %s",
        num_seeds, run.num_reports, run.nodes, run.overflow,
    )
    with tracing.span("search.device.work_queue.download"):
        raw = run.reports[:run.num_reports].cpu().numpy()
    with tracing.span("search.device.work_queue.sort"):
        return sort_reports(raw), run.overflow
