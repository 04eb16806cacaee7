"""The port's per-query frontier search (floxer_tpu_torch.ops.frontier,
K11's plain version, and search_device.search_seeds_device) against the
reference's (floxer_tpu.search_device._frontier_search and
search_seeds_device, XLA on the CPU) and the host DFS.

frontier_search_plain must give the reference's reports, report count and
overflow flag exactly (integer equality, tolerance 0) at error budgets 0-3,
with the frontier overflowing and the reports overflowing once each, in
the combined and the planes rank layouts; emulate_k11, a numpy mirror of
K11's algorithm (csrc/frontier_search.cu: rounds of THREADS slots, the
block scan's offsets, children in (slot, edge) order, the capacity cut,
the alive flag, the done-row compaction), must give the same, so K11's
algorithm is checked before the card. search_seeds_device must give the
reference's groups, totals, abort flags and overflow, and the host DFS's
groups and totals, with the anchor cap binding and not.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floxer_tpu import search_device as ref_sd
from floxer_tpu.index.device_index import DeviceIndex as RefDeviceIndex
from floxer_tpu.index.fmindex import FmIndex as RefFmIndex
from floxer_tpu.schemes import expand_scheme as ref_expand
from floxer_tpu_torch import search_device
from floxer_tpu_torch.index.device_index import DeviceIndex
from floxer_tpu_torch.index.fmindex import FmIndex
from floxer_tpu_torch.ops import cuda_frontier
from floxer_tpu_torch.ops.cuda_fm_index import fm_extend_plain
from floxer_tpu_torch.ops.frontier import (
    frontier_search_batch,
    frontier_search_plain,
)
from floxer_tpu_torch.schemes import expand_scheme
from floxer_tpu_torch.search_device import SchemeTables
from floxer_tpu_torch.search_host import search_seed_groups

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
_OP_M, _OP_I, _OP_D = 0, 1, 2

# (errors, pattern length, seeds, frontier capacity, report capacity):
# budgets 0-3, then a frontier that overflows and reports that overflow
CASES = {
    "e0": (0, 14, 8, 1 << 10, 256),
    "e1": (1, 16, 8, 1 << 12, 256),
    "e2": (2, 20, 8, 1 << 12, 256),
    "e3": (3, 24, 8, 1 << 13, 1 << 12),
    "frontier_overflow": (2, 20, 8, 64, 256),
    "report_overflow": (1, 16, 8, 1 << 12, 8),
}


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(17)
    sequences = [
        rng.integers(1, 5, size=2000).astype(np.uint8),
        rng.integers(1, 5, size=600).astype(np.uint8),
    ]
    # a repeat, so some seeds have many groups
    sequences[1][100:124] = sequences[0][300:324]
    ref_host = RefFmIndex(sequences)
    host = FmIndex(sequences)
    return {
        "ref": RefDeviceIndex.from_host(ref_host),
        "host": host,
        "combined": DeviceIndex.from_host(host, CPU),
        "planes": DeviceIndex.from_host(host, CPU, force_planes=True),
        "sequences": sequences,
    }


def case_operands(sequences, name):
    """Seeded patterns of a case (every other one mutated once), padded
    with one seed of the dead class as the reference pads a block:
    (padded int32 [S, L], class of each seed)."""
    errors, length, num_seeds, _, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    padded = np.zeros((num_seeds, length), dtype=np.int32)
    for i in range(num_seeds - 1):
        source = sequences[i % len(sequences)]
        start = int(rng.integers(0, len(source) - length))
        pattern = source[start:start + length].copy()
        if i % 2:
            at = int(rng.integers(0, length))
            pattern[at] = 1 + pattern[at] % 4
        padded[i] = pattern
    seed_class = np.zeros(num_seeds, dtype=np.int32)
    seed_class[-1] = 1  # the dead class of a one-class table
    return padded, seed_class


def port_tables(name):
    errors, length = CASES[name][:2]
    return SchemeTables.from_searches(expand_scheme(errors, length))


def max_iterations(name):
    errors, length = CASES[name][:2]
    return length + errors + 2 * port_tables(name).num_parts + 2


@pytest.fixture(scope="module")
def reference(indexes):
    """name -> the reference's _frontier_search on that case (reports,
    count, overflow), one jit a case, each computed once."""
    results = {}

    def run(name):
        if name not in results:
            errors, length, _, capacity, reports = CASES[name]
            padded, seed_class = case_operands(indexes["sequences"], name)
            tables = ref_sd.SchemeTables.from_searches(
                ref_expand(errors, length)
            )
            out = ref_sd._frontier_search(
                indexes["ref"], jnp.asarray(padded), jnp.asarray(seed_class),
                tables.start, tables.end, tables.direction, tables.lower,
                tables.upper, tables.num_searches, tables.num_parts,
                capacity, reports, max_iterations(name),
            )
            results[name] = (np.asarray(out[0]), int(out[1]),
                             np.asarray(out[2]))
        return results[name]

    return run


def emulate_k11(index, patterns, seed_class, scheme, num_searches,
                num_parts, capacity, report_capacity, max_iters,
                threads=cuda_frontier.THREADS, blocks=1, extend=fm_extend_plain,
                record=None):
    """K11 (csrc/frontier_search.cu) in numpy: one frontier on a cluster
    of `blocks` thread blocks of `threads` threads, the frontier
    field-major in two buffers, walked in rounds of blocks x threads
    slots, block r of the cluster taking slots [round + r threads,
    +threads); each block's scan of its threads' child counts gives its
    parents their offsets within the block, and the totals of the blocks
    of lower rank (read across the cluster) place the block after them,
    after the earlier rounds' children; children go out in (slot, edge)
    order while the offset is under the capacity; the alive flag from the
    children written, over the cluster; the done rows compacted in rounds
    the same way. A state's extension is `extend(index, lb, lb_rev,
    length, left=)`, K9x's plain version unless given (the sharded
    index's tests hand it the kernels' own fm_extend_all, built with
    g++). `record`, when given, receives each round as (iteration,
    written before it, the blocks' child totals). Returns (reports int32
    [R, 5], num_reports, overflow, iterations, expanded)."""
    S, L = patterns.shape
    C, R = capacity, report_capacity
    width = blocks * threads
    sym = np.arange(1, 6)
    buffers = [np.zeros((10, C), dtype=np.int64) for _ in range(2)]
    cur, nxt = 0, 1
    init = S * num_searches
    overflow = init > C
    count = min(init, C)
    slots = np.arange(count)
    seed = slots // num_searches
    search = slots % num_searches
    row0 = scheme[(seed_class[seed] * num_searches + search) * num_parts]
    first = row0[:, 1] * (row0[:, 0] > 0) + (row0[:, 2] - 1) * (row0[:, 0] < 0)
    zero = np.zeros(count, dtype=np.int64)
    buffers[cur][:, :count] = np.stack([
        zero, zero, zero + index.n, first, zero, zero + _OP_M, zero, search,
        seed, zero,
    ])

    def cluster_offsets(per_thread, base):
        """Each slot's offset: `base`, the lower ranks' block totals, and
        the slot's exclusive prefix in its own block's scan."""
        rank = np.arange(len(per_thread)) // threads
        totals = np.bincount(rank, weights=per_thread,
                             minlength=blocks).astype(np.int64)
        lower = np.cumsum(totals) - totals
        within = np.zeros_like(per_thread)
        for r in range(blocks):
            mine = per_thread[rank == r]
            within[rank == r] = np.cumsum(mine) - mine
        return base + lower[rank] + within, totals

    alive = count > 0
    iterations = expanded = 0
    while iterations < max_iters and not overflow and alive:
        any_alive = False
        written = 0
        for start in range(0, count, width):
            lb, lb_rev, ln, pos, err, op, part, srch, sd, done = (
                buffers[cur][:, start:min(start + width, count)]
            )
            part_c = np.clip(part, 0, num_parts - 1)
            row = scheme[(seed_class[sd] * num_searches + srch) * num_parts
                         + part_c]
            direction = row[:, 0]
            live = done == 0
            at_boundary = live & np.where(direction > 0, pos >= row[:, 2],
                                          pos < row[:, 1])
            meets = err >= row[:, 3]
            finished = at_boundary & meets & (part == num_parts - 1)
            advancing = at_boundary & meets & ~finished
            next_first = np.where(row[:, 5] > 0, row[:, 6], row[:, 7] - 1)
            expanding = live & ~at_boundary
            expanded += int(expanding.sum())
            left = direction < 0
            child = [np.zeros((len(lb), 6), dtype=np.int64) for _ in range(3)]
            for side in (True, False):
                rows_of = np.flatnonzero(expanding & (left == side))
                if rows_of.size:
                    out = extend(
                        index, *(torch.from_numpy(a[rows_of].astype(np.int32))
                                 for a in (lb, lb_rev, ln)), left=side,
                    )
                    for table, values in zip(child, out):
                        table[rows_of] = values.numpy()
            child_lb, child_lb_rev, counts = child
            symbol = patterns[sd, np.clip(pos, 0, L - 1)]
            ms = np.where((symbol >= 1) & (symbol < 6), symbol, 0)
            at_ms = np.arange(len(lb))
            budget = err < row[:, 4]
            valid = np.column_stack(
                [(done != 0) | finished | advancing,
                 expanding & (counts[at_ms, ms] > 0)]
                + [expanding & budget & (symbol != s) & (counts[:, s] > 0)
                   for s in sym]
                + [expanding & budget & (counts[:, s] > 0) & (op != _OP_D)
                   for s in sym]
                + [expanding & budget & (op != _OP_I)]
            )
            step = pos + direction
            ones = np.ones_like(lb)
            fields = np.stack([np.column_stack(c) for c in (
                [lb, child_lb[at_ms, ms]] + [child_lb[:, s] for s in sym] * 2
                + [lb],
                [lb_rev, child_lb_rev[at_ms, ms]]
                + [child_lb_rev[:, s] for s in sym] * 2 + [lb_rev],
                [ln, counts[at_ms, ms]] + [counts[:, s] for s in sym] * 2
                + [ln],
                [np.where(advancing, next_first, pos), step] + [step] * 5
                + [pos] * 5 + [step],
                [err, err] + [err + 1] * 11,
                [op] + [ones * _OP_M] * 6 + [ones * _OP_I] * 5
                + [ones * _OP_D],
                [np.where(advancing, part + 1, part)] + [part] * 12,
                [srch] * 13, [sd] * 13,
                [((done != 0) | finished).astype(np.int64)] + [ones * 0] * 12,
            )], axis=2)  # [slots, 13, 10]
            per_thread = valid.sum(axis=1)
            offsets, totals = cluster_offsets(per_thread, written)
            if record is not None:
                record.append((iterations, written, totals.tolist()))
            at = offsets[:, None] + np.cumsum(valid, axis=1) - valid
            kept = valid & (at < C)
            buffers[nxt][:, at[kept]] = fields[kept].T
            any_alive |= bool((fields[kept][:, 9] == 0).any())
            written += int(totals.sum())
        overflow = written > C
        count = min(written, C)
        cur, nxt = nxt, cur
        iterations += 1
        alive = any_alive
    reports = np.zeros((R, 5), dtype=np.int32)
    num_done = 0
    for start in range(0, count, width):
        block = buffers[cur][:, start:min(start + width, count)]
        is_done = (block[9] != 0).astype(np.int64)
        at, totals = cluster_offsets(is_done, num_done)
        keep = (is_done > 0) & (at < R)
        reports[at[keep]] = block[[0, 1, 2, 4, 8]][:, keep].T
        num_done += int(totals.sum())
    return (reports, min(num_done, R), overflow or num_done > R, iterations,
            expanded)


def run_port(index, sequences, name):
    """frontier_search_plain on a case: ((reports, count, overflow),
    stats)."""
    _, _, _, capacity, reports = CASES[name]
    tables = port_tables(name)
    padded, seed_class = case_operands(sequences, name)
    stats = {}
    out = frontier_search_plain(
        index, torch.from_numpy(padded), torch.from_numpy(seed_class),
        torch.from_numpy(tables.fused()), tables.num_searches,
        tables.num_parts, capacity, reports, max_iterations(name), stats,
    )
    return out, stats


# (case, layout, cluster geometry: blocks, threads): every case on one
# block of the kernel's threads (their ids as before), then clusters of 2
# blocks of 32 threads: rounds that span both blocks (e2), the frontier's
# capacity cut inside the second block of a round (frontier_overflow),
# the reports' capacity (report_overflow)
EMULATION_CASES = [
    pytest.param(name, layout, (1, cuda_frontier.THREADS),
                 id=f"{name}-{layout}")
    for layout in ("combined", "planes") for name in sorted(CASES)
] + [
    pytest.param(name, "combined", (2, 32), id=f"{name}-combined-cluster2x32")
    for name in ("e2", "frontier_overflow", "report_overflow")
]


@pytest.mark.parametrize("name,layout,geometry", EMULATION_CASES)
def test_plain_and_emulation_match_reference(indexes, reference, name,
                                             layout, geometry):
    """frontier_search_plain and emulate_k11 (on a cluster of `geometry`)
    against the reference's _frontier_search: reports, count and
    overflow, exactly."""
    want_reports, want_count, want_overflow = reference(name)
    index = indexes[layout]
    (reports, count, overflow), stats = run_port(
        index, indexes["sequences"], name
    )
    assert count == want_count
    assert np.array_equal(reports.numpy(), want_reports)
    assert np.array_equal(overflow.numpy(), want_overflow)
    if name == "frontier_overflow":
        assert want_overflow.all() and want_count < 256
    if name == "report_overflow":
        assert want_overflow.all() and want_count == CASES[name][4]
    tables = port_tables(name)
    padded, seed_class = case_operands(indexes["sequences"], name)
    blocks, threads = geometry
    rounds = []
    got = emulate_k11(
        index, padded.astype(np.int64), seed_class.astype(np.int64),
        tables.fused().astype(np.int64), tables.num_searches,
        tables.num_parts, CASES[name][3], CASES[name][4],
        max_iterations(name), threads=threads, blocks=blocks, record=rounds,
    )
    assert np.array_equal(got[0], want_reports)
    assert got[1] == want_count
    assert got[2] == bool(want_overflow[0])
    assert (got[3], got[4]) == (stats["iterations"], stats["expanded"])
    if blocks == 1:
        return
    # the cluster's geometry is exercised: rounds whose children come from
    # both blocks, and for frontier_overflow the capacity cut inside the
    # second block's children
    assert any(totals[0] and totals[1] for _, _, totals in rounds)
    if name == "frontier_overflow":
        capacity = CASES[name][3]
        assert any(written + totals[0] < capacity
                   < written + totals[0] + totals[1]
                   for _, written, totals in rounds)


def test_emulation_rounds_do_not_change_the_result(indexes):
    """The round width (the block's threads and the cluster's blocks)
    only changes how the slots are walked: 32 and 512 slots a round, and
    clusters of 4 blocks of 32 and of 8 and 16 blocks of 512 (every
    iteration in one round), give the same result."""
    name = "e2"
    tables = port_tables(name)
    padded, seed_class = case_operands(indexes["sequences"], name)
    args = (indexes["combined"], padded.astype(np.int64),
            seed_class.astype(np.int64), tables.fused().astype(np.int64),
            tables.num_searches, tables.num_parts, CASES[name][3],
            CASES[name][4], max_iterations(name))
    wide = emulate_k11(*args)
    for threads, blocks in ((32, 1), (32, 4), (512, 8), (512, 16)):
        other = emulate_k11(*args, threads=threads, blocks=blocks)
        assert np.array_equal(other[0], wide[0])
        assert other[1:] == wide[1:]


def test_batch_is_frontier_by_frontier(indexes):
    """frontier_search_batch on CPU operands: each frontier of the batch
    equals its own plain run, with its own flag."""
    index = indexes["combined"]
    name = "e1"
    tables = port_tables(name)
    padded, seed_class = case_operands(indexes["sequences"], name)
    batch_patterns = np.stack([padded, padded[::-1].copy(), padded])
    batch_classes = np.stack([seed_class, seed_class[::-1].copy(),
                              seed_class])
    _, _, _, capacity, reports = CASES[name]
    out = frontier_search_batch(
        index, torch.from_numpy(batch_patterns),
        torch.from_numpy(batch_classes), torch.from_numpy(tables.fused()),
        tables.num_searches, tables.num_parts, capacity, reports,
        max_iterations(name),
    )
    for f in range(3):
        want = frontier_search_plain(
            index, torch.from_numpy(batch_patterns[f]),
            torch.from_numpy(batch_classes[f]),
            torch.from_numpy(tables.fused()), tables.num_searches,
            tables.num_parts, capacity, reports, max_iterations(name),
        )
        assert int(out.num_reports[f]) == want[1]
        assert torch.equal(out.reports[f], want[0])
        assert torch.equal(out.overflow[f], want[2])


@pytest.mark.parametrize("cap", [None, 4])
@pytest.mark.parametrize("errors,length", [(1, 12), (2, 18)])
def test_search_seeds_device_matches_reference_and_host(indexes, errors,
                                                        length, cap):
    """search_seeds_device: the reference's groups, totals, aborts and
    overflow, and the host DFS's groups and totals, with the running-total
    cap binding (4) and not."""
    sequences = indexes["sequences"]
    rng = np.random.default_rng(errors * 100 + length)
    patterns = []
    for i in range(5):
        source = sequences[i % 2]
        start = int(rng.integers(0, len(source) - length))
        pattern = source[start:start + length].copy()
        if i % 2:
            pattern[int(rng.integers(0, length))] = 1 + pattern[0] % 4
        patterns.append(pattern)
    # a pattern from the planted repeat: many groups
    patterns.append(sequences[0][300:300 + length].copy())
    got = search_device.search_seeds_device(
        indexes["combined"], patterns, errors, expand_scheme(errors, length),
        max_total_count=cap,
    )
    want = ref_sd.search_seeds_device(
        indexes["ref"], patterns, errors, ref_expand(errors, length),
        max_total_count=cap,
    )
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, np.asarray(w))
    assert not got[3].any()
    for s, pattern in enumerate(patterns):
        groups, total, aborted = search_seed_groups(
            indexes["host"], pattern, errors,
            (1 << 62) if cap is None else cap,
        )
        assert got[0][s] == [
            (g.cursor.lb, g.cursor.lb_rev, g.cursor.length, g.num_errors)
            for g in groups
        ]
        assert got[1][s] == total and bool(got[2][s]) == aborted
    if cap is not None:
        assert got[2].any(), "the cap never bound"


def test_search_seeds_device_takes_a_runner(indexes):
    """search_seeds_device with the work queue's runner
    (search_queue.make_runner, the adapter the reference's sharded
    searcher's runner has the signature of) gives the frontier's groups,
    totals and aborts."""
    from floxer_tpu_torch.search_queue import make_runner

    sequences = indexes["sequences"]
    patterns = [sequences[0][40:56].copy(), sequences[1][300:316].copy(),
                sequences[0][300:316].copy()]
    patterns[1][3] = 1 + patterns[1][3] % 4
    index = indexes["combined"]
    args = (patterns, 2, expand_scheme(2, 16))
    frontier = search_device.search_seeds_device(index, *args,
                                                 max_total_count=6)
    queue = search_device.search_seeds_device(
        index, *args, runner=make_runner(index, 2), max_total_count=6,
    )
    assert queue[0] == frontier[0]
    for q, f in zip(queue[1:], frontier[1:]):
        assert np.array_equal(q, f)


def test_cuda_wrapper_refuses_cpu_operands(indexes):
    index = indexes["combined"]
    tables = port_tables("e0")
    padded, seed_class = case_operands(indexes["sequences"], "e0")
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_frontier.frontier_search_cuda(
            index, torch.from_numpy(padded[None]),
            torch.from_numpy(seed_class[None]),
            torch.from_numpy(tables.fused()), tables.num_searches,
            tables.num_parts, 1024, 256, 20,
        )


def test_kernel_constants_match_the_source():
    """The wrappers' constants are the kernels': K11's block, slot fields
    and largest cluster (the pick within it), K10's block, key words,
    frame and entry ints and counters."""
    from floxer_tpu_torch.ops import cuda_search_queue

    source = (ROOT / cuda_frontier.SOURCE).read_text()
    threads = re.search(r"constexpr int kThreads = (\d+);", source)
    fields = re.search(r"constexpr int kFields = (\d+);", source)
    cluster = re.search(r"constexpr int kMaxCluster = (\d+);", source)
    assert int(threads.group(1)) == cuda_frontier.THREADS
    assert int(fields.group(1)) == cuda_frontier.FIELDS
    assert int(cluster.group(1)) == cuda_frontier.MAX_CLUSTER
    assert cuda_frontier.PICK_MAX_CLUSTER <= cuda_frontier.MAX_CLUSTER
    source = (ROOT / cuda_search_queue.SOURCE).read_text()
    for name, value in (("kThreads", cuda_search_queue.THREADS),
                        ("kMaxKeyWords", cuda_search_queue.MAX_KEY_WORDS),
                        ("kFrameInts", cuda_search_queue.FRAME_INTS)):
        found = re.search(rf"constexpr int {name} = (\d+);", source)
        assert int(found.group(1)) == value, name
    entry = re.search(r"constexpr int kEntryInts = kFrameInts \+ 2 \+ "
                      r"kMaxKeyWords \+ 2;", source)
    assert entry is not None
    for first, last, count in (
        ("cReports", "kCounters", cuda_search_queue.COUNTERS),
        ("gNextEntry", "kGenerationCounters",
         cuda_search_queue.GENERATION_COUNTERS),
    ):
        found = re.search(rf"enum \{{ ({first}[^}}]*), {last} \}};", source)
        assert len(found.group(1).split(",")) == count, last
    assert cuda_search_queue.ENTRY_INTS == (
        cuda_search_queue.FRAME_INTS + 2 + cuda_search_queue.MAX_KEY_WORDS
        + 2)
