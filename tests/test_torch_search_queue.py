"""The port's work-queue seed search (floxer_tpu_torch.search_queue) against
the reference's (floxer_tpu.search_queue) on the CPU.

workqueue_search_plain (K10's plain version) must give the reference's
report rows once both are sorted (integer equality, tolerance 0), in the
combined and the planes rank layouts; the port flags the overflow the
reference misses when its iteration bound stops the loop (R1); and
emulate_k10, a numpy mirror of K10's per-root depth-first search
(csrc/workqueue_search.cu: frames, kind masks, the shared-memory key with
its stale nibbles), gives the plain version's rows, so K10's algorithm is
checked before the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from floxer_tpu import search_device as ref_search_device
from floxer_tpu import search_queue as ref_queue
from floxer_tpu.index.device_index import DeviceIndex as RefDeviceIndex
from floxer_tpu.index.fmindex import FmIndex as RefFmIndex
from floxer_tpu.schemes import expand_scheme as ref_expand
from floxer_tpu_torch import search_queue
from floxer_tpu_torch.index.device_index import DeviceIndex
from floxer_tpu_torch.index.fmindex import FmIndex
from floxer_tpu_torch.ops import cuda_search_queue
from floxer_tpu_torch.ops.cuda_fm_index import fm_rank_plain
from floxer_tpu_torch.schemes import expand_scheme
from floxer_tpu_torch.search_device import SchemeTables
from floxer_tpu_torch.search_queue import key_words_needed, sort_reports

CPU = torch.device("cpu")


def _row(seed, search, key_nibbles, kw):
    """Report row with the given DFS path nibbles (depth order)."""
    words = [0] * kw
    for depth, nib in enumerate(key_nibbles):
        words[depth // 8] |= nib << (4 * (7 - depth % 8))
    return [1, 2, 3, 0, seed, search] + words


def _sort_case(name):
    """The reference's sort_reports cases (tests/test_search_queue.py):
    (rows, check of the sorted rows)."""
    if name == "seed_search_key":
        kw = 2
        rows = np.array([
            _row(1, 0, [1, 2], kw), _row(0, 1, [1], kw), _row(0, 0, [2], kw),
            _row(0, 0, [1, 12], kw), _row(0, 0, [1, 3], kw),
        ], dtype=np.int64)

        def check(got):
            order = [(r[4], r[5], tuple(r[6:])) for r in got]
            assert [tuple(r[:2]) for r in order] == [
                (0, 0), (0, 0), (0, 0), (0, 1), (1, 0)
            ]
            keys = [r[2] for r in order[:3]]
            assert keys == sorted(keys)
            assert [r[6] for r in got[:3]] == [
                _row(0, 0, path, kw)[6] for path in ([1, 3], [1, 12], [2])
            ]
        return rows, check
    if name == "high_nibble_not_negative":
        # a kind-12 first edge sets the int32 sign bit; it sorts after 1
        rows = np.array([_row(0, 0, [12], 1), _row(0, 0, [1], 1)],
                        dtype=np.int64)
        rows[:, 6] = rows[:, 6].astype(np.uint32).astype(np.int32)

        def check(got):
            assert got[0][6] == _row(0, 0, [1], 1)[6]
        return rows, check
    rows = np.zeros((0, 7), dtype=np.int64)

    def check(got):
        assert got.shape == (0, 7)
    return rows, check


@pytest.mark.parametrize("case", [
    "seed_search_key", "high_nibble_not_negative", "empty",
    "key_words_needed",
])
def test_sort_reports_and_key_words_match_reference(case):
    """The reference's sort_reports and key_words_needed cases, each on
    both packages."""
    if case == "key_words_needed":
        for max_len, max_errors in ((14, 2), (6, 0), (62, 2), (40, 3),
                                    (112, 3), (1, 0)):
            assert key_words_needed(max_len, max_errors) == (
                ref_queue.key_words_needed(max_len, max_errors)
            )
        assert key_words_needed(14, 2) == 3
        assert key_words_needed(40, 3) * 8 >= 45
        return
    rows, check = _sort_case(case)
    got = sort_reports(rows.copy())
    check(got)
    assert np.array_equal(got, ref_queue.sort_reports(rows.copy()))


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(17)
    sequences = [
        rng.integers(1, 5, size=3000).astype(np.uint8),
        rng.integers(1, 5, size=900).astype(np.uint8),
    ]
    ref = RefFmIndex(sequences)
    port = FmIndex(sequences)
    return (RefDeviceIndex.from_host(ref), DeviceIndex.from_host(port, CPU),
            sequences)


def _mutated(rng, sequences, length, k, count):
    patterns = []
    for trial in range(count):
        source = sequences[trial % 2]
        start = int(rng.integers(0, len(source) - length))
        pattern = source[start:start + length].copy()
        for _ in range(int(rng.integers(0, k + 1))):
            pos = int(rng.integers(0, length))
            pattern[pos] = 1 + (pattern[pos] % 4)
        patterns.append(pattern)
    return patterns


def _chunk(classes_of_patterns, num_rows=None):
    """Padded patterns, class per seed (dead-class padding rows after the
    real seeds) and both packages' tables, from [(errors, pattern)]."""
    pairs = sorted({(k, len(p)) for k, p in classes_of_patterns})
    class_of = [pairs.index((k, len(p))) for k, p in classes_of_patterns]
    pad_len = -(-max(len(p) for _, p in classes_of_patterns) // 8) * 8
    rows = num_rows or len(classes_of_patterns)
    padded = np.zeros((rows, pad_len), dtype=np.int32)
    for i, (_, p) in enumerate(classes_of_patterns):
        padded[i, :len(p)] = p
    ref_tables = ref_search_device.SchemeTables.from_length_classes(
        [ref_expand(k, length) for k, length in pairs]
    )
    tables = SchemeTables.from_length_classes(
        [expand_scheme(k, length) for k, length in pairs]
    )
    seed_class = np.full(rows, tables.dead_class, dtype=np.int32)
    seed_class[:len(class_of)] = class_of
    return padded, seed_class, ref_tables, tables, max(k for k, _ in pairs)


def _cases(name, sequences):
    rng = np.random.default_rng(100 + len(name))
    if name.startswith("k"):
        k = int(name[1])
        length = 14 + 2 * k
        return [(k, p) for p in _mutated(rng, sequences, length, k, 8)]
    if name == "homopolymers":
        return [(1, np.full(8, 2, dtype=np.uint8)),
                (2, np.array([1, 1, 1, 1, 2, 2, 2, 2, 1, 1], dtype=np.uint8)),
                (0, np.full(12, 3, dtype=np.uint8))]
    # mixed error and length classes in one dispatch
    return [(k, p) for k in (0, 1, 2)
            for p in _mutated(rng, sequences, int(rng.integers(10, 22)), k, 4)]


def _port_run(index, padded, seed_class, tables, max_errors,
              max_iterations=None, quantum=256):
    """workqueue_search_plain at the runner's sizing: (sorted rows,
    QueueRun)."""
    kw = key_words_needed(padded.shape[1], max_errors)
    init = padded.shape[0] * tables.num_searches
    push = search_queue.PUSH_FACTOR * quantum
    run = search_queue.workqueue_search_plain(
        index, torch.from_numpy(padded), torch.from_numpy(seed_class),
        torch.from_numpy(tables.fused()), tables.num_searches,
        tables.num_parts, quantum, push,
        2 * init + push + quantum, 1 << 13, kw,
        max_iterations or search_queue.MAX_ITERATIONS,
    )
    rows = run.reports[:run.num_reports].numpy()
    return sort_reports(rows), run


@pytest.mark.parametrize("layout", ["combined", "planes"])
@pytest.mark.parametrize(
    "name", ["k0", "k1", "k2", "k3", "homopolymers", "mixed"]
)
def test_workqueue_plain_matches_reference(indexes, name, layout):
    """The sorted report rows of the port's plain version equal the
    reference's workqueue_runner's, dead-class padding rows included;
    and so do the port's runner's and make_runner's."""
    ref_index, index, sequences = indexes
    if layout == "planes":
        ref_index = dataclasses.replace(ref_index, rank_rows=None)
        index = dataclasses.replace(index, rank_rows=None)
        index.fwd = dataclasses.replace(index.fwd, rank_rows=None)
        index.rev = dataclasses.replace(index.rev, rank_rows=None)
    chunk = _cases(name, sequences)
    padded, seed_class, ref_tables, tables, max_errors = _chunk(
        chunk, num_rows=len(chunk) + 5
    )
    want, want_overflow = ref_queue.workqueue_runner(
        ref_index, padded, seed_class, ref_tables, 1 << 13, padded.shape[1],
        max_errors,
    )
    assert not want_overflow
    got, run = _port_run(index, padded, seed_class, tables, max_errors)
    assert not run.overflow
    assert run.nodes > 0
    assert got.dtype == np.int32 and np.array_equal(got, np.asarray(want))
    rows, overflow = search_queue.workqueue_runner(
        index, padded, seed_class, tables, 1 << 13, padded.shape[1],
        max_errors,
    )
    assert not overflow and np.array_equal(rows, np.asarray(want))
    runner = search_queue.make_runner(index, max_errors)
    reports, count, flags = runner(padded, seed_class, tables, None, 1 << 13,
                                   None)
    assert count == want.shape[0] and not flags.any()
    assert np.array_equal(reports, np.asarray(want)[:, :5])


def test_r1_iteration_bound_sets_overflow(indexes, monkeypatch):
    """R1: stopped by max_iterations with states left on its stack, the
    reference reports no overflow and returns truncated rows; the port
    flags the overflow."""
    ref_index, index, sequences = indexes
    chunk = _cases("k2", sequences)
    padded, seed_class, ref_tables, tables, max_errors = _chunk(chunk)
    full, _ = ref_queue.workqueue_runner(
        ref_index, padded, seed_class, ref_tables, 1 << 13, padded.shape[1],
        max_errors,
    )
    monkeypatch.setenv("FLOXER_TPU_WQ_MAX_ITER", "2")
    truncated, ref_overflow = ref_queue.workqueue_runner(
        ref_index, padded, seed_class, ref_tables, 1 << 13, padded.shape[1],
        max_errors,
    )
    assert not ref_overflow
    assert truncated.shape[0] < full.shape[0]
    got, run = _port_run(index, padded, seed_class, tables, max_errors,
                         max_iterations=2)
    assert run.overflow
    assert np.array_equal(got, np.asarray(truncated))


# ------------------------------------------------------------------ K10


def emulate_k10(index, patterns, seed_class, scheme, num_searches,
                num_parts, report_capacity, key_words, frame_capacity,
                root_order=None, budget=cuda_search_queue.BUDGET,
                list_capacity=None):
    """K10 (csrc/workqueue_search.cu) in numpy, as one thread runs each
    generation: the first over the roots in `root_order` (any order:
    threads take roots from a counter), each later one over the entries
    the one before spilled; a unit of work (a root or an entry) expands
    at most `budget` nodes, the node that reaches the budget joining the
    stack with all its kinds and the stack spilled, bottom frame first,
    to the generation's output list of `list_capacity` entries (a frame,
    its seed and search, the key words up to its depth); an entry
    restores its key prefix into the thread's key and resumes its frame.
    A generation whose list overflows is the last. Returns (report rows
    int32 [k, 6 + KW] in completion order, overflow, nodes, largest tree,
    entries spilled, the most one generation spilled, generations)."""
    C = index.C.numpy().astype(np.int64)
    n = index.n
    patterns = patterns.astype(np.int64)
    L = patterns.shape[1]
    num_roots = patterns.shape[0] * num_searches
    if list_capacity is None:
        list_capacity = cuda_search_queue.list_entries(num_roots)
    keys = [0] * 16  # the thread's shared-memory key, stale nibbles kept
    reports, nodes, overflow = [], 0, False
    work, spilled, peak = [], 0, 0
    root_nodes = np.zeros(num_roots, dtype=np.int64)

    def rank(left, position):
        position = torch.tensor([position], dtype=torch.int32)
        if index.rank_rows is not None:
            offset = 0 if left else index.rev_block_offset
            counts = fm_rank_plain(position, index.rank_rows, offset)
        else:
            single = index.fwd if left else index.rev
            counts = fm_rank_plain(position, None, 0, single.occ,
                                   single.planes)
        return counts[0].numpy().astype(np.int64)

    def descend(node, kind, direction, match_symbol, primary, count):
        nonlocal overflow
        lb, lb_rev, length, pos, err, op, part, depth = node
        if depth + 1 >= 8 * key_words:
            overflow = True
            return None
        shift = 4 * (7 - depth % 8)
        keys[depth // 8] = (keys[depth // 8] & ~(0xF << shift)
                            & 0xFFFFFFFF) | (kind << shift)
        if kind == 12:
            return (lb, lb_rev, length, pos + direction, err + 1, 2, part,
                    depth + 1)
        if kind == 1:
            s, pos, op = match_symbol, pos + direction, 0
        elif kind <= 6:
            s, pos, err, op = kind - 1, pos + direction, err + 1, 0
        else:
            s, err, op = kind - 6, err + 1, 1
        secondary = (lb_rev if direction < 0 else lb) + int(count[:s].sum())
        if direction < 0:
            lb, lb_rev = int(primary[s]), secondary
        else:
            lb, lb_rev = secondary, int(primary[s])
        return (lb, lb_rev, int(count[s]), pos, err, op, part, depth + 1)

    def spill(frames, seed, search):
        nonlocal overflow, spilled
        spilled += len(frames)
        for parent, mask, match_symbol, primary, count in frames:
            if len(work) >= list_capacity:
                overflow = True
                break
            words = (parent[7] + 7) // 8
            work.append(([parent, mask, match_symbol, primary, count], seed,
                         search, keys[:words]))

    # generation 0's units are the roots, each later one's the entries
    units = [(root, None) for root in
             (range(num_roots) if root_order is None else root_order)]
    generations = 0
    while units:
        root, entry = units.pop(0)
        if entry is None:
            seed, search = divmod(root, num_searches)
            frames = []
        else:
            frame, seed, search, key = entry
            keys[:len(key)] = key
            frames = [frame]
        cls = int(seed_class[seed])

        def row_of(part):
            return scheme[(cls * num_searches + search) * num_parts + part]

        node = None
        if not frames:
            row0 = row_of(0)
            first = row0[1] * (row0[0] > 0) + (row0[2] - 1) * (row0[0] < 0)
            node = (0, 0, n, int(first), 0, 0, 0, 0)
        unit_nodes = 0
        while True:
            if node is not None:
                lb, lb_rev, length, pos, err, op, part, depth = node
                row = row_of(part)
                direction = row[0]
                if (pos >= row[2]) if direction > 0 else (pos < row[1]):
                    if err < row[3]:
                        node = None
                    elif part == num_parts - 1:
                        if len(reports) < report_capacity:
                            key = []
                            for w in range(key_words):
                                kept = depth - 8 * w
                                mask = (0xFFFFFFFF if kept >= 8 else 0
                                        if kept <= 0 else
                                        (0xFFFFFFFF << (32 - 4 * kept))
                                        & 0xFFFFFFFF)
                                key.append(keys[w] & mask)
                            reports.append([lb, lb_rev, length, err, seed,
                                            search] + key)
                        else:
                            overflow = True
                        node = None
                    else:
                        nxt = row[6] if row[5] > 0 else row[7] - 1
                        node = (lb, lb_rev, length, int(nxt), err, op,
                                part + 1, depth)
                    continue
                nodes += 1
                unit_nodes += 1
                left = direction < 0
                base = lb if left else lb_rev
                lo = rank(left, base)
                count = rank(left, base + length) - lo
                primary = C[:6] + lo
                symbol = int(patterns[seed, min(max(pos, 0), L - 1)])
                match_symbol = symbol if 1 <= symbol < 6 else 0
                mask = 1 << 1 if count[match_symbol] > 0 else 0
                if err < row[4]:
                    for s in range(1, 6):
                        if symbol != s and count[s] > 0:
                            mask |= 1 << (1 + s)
                        if op != 2 and count[s] > 0:
                            mask |= 1 << (6 + s)
                    if op != 1:
                        mask |= 1 << 12
                spend = unit_nodes >= budget
                if mask == 0:
                    node = None
                else:
                    kind = (mask & -mask).bit_length() - 1
                    if not spend:
                        mask &= mask - 1
                    if mask:
                        if len(frames) >= frame_capacity:
                            overflow = True
                        else:
                            frames.append([node, mask, match_symbol, primary,
                                           count])
                    node = None if spend else descend(
                        node, kind, direction, match_symbol, primary, count)
                if spend:
                    spill(frames, seed, search)
                    break
                continue
            if not frames:
                break
            frame = frames[-1]
            parent, mask, match_symbol, primary, count = frame
            kind = (mask & -mask).bit_length() - 1
            mask &= mask - 1
            if mask:
                frame[1] = mask
            else:
                frames.pop()
            node = descend(parent, kind, row_of(parent[6])[0], match_symbol,
                           primary, count)
        root_nodes[root] += unit_nodes
        if not units:
            # the generation's end: the next one takes its entries
            generations += 1
            peak = max(peak, len(work))
            if not overflow:
                units = [(seed * num_searches + search,
                          (frame, seed, search, key))
                         for frame, seed, search, key in work]
            work = []
    out = np.asarray(reports, dtype=np.int64).reshape(-1, 6 + key_words)
    out[:, 6:] = out[:, 6:].astype(np.uint32).view(np.int32)
    return (out.astype(np.int32), overflow, nodes, int(root_nodes.max()),
            spilled, peak, generations)


# (case, layout, budget, list overflow): the kernel's budget on every
# case (its ids as before), then budgets of 1 and 2 nodes, at which every
# branching node spills, and lists a quarter of the most entries one
# generation spills
K10_MIRROR_CASES = [
    pytest.param(name, layout, None, False, id=f"{name}-{layout}")
    for layout in ("combined", "planes")
    for name in ("k1", "k3", "homopolymers", "mixed")
] + [
    pytest.param("k1", "combined", 1, False, id="k1-combined-budget1"),
    pytest.param("mixed", "planes", 2, False, id="mixed-planes-budget2"),
    pytest.param("homopolymers", "combined", 1, True,
                 id="homopolymers-combined-list-overflow"),
]


@pytest.mark.parametrize("name,layout,budget,list_overflow",
                         K10_MIRROR_CASES)
def test_k10_mirror_matches_plain(indexes, name, layout, budget,
                                  list_overflow):
    """The numpy mirror of K10, its roots in a shuffled order, gives the
    plain version's sorted rows and node count, and the same largest tree
    at every budget (at 1 and 2 nodes every branching node spills, over
    several generations); lists a quarter of the most entries one
    generation spills set overflow, and 4x larger ones, as the runner's
    retry gives them, the full rows; a path deeper than the key holds
    and a report capacity too small each set overflow."""
    _, index, sequences = indexes
    if layout == "planes":
        index = dataclasses.replace(index, rank_rows=None)
        index.fwd = dataclasses.replace(index.fwd, rank_rows=None)
        index.rev = dataclasses.replace(index.rev, rank_rows=None)
    chunk = _cases(name, sequences)
    padded, seed_class, _, tables, max_errors = _chunk(chunk, len(chunk) + 3)
    want, run = _port_run(index, padded, seed_class, tables, max_errors)
    kw = key_words_needed(padded.shape[1], max_errors)
    frames = search_queue.frames_needed(padded.shape[1], max_errors)
    roots = padded.shape[0] * tables.num_searches
    order = np.random.default_rng(5).permutation(roots).tolist()
    scheme = tables.fused()
    args = (index, padded, seed_class, scheme, tables.num_searches,
            tables.num_parts)
    if budget is None:
        got, overflow, nodes, largest = emulate_k10(
            *args, 1 << 13, kw, frames, order,
        )[:4]
        assert not overflow
        assert np.array_equal(sort_reports(got), want)
        assert nodes == run.nodes and 0 < largest <= nodes
        if want.shape[0] > 1:
            overflow = emulate_k10(*args, want.shape[0] - 1, kw, frames)[1]
            assert overflow
        assert emulate_k10(*args, 1 << 13, 1, frames)[1]
        return
    whole = emulate_k10(*args, 1 << 13, kw, frames, order, budget=1 << 20)
    assert whole[4] == 0 and whole[6] == 1 and whole[2] == run.nodes
    got, overflow, nodes, largest, spilled, peak, generations = emulate_k10(
        *args, 1 << 13, kw, frames, order, budget=budget,
    )
    assert generations > 2
    if list_overflow:
        quarter = -(-peak // 4)
        assert emulate_k10(*args, 1 << 13, kw, frames, order, budget=budget,
                           list_capacity=quarter)[1]
        got, overflow, nodes, largest = emulate_k10(
            *args, 1 << 13, kw, frames, order, budget=budget,
            list_capacity=4 * quarter,
        )[:4]
    assert not overflow
    assert np.array_equal(sort_reports(got), want)
    assert (nodes, largest) == (run.nodes, whole[3])
    # every unit expands at most `budget` nodes: the units beyond the
    # roots are spilled entries
    assert nodes <= budget * (roots + spilled)
