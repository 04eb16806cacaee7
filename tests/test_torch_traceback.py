"""The port's device traceback (floxer_tpu_torch/ops/traceback_device.py)
against floxer_tpu.ops.traceback_device and the host traceback.

On the CPU the K4 wrapper runs its plain PyTorch version. The same seeded
tasks go through the reference's XLA program _banded_directions_and_walk:
walk ops, op counts and begin columns must be identical. The batched entry
must equal dp_reference.banded_cigar_traceback (the host pool's traceback,
native/traceback.cpp) for every task, whatever the batch, and the port's
BatchVerifier with FLOXER_TPU_DEVICE_TRACEBACK=1 on a CPU device must
write the host pool's alignments. `emulate_k4` runs the CUDA kernel's
lane-level algorithm in numpy (its row step with the warp scan, the
exchange of one total and one candidate per warp, the sliding chars, the
packed code words, and the walk from staged tiles); it must equal the
plain version in every layout the kernel has."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floxer_tpu.ops import dp_reference
from floxer_tpu.ops import traceback_device as jax_tb
from floxer_tpu_torch.ops import traceback_device as port_tb
from test_traceback_device import _random_task

CPU = torch.device("cpu")


def fuzz_tasks(seed, count=12):
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(count):
        ref_len = int(rng.integers(40, 200))
        pat_len = int(rng.integers(8, min(ref_len, 90)))
        tasks.append(
            _random_task(rng, ref_len, pat_len, int(rng.integers(0, 6)))
        )
    return tasks


def tie_heavy_tasks():
    """Homopolymers and tandem repeats: many DP ties."""
    rng = np.random.default_rng(99)
    tasks = []
    for unit_len in (1, 2, 3):
        unit = rng.integers(1, 5, size=unit_len).astype(np.uint8)
        window = np.tile(unit, 40 // unit_len + 1)[:40]
        pattern = np.tile(unit, 20 // unit_len + 1)[:20].copy()
        pattern[7] = 1 + (pattern[7] % 4)
        tasks.append(task_for(window, pattern))
    return tasks


def task_for(window, pattern):
    dp = dp_reference.semi_global_dp_matrix(window, pattern)
    end_col = dp_reference._rightmost_argmin(dp[-1])
    return window, pattern, end_col, int(dp[-1, end_col])


def edge_tasks():
    """Distance 0, a band clipped at column 0, a pattern longer than the
    window section (forced I runs)."""
    window = np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2], dtype=np.uint8)
    pattern0 = window[:4].copy()
    pattern0[1] = 1 + (pattern0[1] % 4)
    exact = window[2:7].copy()
    tasks = [task_for(window, exact)]
    tasks[0] = tasks[0][:3] + (0,)
    tasks.append(task_for(window, pattern0))
    tasks.append(
        task_for(window, np.concatenate([window[1:8], np.ones(2, np.uint8)]))
    )
    return tasks


CASES = {
    "fuzz1": (lambda: fuzz_tasks(1), 32, 16),
    "fuzz2": (lambda: fuzz_tasks(2), 32, 16),
    "fuzz3": (lambda: fuzz_tasks(3), 32, 16),
    "ties": (tie_heavy_tasks, 32, 16),
    "edges": (edge_tasks, 8, 8),
}


def pad_quantum(value, quantum):
    return -(-max(value, 1) // quantum) * quantum


def padded_inputs(tasks, m_pad, w_pad, n_pad):
    T = len(tasks)
    windows = np.zeros((T, n_pad), dtype=np.int32)
    patterns = np.zeros((T, m_pad), dtype=np.int32)
    scalars = np.zeros((4, T), dtype=np.int32)
    for s, (window, pattern, end_col, distance) in enumerate(tasks):
        windows[s, : len(window)] = window
        patterns[s, : len(pattern)] = pattern
        scalars[:, s] = (len(window), len(pattern), end_col, distance)
    return windows, patterns, scalars


def run_packed(tasks, layout=None):
    """K4's wrapper on the CPU (its plain version) on a packed batch."""
    batch = port_tb.pack_batch(tasks, layout)
    out = port_tb.banded_traceback(
        torch.from_numpy(batch.windows), torch.from_numpy(batch.patterns),
        torch.from_numpy(batch.table), batch,
    )
    return batch, [t.numpy() for t in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_walk_matches_reference_program(case):
    """Per task: the reference program's walk ops (then its -1 padding),
    reversed into K4's layout (-1, then the moves forward), op count and
    begin column."""
    make, m_quantum, w_quantum = CASES[case]
    tasks = make()
    m_pad = max(pad_quantum(len(t[1]), m_quantum) for t in tasks)
    n_pad = max(pad_quantum(len(t[0]), m_quantum) for t in tasks)
    w_pad = max(pad_quantum(2 * max(t[3], 0) + 1, w_quantum) for t in tasks)
    windows, patterns, scalars = padded_inputs(tasks, m_pad, w_pad, n_pad)
    want_ops, want_num, want_begin = (np.asarray(x) for x in
                                      jax_tb._banded_directions_and_walk(
        jnp.asarray(windows), jnp.asarray(patterns),
        *(jnp.asarray(s) for s in scalars),
        m_pad=m_pad, w_pad=w_pad, n_pad=n_pad,
    ))
    batch, (ops, num_ops, begin_cols) = run_packed(tasks)
    np.testing.assert_array_equal(num_ops, want_num)
    np.testing.assert_array_equal(begin_cols, want_begin)
    for t, task in enumerate(tasks):
        start = batch.table[t, port_tb.OPS_OFF]
        slots = len(task[1]) + port_tb.band_width(task[3])
        np.testing.assert_array_equal(
            ops[start : start + slots], want_ops[:slots, t][::-1]
        )


@pytest.mark.parametrize("budget_bytes", [1, 1 << 30])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_matches_host_traceback(case, budget_bytes):
    """Byte-identical (begin, CIGAR) to the host traceback, one task per
    launch or every task in one."""
    make, _, _ = CASES[case]
    tasks = make()
    got = port_tb.banded_cigar_traceback_device_batch(
        tasks, CPU, budget_bytes=budget_bytes,
    )
    for t, (window, pattern, end_col, distance) in enumerate(tasks):
        want = dp_reference.banded_cigar_traceback(
            window, pattern, end_col, distance
        )
        assert got[t] == want, f"task {t}: {got[t]} != {want}"


def port_rle(reversed_ops, pad=0):
    """The port's run-length CIGAR of one task's walk-order ops: the walk
    reversed into K4's slots (`pad` -1 slots, then the moves forward)."""
    ops = np.concatenate([np.full(pad, -1, np.int8),
                          np.asarray(reversed_ops, np.int8)[::-1]])
    lengths, codes, bounds = port_tb._rle_batch(ops, [0])
    chars = port_tb._OP_CHAR_ARRAY[codes].tolist()
    return list(zip(lengths[bounds[0]:bounds[1]], chars[bounds[0]:bounds[1]]))


@pytest.mark.parametrize("pad", [0, 3])
def test_rle_matches_reference(pad):
    codes = np.array([1, 1, 0, 2, 2, 2, 3, 1], dtype=np.int8)
    assert port_rle(codes, pad) == jax_tb._rle_from_reversed_ops(codes)
    assert port_rle(codes[:0], pad) == []


def test_wrapper_checks_operands():
    batch = port_tb.pack_batch(fuzz_tasks(1, count=2))
    with pytest.raises(ValueError, match="windows"):
        port_tb.banded_traceback(
            torch.from_numpy(batch.windows.astype(np.int32)),
            torch.from_numpy(batch.patterns),
            torch.from_numpy(batch.table), batch,
        )
    with pytest.raises(ValueError, match="table"):
        port_tb.banded_traceback(
            torch.from_numpy(batch.windows), torch.from_numpy(batch.patterns),
            torch.from_numpy(batch.table[:1]), batch,
        )


def test_batch_verifier_device_traceback_end_to_end(monkeypatch):
    """The port's BatchVerifier with FLOXER_TPU_DEVICE_TRACEBACK=1 on a CPU
    device emits the host pool's alignments (begin + CIGAR), and without a
    device it refuses instead of running the tracebacks elsewhere."""
    from floxer_tpu_torch.verify import VerificationKind
    from floxer_tpu_torch.verify_batch import BatchVerifier
    from test_torch_fused import assert_same_alignments, port_workload

    references, items = port_workload(seed=11)

    def run(device):
        verifier = BatchVerifier(
            references,
            kind=VerificationKind.HIERARCHICAL,
            extra_verification_ratio=0.3,
            without_cigar=False,
            use_interval_optimization=True,
            use_device=False,
            device=device,
        )
        out = verifier.process(items)
        assert not verifier._device_tb_tasks
        return out

    monkeypatch.setenv("FLOXER_TPU_DEVICE_TRACEBACK", "0")
    want = run(None)

    calls = {"n": 0, "tasks": 0}
    original = port_tb.banded_cigar_traceback_device_batch

    def counting(tasks, device, **kwargs):
        assert device == CPU
        calls["n"] += 1
        calls["tasks"] += len(tasks)
        return original(tasks, device, **kwargs)

    monkeypatch.setattr(port_tb, "banded_cigar_traceback_device_batch", counting)
    monkeypatch.setenv("FLOXER_TPU_DEVICE_TRACEBACK", "1")
    got = run(CPU)
    assert calls["tasks"] > 0, "device traceback path was never exercised"
    assert_same_alignments(want, got)
    with pytest.raises(ValueError, match="device"):
        run(None)


# -- the CUDA kernel's algorithm, lane by lane, in numpy ---------------------

INF = 0x3FFFFFFF
BIG = port_tb.BIG
TILE_ROWS = TILE_WORDS = 32


def char_at(window, p):
    """The window chars at positions p (0 past either end)."""
    p = np.asarray(p)
    inside = (p >= 0) & (p < len(window))
    return np.where(inside, window[np.clip(p, 0, max(len(window) - 1, 0))]
                    if len(window) else 0, 0)


def emulate_rows(window, pattern, end_col, distance, layout):
    """K4's row loop for one task: lanes of `layout.cells` cells each, a
    warp scan of the lanes' minima, one published total and first-cell
    candidate per warp, lane 31 finishing the next warp's first value
    itself, chars sliding one cell a row; in the shared-row layouts the
    threads past the band's cells hold no dp values (they read BIG).
    Returns the code words [m, row_words]."""
    n, m = len(window), len(pattern)
    half = max(distance, 0)
    width = 2 * half + 1
    base = end_col - m - half
    cells = layout.cells
    warps = layout.warps(width)
    lanes = 32 * warps
    d = np.arange(lanes * cells, dtype=np.int64).reshape(lanes, cells)
    d0 = d[:, 0]
    owners = -(-width // cells) if layout.shared_row else lanes
    owns = np.arange(lanes) < owners

    def valid(col, dd):
        return (col >= 0) & (col <= n) & (dd < width)

    prev = np.where(owns[:, None] & valid(base + d, d), 0, BIG)
    ch = char_at(window, base + d)
    right = np.where(valid(base + d0 + cells, d0 + cells), 0, BIG)
    words = np.zeros((m, lanes * cells // 16), dtype=np.uint32)
    is_last_lane = (np.arange(lanes) % 32) == 31
    for i in range(1, m + 1):
        pc = int(pattern[i - 1])
        col = i + base + d
        prev_right = np.concatenate([prev[:, 1:], right[:, None]], axis=1)
        diag = np.where(col >= 1, prev + (ch != pc), BIG)
        up = prev_right + 1
        best = np.minimum(diag, up)
        ok = valid(col, d)
        t = np.where(ok, best, BIG) - d
        # pass 1: the lane minima, the warp scans and the exchange
        inclusive = np.minimum.accumulate(t.min(axis=1).reshape(warps, 32),
                                          axis=1)
        exclusive = np.concatenate(
            [np.full((warps, 1), INF), inclusive[:, :-1]], axis=1
        )
        slot_min = inclusive[:, 31]
        slot_head = np.where(ok[::32, 0], best[::32, 0], -1)
        earlier = np.array([slot_min[:w].min() if w else INF
                            for w in range(warps)])
        run0 = np.minimum(earlier[:, None], exclusive).reshape(lanes)
        # pass 2: the lane's running prefix, dp, codes
        runs = np.minimum.accumulate(
            np.concatenate([run0[:, None], t], axis=1), axis=1
        )[:, 1:]
        dp = np.where(ok, np.minimum(best, runs + d), BIG)
        # a warp whose cells are all valid (and right of column 0) takes
        # the kernel's step without masks: dp is the running prefix + d
        all_valid = np.repeat(
            (ok & (col >= 1)).reshape(warps, -1).all(axis=1), 32
        )
        dp = np.where(all_valid[:, None], runs + d, dp)
        code = np.where(dp == up, port_tb.DIR_I, np.where(
            dp == diag, np.where(ch != pc, port_tb.DIR_X, port_tb.DIR_EQ),
            port_tb.DIR_D))
        # codes packed per lane: C = 8 lanes pair up into one word, 16
        # cells and more are a word each 16 cells
        packed = (code.astype(np.uint64) << (2 * (d % 16)).astype(np.uint64)).reshape(
            lanes * cells // 16, 16).sum(axis=1)
        words[i - 1] = packed.astype(np.uint32)
        prev = np.where(owns[:, None], dp, BIG)
        # the next row's right values: the next lane's first cell by
        # shuffle; lane 31 from the next warp's candidate and its prefix
        next_head = np.append(slot_head[1:], -1)
        finished = np.where(
            next_head < 0, BIG,
            np.minimum(next_head, runs[31::32, -1] + d0[31::32] + cells),
        )
        shifted = np.append(dp[1:, 0], 0)
        right = np.where(is_last_lane, np.repeat(finished, 32), shifted)
        loaded = char_at(window, i + base + d0 + cells - 1)
        ch = np.concatenate(
            [ch[:, 1:],
             np.where(is_last_lane, loaded, np.append(ch[1:, 0], 0))[:, None]],
            axis=1,
        )
    return words


def emulate_walk(words, m, half, width, base):
    """Warp 0's walk: codes staged in tiles of 32 rows x 32 words around
    the current cell, restaged whenever the path leaves the tile; the ops
    fill the slots from the end (forward order), -1 before them."""
    row_words = words.shape[1] if m else 0
    cap = m + width
    i, d, count = m, half, 0
    r_lo, r_hi, w_lo = 1, 0, 0
    tile = None
    ops = np.full(cap, -1, dtype=np.int8)
    while i > 0 and count < cap and 0 <= d < width:
        r, word = i - 1, d >> 4
        if r < r_lo or r > r_hi or word < w_lo or word >= w_lo + TILE_WORDS:
            r_hi, r_lo = r, max(0, r - (TILE_ROWS - 1))
            w_lo = min(max(word - TILE_WORDS // 2, 0),
                       max(row_words - TILE_WORDS, 0))
            tile = words[r_lo : r_hi + 1, w_lo : w_lo + TILE_WORDS]
        code = int(tile[r - r_lo, word - w_lo] >> (2 * (d & 15))) & 3
        ops[cap - 1 - count] = code
        count += 1
        if code == port_tb.DIR_I:
            i, d = i - 1, d + 1
        elif code == port_tb.DIR_D:
            d -= 1
        else:
            i -= 1
    return ops, count, base + d


def emulate_k4(batch):
    """(ops, num_ops, begin_cols) of K4 on a packed batch, as the kernel
    computes them."""
    ops = np.zeros(batch.ops_total, dtype=np.int8)
    T = batch.table.shape[0]
    num_ops = np.zeros(T, dtype=np.int32)
    begin_cols = np.zeros(T, dtype=np.int32)
    for t, row in enumerate(batch.table):
        n, m = int(row[port_tb.N_LEN]), int(row[port_tb.M_LEN])
        window = batch.windows[row[port_tb.WIN_OFF] :][:n]
        pattern = batch.patterns[row[port_tb.PAT_OFF] :][:m]
        distance, end_col = int(row[port_tb.DISTANCE]), int(row[port_tb.END_COL])
        half = max(distance, 0)
        width = 2 * half + 1
        layout = port_tb.Layout(int(row[port_tb.CELLS]),
                                bool(row[port_tb.SHARED_ROW]))
        words = emulate_rows(window, pattern, end_col, distance, layout)
        assert words.shape[1] == layout.row_words(width)
        assert 32 * layout.warps(width) <= batch.threads
        assert layout.stored(width) <= batch.stored
        walk_ops, num_ops[t], begin_cols[t] = emulate_walk(
            words, m, half, width, end_col - m - half
        )
        ops[row[port_tb.OPS_OFF] :][: m + width] = walk_ops
    return ops, num_ops, begin_cols


def wide_tasks():
    """Bands of 2-4 warps at 8 cells a lane: patterns far from their
    windows (distances ~100-400), one a random pattern."""
    rng = np.random.default_rng(7)
    tasks = [_random_task(rng, 700, 420, 130), _random_task(rng, 500, 300, 90)]
    window = rng.integers(1, 5, size=760).astype(np.uint8)
    tasks.append(task_for(window, rng.integers(1, 5, size=640).astype(np.uint8)))
    return tasks


def right_edge_tasks():
    """A band past the window's right end, one at its left (begin 0), an
    empty pattern and half = 0."""
    rng = np.random.default_rng(3)
    window = rng.integers(1, 5, size=90).astype(np.uint8)
    suffix = window[50:].copy()
    suffix[[3, 11, 20]] = 1 + (suffix[[3, 11, 20]] % 4)
    prefix = np.delete(window[:40], [5, 6])
    exact = window[10:30].copy()
    tasks = [task_for(window, suffix), task_for(window, prefix),
             task_for(window, exact)]
    # the first band reaches past column n, the second's start at column 0
    assert tasks[0][2] + tasks[0][3] > len(window) and tasks[2][3] == 0
    return tasks + [(window, np.zeros(0, dtype=np.uint8), 37, 0)]


EMULATED = {
    **{name: make for name, (make, _, _) in CASES.items()},
    "wide": wide_tasks,
    "right_edge": right_edge_tasks,
    "mixed": lambda: fuzz_tasks(4, count=5) + wide_tasks() + edge_tasks(),
}
LAYOUTS = {
    "reg8": port_tb.Layout(8, False),
    "reg16": port_tb.Layout(16, False),
    "reg32": port_tb.Layout(32, False),
    "shared64": port_tb.Layout(64, True),
    "shared96": port_tb.Layout(96, True),
    "shared128": port_tb.Layout(128, True),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_kernel_matches_plain(case, layout):
    """The kernel's algorithm in every layout (one launch holding every
    task, mixed widths in 'mixed') equals the plain version exactly."""
    tasks = EMULATED[case]()
    batch, want = run_packed(tasks, LAYOUTS[layout])
    got = emulate_k4(batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_emulated_walk_restages_tiles():
    """The 'wide' tasks' walks cross tiles by rows and by words."""
    tasks = wide_tasks()
    batch = port_tb.pack_batch(tasks, LAYOUTS["reg8"])
    assert batch.threads > 32  # more than one warp
    assert max(t[3] for t in tasks) > 16 * TILE_WORDS // 2 // 2
    assert max(len(t[1]) for t in tasks) > 4 * TILE_ROWS


def test_pack_batch_layout_and_offsets():
    """Offsets are prefix sums of the tasks' own sizes (windows rounded up
    to 4 bytes, the buffer ending in zero bytes); a row's codes are
    the words of the task's own warps in its own layout; the block holds
    the task with the most warps."""
    tasks = fuzz_tasks(2, count=6) + wide_tasks()
    batch = port_tb.pack_batch(tasks)
    table = batch.table
    widths = np.array([port_tb.band_width(t[3]) for t in tasks])
    m = np.array([len(t[1]) for t in tasks])
    n = np.array([len(t[0]) for t in tasks])
    np.testing.assert_array_equal(table[:, port_tb.CELLS], 8)
    np.testing.assert_array_equal(table[:, port_tb.SHARED_ROW], 0)
    assert batch.layouts() == {"reg8": len(tasks)}
    rows = -(-widths // 256) * 16
    slots = -(-n // 4) * 4  # windows start at multiples of 4 bytes
    for column, sizes in ((port_tb.WIN_OFF, slots), (port_tb.PAT_OFF, m),
                          (port_tb.DIRS_OFF, m * rows),
                          (port_tb.OPS_OFF, m + widths)):
        np.testing.assert_array_equal(
            table[:, column], np.concatenate([[0], np.cumsum(sizes)[:-1]])
        )
    np.testing.assert_array_equal(table[:, port_tb.M_LEN], m)
    np.testing.assert_array_equal(table[:, port_tb.N_LEN], n)
    assert batch.dirs_words == int((m * rows).sum())
    assert batch.ops_total == int((m + widths).sum())
    assert batch.threads == 32 * int(-(-widths.max() // 256))
    assert batch.stored == 0
    assert len(batch.windows) == slots.sum() + port_tb.WINDOW_TAIL
    for t, task in enumerate(tasks):
        start = table[t, port_tb.WIN_OFF]
        np.testing.assert_array_equal(batch.windows[start : start + n[t]],
                                      task[0])
        assert not batch.windows[start + n[t] : start + slots[t]].any()
    assert port_tb.dirs_bytes(tasks) == 4 * batch.dirs_words


def test_pack_batch_gives_each_task_its_own_layout():
    """A batch that mixes widths packs each task in the layout of its own
    band: a narrow task's code rows are not padded to the widest task's,
    and the block and the shared row follow the task that needs most."""
    rng = np.random.default_rng(5)
    window = rng.integers(1, 5, size=200).astype(np.uint8)
    pattern = window[20:60].copy()
    # (distance -> band width -> layout): reg8, reg16, reg32, shared64,
    # shared128
    distances = (40, 3000, 6000, 9000, 28000)
    tasks = [(window, pattern, 60, dist) for dist in distances]
    batch = port_tb.pack_batch(tasks)
    want = [(8, 0), (16, 0), (32, 0), (64, 1), (128, 1)]
    np.testing.assert_array_equal(
        batch.table[:, [port_tb.CELLS, port_tb.SHARED_ROW]], want
    )
    assert batch.layouts() == {"reg16": 1, "reg32": 1, "reg8": 1,
                               "shared128": 1, "shared64": 1}
    widths = [port_tb.band_width(dist) for dist in distances]
    rows = [port_tb.Layout(c, bool(s)).row_words(w)
            for (c, s), w in zip(want, widths)]
    assert rows == [16, 384, 768, 1152, 3584]
    np.testing.assert_array_equal(
        batch.table[:, port_tb.DIRS_OFF],
        np.concatenate([[0], np.cumsum(np.multiply(rows, len(pattern)))[:-1]]),
    )
    assert batch.threads == 32 * 14  # the 56001-cell band: 128 cells a lane
    assert batch.stored == 128 * -(-56001 // 128)
    assert port_tb.dirs_bytes(tasks) == 4 * batch.dirs_words


@pytest.mark.parametrize("width,layout", [
    (1, (8, False)), (4096, (8, False)), (4097, (16, False)),
    (8192, (16, False)), (8193, (32, False)), (16384, (32, False)),
    (16385, (64, True)), (32768, (64, True)), (32769, (96, True)),
    (49153, (128, True)), (port_tb.MAX_WIDTH, (128, True)),
])
def test_layout_covers_every_width(width, layout):
    """Every band up to MAX_WIDTH cells has a layout whose block and
    shared memory fit the kernel (512 threads) and an H100 (227 KB)."""
    chosen = port_tb.choose_layout(width)
    assert (chosen.cells, chosen.shared_row) == layout
    chosen.check(width)
    assert 32 * chosen.warps(width) <= 512
    if chosen.shared_row:
        stored = -(-width // chosen.cells) * chosen.cells
        assert chosen.stored(width) == stored
        assert 4 * (port_tb.EXCHANGE_INTS + stored) <= port_tb.SHARED_BYTES


def test_layout_refuses_wider_bands():
    with pytest.raises(ValueError, match="at most"):
        port_tb.choose_layout(port_tb.MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="threads"):
        port_tb.pack_batch([(np.zeros(4, np.uint8), np.zeros(2, np.uint8),
                             2, 9000)], port_tb.Layout(8, False))
    with pytest.raises(ValueError, match="no layout"):
        port_tb.pack_batch([(np.zeros(4, np.uint8), np.zeros(2, np.uint8),
                             2, 1)], port_tb.Layout(32, True))


def test_batch_equals_task_by_task():
    """One launch of mixed tasks gives each task's result alone."""
    tasks = EMULATED["mixed"]()
    together = port_tb.banded_cigar_traceback_device_batch(tasks, CPU)
    alone = [port_tb.banded_cigar_traceback_device_batch([t], CPU)[0]
             for t in tasks]
    assert together == alone


def test_budget_splits_launches():
    """A budget below the batch's codes splits it in halves; a single task
    over the budget still launches."""
    tasks = fuzz_tasks(3, count=5)
    one = port_tb._launch_groups(tasks, list(range(5)), 1 << 30)
    assert one == [list(range(5))]
    split = port_tb._launch_groups(tasks, list(range(5)), 1)
    assert split == [[0], [1], [2], [3], [4]]


def reference_codes(window, pattern, end_col, distance):
    """The direction code and the dp value of every band cell, row by row
    as the reference program computes them ([m, W] each)."""
    n, m = len(window), len(pattern)
    half = max(distance, 0)
    width = 2 * half + 1
    d = np.arange(width)
    base = end_col - m - half
    prev = np.where((base + d >= 0) & (base + d <= n), 0, BIG)
    codes = np.zeros((m, width), dtype=np.int64)
    values = np.zeros((m, width), dtype=np.int64)
    for i in range(1, m + 1):
        col = i + base + d
        ok = (col >= 0) & (col <= n)
        sub = (char_at(window, col - 1) != pattern[i - 1]).astype(np.int64)
        diag = np.where(col >= 1, prev + sub, BIG)
        up = np.append(prev[1:], BIG) + 1
        best = np.minimum(diag, up)
        scanned = np.minimum.accumulate(np.where(ok, best, BIG) - d) + d
        dp = np.where(ok, np.minimum(best, scanned), BIG)
        codes[i - 1] = np.where(dp == up, port_tb.DIR_I, np.where(
            dp == diag, np.where(sub == 1, port_tb.DIR_X, port_tb.DIR_EQ),
            port_tb.DIR_D))
        values[i - 1] = dp
        prev = dp
    return codes, values


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", ["wide", "mixed", "right_edge", "ties"])
def test_emulated_codes_match_reference_on_finite_cells(case, layout):
    """Every code the kernel's algorithm writes on a band cell of finite
    value equals the reference's (the walk reads only such cells), across
    lanes, warps and chunks."""
    cells = 0
    for window, pattern, end_col, distance in EMULATED[case]():
        if not len(pattern):
            continue
        width = port_tb.band_width(distance)
        words = emulate_rows(window, pattern, end_col, distance,
                             LAYOUTS[layout])
        d = np.arange(width)
        got = (words[:, d // 16] >> (2 * (d % 16)).astype(np.uint32)) & 3
        want, values = reference_codes(window, pattern, end_col, distance)
        finite = values < BIG
        np.testing.assert_array_equal(got[finite], want[finite])
        cells += int(finite.sum())
    assert cells > 0


def test_bench_tool_root_tasks_are_seeded_and_within_budget():
    """tools/k4_bench's root tasks: the same seed gives the same tasks,
    each within the budget, its (end_col, distance) the DP's own."""
    from floxer_tpu_torch.tools import k4_bench

    def make():
        return k4_bench.root_tasks(np.random.default_rng(4), 6, 300, 0.1, 40)

    tasks, again = make(), make()
    assert 0 < len(tasks) <= 6
    for task, same in zip(tasks, again):
        window, pattern, end_col, distance = task
        assert len(pattern) <= 300 and distance <= 40
        assert (end_col, distance) == task_for(window, pattern)[2:]
        np.testing.assert_array_equal(window, same[0])
        np.testing.assert_array_equal(pattern, same[1])


def test_bench_tool_needs_a_gpu():
    """Without a CUDA device the tool exits non-zero and prints nothing."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(port_tb.__file__).resolve().parent.parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "floxer_tpu_torch.tools.k4_bench",
         "--shapes", "root20k"],
        capture_output=True, text=True, cwd=root, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(root)},
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
