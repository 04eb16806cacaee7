"""On-device banded CIGAR traceback for accepted PEX roots (K4).

Counterpart of floxer_tpu/ops/traceback_device.py. For each accepted root
the device recomputes the |j - i - (end_col - m)| <= distance band around
the optimal path's diagonal, records a 2-bit direction code per cell (the
move the host walk takes there, ties I, then diagonal, then D) and walks
the codes back from (m, end_col). The host receives (begin, walk ops) and
only run-length encodes them. The result is byte-identical to
dp_reference.banded_cigar_traceback, the host pool's traceback.

A batch is ragged: `pack_batch` concatenates the tasks' windows and
patterns (uint8 rank chars) and writes one table row per task (TABLE
columns: the offsets of its window, pattern, direction codes and ops, its
own n, m, end_col and distance, and its layout: the band cells a thread
holds and whether they live in registers or in shared memory), so one
launch of the CUDA kernel (csrc/traceback_banded.cu) holds every task of
a call that fits DIRS_BUDGET_BYTES of codes, each at its own band
geometry and layout. `banded_traceback` launches it for CUDA tensors and
runs `banded_traceback_plain` for CPU tensors: an adapter that pads the
tasks for `banded_directions_and_walk_plain`, a PyTorch loop over rows
with torch.cummin for the horizontal min-plus scan.

Against the reference: the reference buckets tasks by (m_pad, w_pad,
n_pad) quanta in fixed batches of 8; here a launch holds every task of
the call up to DIRS_BUDGET_BYTES of codes, unpadded. Results do not depend
on the batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ._build import check_operand, launch

SOURCE = "floxer_tpu_torch/csrc/traceback_banded.cu"
REPLACES = "floxer_tpu/ops/traceback_device.py:46"
# kernel launches in this process, and by layout the launches that ran
# blocks in it ('reg8', 'reg16', 'shared64', ...; read and reset by
# chip_smoke.py)
LAUNCHES = 0
LAYOUT_LAUNCHES: dict[str, int] = {}

BIG = 1 << 20

# direction codes (2 bits): the walk's move at a band cell
DIR_I = 0  # vertical: consume a pattern char (insertion vs reference)
DIR_EQ = 1  # diagonal match
DIR_X = 2  # diagonal substitution
DIR_D = 3  # horizontal: consume a reference char (deletion vs pattern)

_OP_CHARS = {DIR_I: "I", DIR_EQ: "=", DIR_X: "X", DIR_D: "D"}

# the task table's columns (int64, one row per task)
TABLE = ("win_off", "n", "pat_off", "m", "end_col", "distance",
         "dirs_off", "ops_off", "cells", "shared_row")
(WIN_OFF, N_LEN, PAT_OFF, M_LEN, END_COL, DISTANCE, DIRS_OFF, OPS_OFF,
 CELLS, SHARED_ROW) = range(10)

# direction-code bytes one launch may hold on the device
DIRS_BUDGET_BYTES = 4 << 30
# a task's layout by its band width: a lane holds 8 cells in registers up
# to 4096 band cells, 16 up to 8192, 32 up to 16384 (16 warps, the
# block's most); wider bands hold 64, 96 or 128 cells a thread in shared
# memory, up to MAX_WIDTH cells (the widest band the earlier kernel took
# at its 256-cell quantum)
REGISTER_WIDTHS = ((8, 4096), (16, 8192), (32, 16384))
SHARED_CELLS = (64, 96, 128)
MAX_THREADS = 512
MAX_WIDTH = 57856
SHARED_BYTES = 232448
# int32 exchange slots ahead of the shared-memory row, and the walk's tile
EXCHANGE_INTS = 128
TILE_INTS = 32 * 32
# each window starts at a multiple of WINDOW_ALIGN bytes, and the buffer
# ends in WINDOW_TAIL zero bytes: the shared-row layouts read a window's
# chars as aligned 32-bit words, up to 4 bytes past its end
WINDOW_ALIGN = 4
WINDOW_TAIL = 16


@dataclass(frozen=True)
class Layout:
    """Cells a thread owns and where their dp values live, for one task."""

    cells: int
    shared_row: bool

    def warps(self, width: int) -> int:
        return -(-width // (32 * self.cells))

    def row_words(self, width: int) -> int:
        """32-bit words of direction codes a row of a task of this band
        width takes (every lane of its warps writes its cells)."""
        return self.warps(width) * 32 * self.cells // 16

    def stored(self, width: int) -> int:
        """Cells of the shared-memory row: those of the threads that hold
        band cells (0 in registers)."""
        return -(-width // self.cells) * self.cells if self.shared_row else 0

    def check(self, width: int) -> None:
        """Raise unless the kernel has this layout and it fits a block."""
        cells = (SHARED_CELLS if self.shared_row
                 else tuple(c for c, _ in REGISTER_WIDTHS))
        if self.cells not in cells:
            raise ValueError(f"K4 has no layout {self}")
        if 32 * self.warps(width) > MAX_THREADS:
            raise ValueError(
                f"K4 needs {32 * self.warps(width)} threads for {width} "
                f"cells in {self}"
            )
        if 4 * (EXCHANGE_INTS + max(self.stored(width), TILE_INTS)) > (
            SHARED_BYTES
        ):
            raise ValueError(
                f"K4's shared-memory row of {self.stored(width)} cells does "
                f"not fit"
            )


def band_width(distance: int) -> int:
    return 2 * max(int(distance), 0) + 1


def choose_layout(width: int) -> Layout:
    """The layout a task whose band is `width` cells takes."""
    for cells, widest in REGISTER_WIDTHS:
        if width <= widest:
            return Layout(cells, False)
    if width > MAX_WIDTH:
        raise ValueError(
            f"K4 takes bands of at most {MAX_WIDTH} cells, got {width}"
        )
    return Layout(32 * -(-width // (32 * MAX_THREADS)), True)


@dataclass
class Batch:
    """A packed batch: host arrays and the launch geometry."""

    windows: np.ndarray  # uint8, each window at its WIN_OFF
    patterns: np.ndarray  # uint8 [sum m]
    table: np.ndarray  # int64 [T, len(TABLE)]
    threads: int  # the block: 32 x the most warps a task takes
    stored: int  # the most shared-row cells a task keeps (0: none)
    dirs_words: int
    ops_total: int

    def layouts(self) -> dict[str, int]:
        """Tasks per layout, as 'reg8', 'reg16', 'shared64', ..."""
        names = [("shared" if shared else "reg") + str(int(cells))
                 for cells, shared in self.table[:, [CELLS, SHARED_ROW]]]
        return {name: names.count(name) for name in sorted(set(names))}


def dirs_bytes(tasks) -> int:
    """Direction-code bytes a launch of these tasks holds."""
    total = 0
    for task in tasks:
        width = band_width(task[3])
        total += 4 * len(task[1]) * choose_layout(width).row_words(width)
    return total


def pack_batch(tasks, layout: Layout | None = None) -> Batch:
    """Concatenate (reference_window, pattern, end_col, distance) tasks
    (each window at a multiple of WINDOW_ALIGN bytes) and lay out their
    codes and ops at prefix-sum offsets, each task in the layout its band
    width picks (`layout`: every task in that one, for tests)."""
    T = len(tasks)
    widths = [band_width(task[3]) for task in tasks]
    layouts = [layout or choose_layout(w) for w in widths]
    for chosen, width in zip(layouts, widths):
        chosen.check(width)
    widths = np.array(widths, dtype=np.int64)
    n = np.array([len(task[0]) for task in tasks], dtype=np.int64)
    m = np.array([len(task[1]) for task in tasks], dtype=np.int64)
    rows = np.array([lay.row_words(int(w)) for lay, w in zip(layouts, widths)],
                    dtype=np.int64)
    table = np.zeros((T, len(TABLE)), dtype=np.int64)
    window_slots = -(-n // WINDOW_ALIGN) * WINDOW_ALIGN
    for column, sizes in ((WIN_OFF, window_slots), (PAT_OFF, m),
                          (DIRS_OFF, m * rows), (OPS_OFF, m + widths)):
        table[:, column] = np.cumsum(sizes) - sizes
    table[:, N_LEN] = n
    table[:, M_LEN] = m
    table[:, END_COL] = [int(task[2]) for task in tasks]
    table[:, DISTANCE] = [int(task[3]) for task in tasks]
    table[:, CELLS] = [lay.cells for lay in layouts]
    table[:, SHARED_ROW] = [lay.shared_row for lay in layouts]
    windows = np.zeros(int(window_slots.sum()) + WINDOW_TAIL, dtype=np.uint8)
    for task, start, size in zip(tasks, table[:, WIN_OFF], n):
        windows[start : start + size] = task[0]
    return Batch(
        windows=windows,
        patterns=(np.concatenate([np.asarray(task[1]) for task in tasks])
                  .astype(np.uint8, copy=False) if T
                  else np.zeros(0, dtype=np.uint8)),
        table=table,
        threads=32 * max([lay.warps(int(w)) for lay, w in zip(layouts, widths)],
                         default=1),
        stored=max([lay.stored(int(w)) for lay, w in zip(layouts, widths)],
                   default=0),
        dirs_words=int((m * rows).sum()),
        ops_total=int((m + widths).sum()),
    )


def banded_traceback(
    windows: torch.Tensor,  # uint8 [sum n] reference rank chars
    patterns: torch.Tensor,  # uint8 [sum m] pattern rank chars
    table: torch.Tensor,  # int64 [T, len(TABLE)]
    batch: Batch,
    walk: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ops int8 [batch.ops_total]: each task's m + 2 half + 1 slots from
    its OPS_OFF hold -1, then its num_ops walk moves in forward order
    (row 1 first), ending at the last slot; num_ops int32 [T]; begin_cols
    int32 [T]) on the operands' device: K4 for CUDA tensors, the plain
    version for CPU tensors. walk=False stops the kernel after the rows
    and leaves the outputs unwritten (chip_smoke.py times the rows
    alone); the plain version always walks."""
    device = windows.device
    T = batch.table.shape[0]
    for tensor, name, shape, dtype in (
        (windows, "windows", batch.windows.shape, torch.uint8),
        (patterns, "patterns", batch.patterns.shape, torch.uint8),
        (table, "table", batch.table.shape, torch.int64),
    ):
        check_operand(tensor, name, shape, dtype, device)
    if device.type == "cpu":
        return banded_traceback_plain(windows, patterns, table, batch.ops_total)
    global LAUNCHES
    ops = torch.empty(batch.ops_total, dtype=torch.int8, device=device)
    num_ops = torch.empty(T, dtype=torch.int32, device=device)
    begin_cols = torch.empty(T, dtype=torch.int32, device=device)
    if T == 0:
        return ops, num_ops, begin_cols
    dirs = torch.empty(max(batch.dirs_words, 1), dtype=torch.int32,
                       device=device)
    with torch.cuda.device(device):
        launch(
            "floxer_traceback_banded",
            windows.data_ptr(), patterns.data_ptr(), table.data_ptr(), T,
            batch.threads, batch.stored, int(walk), dirs.data_ptr(),
            ops.data_ptr(), num_ops.data_ptr(),
            begin_cols.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    LAUNCHES += 1
    for name in batch.layouts():
        LAYOUT_LAUNCHES[name] = LAYOUT_LAUNCHES.get(name, 0) + 1
    return ops, num_ops, begin_cols


def banded_traceback_plain(windows, patterns, table, ops_total):
    """K4's plain version: the ragged tasks padded into
    banded_directions_and_walk_plain, its outputs back in K4's layout."""
    device = windows.device
    rows = table.cpu().numpy()
    T = rows.shape[0]
    ops = torch.full((ops_total,), -1, dtype=torch.int8, device=device)
    if T == 0:
        return (ops, torch.zeros(0, dtype=torch.int32, device=device),
                torch.zeros(0, dtype=torch.int32, device=device))
    n_pad = max(int(rows[:, N_LEN].max()), 1)
    m_pad = max(int(rows[:, M_LEN].max()), 1)
    w_pad = max(band_width(d) for d in rows[:, DISTANCE])
    padded_windows = torch.zeros((T, n_pad), dtype=torch.int32, device=device)
    padded_patterns = torch.zeros((T, m_pad), dtype=torch.int32, device=device)
    for t, row in enumerate(rows):
        n, m = int(row[N_LEN]), int(row[M_LEN])
        padded_windows[t, :n] = windows[row[WIN_OFF] : row[WIN_OFF] + n]
        padded_patterns[t, :m] = patterns[row[PAT_OFF] : row[PAT_OFF] + m]
    scalars = torch.from_numpy(
        rows[:, [N_LEN, M_LEN, END_COL, DISTANCE]].T.astype(np.int32)
    ).to(device)
    walk_ops, num_ops, begin_cols = banded_directions_and_walk_plain(
        padded_windows, padded_patterns, *scalars,
        m_pad=m_pad, w_pad=w_pad, n_pad=n_pad,
    )
    for t, row in enumerate(rows):
        # the walk's moves (then -1) reversed: -1, then the moves forward
        slots = int(row[M_LEN]) + band_width(row[DISTANCE])
        ops[row[OPS_OFF] : row[OPS_OFF] + slots] = walk_ops[:slots, t].flip(0)
    return ops, num_ops, begin_cols


def banded_directions_and_walk_plain(
    windows, patterns, n_lens, m_lens, end_cols, distances, m_pad, w_pad, n_pad
):
    """The reference's row scan and walk in plain PyTorch: a loop over
    pattern rows (vectorized over tasks and band cells, torch.cummin for
    the horizontal min-plus prefix), then a loop over walk steps. Rows past
    the longest pattern and steps after every walk reached row 0 are
    skipped: the walk never reads the former and the latter emit nothing."""
    T = windows.shape[0]
    device = windows.device
    big = BIG
    m = m_lens.to(torch.int64)
    n = n_lens.to(torch.int64)[:, None]
    center = end_cols.to(torch.int64) - m
    half = torch.clamp(distances.to(torch.int64), min=0)
    width = (2 * half + 1)[:, None]
    d_idx = torch.arange(w_pad, dtype=torch.int64, device=device)[None, :]
    base = (center - half)[:, None]
    wins = windows.to(torch.int64)
    pats = patterns.to(torch.int64)

    cols0 = base + d_idx
    valid0 = (cols0 >= 0) & (cols0 <= n) & (d_idx < width)
    prev = torch.where(valid0, 0, big)
    edge = torch.full((T, 1), big, dtype=torch.int64, device=device)
    rows = int(m.max()) if T else 0
    dirs = torch.empty((T, max(rows, 1), w_pad), dtype=torch.int8, device=device)
    for i in range(1, rows + 1):
        cols = i + base + d_idx
        valid = (cols >= 0) & (cols <= n) & (d_idx < width)
        ref_chars = torch.gather(wins, 1, torch.clamp(cols - 1, 0, n_pad - 1))
        sub = (ref_chars != pats[:, i - 1 : i]).to(torch.int64)
        diag = torch.where(cols >= 1, prev + sub, big)
        up = torch.cat([prev[:, 1:], edge], dim=1) + 1
        best = torch.minimum(diag, up)
        scanned = torch.cummin(torch.where(valid, best, big) - d_idx, dim=1)
        dp = torch.where(valid, torch.minimum(best, scanned.values + d_idx), big)
        code = torch.where(
            dp == up,
            DIR_I,
            torch.where(
                dp == diag, torch.where(sub == 1, DIR_X, DIR_EQ), DIR_D
            ),
        )
        dirs[:, i - 1] = code.to(torch.int8)
        prev = dp

    steps = m_pad + w_pad
    ops = torch.full((steps, T), -1, dtype=torch.int8, device=device)
    dirs_flat = dirs.reshape(T, -1)
    last = m_pad * w_pad - 1
    i = m.clone()
    d = half.clone()
    count = torch.zeros(T, dtype=torch.int64, device=device)
    for step in range(steps):
        active = i > 0
        if not bool(active.any()):
            break
        flat = torch.clamp((i - 1) * w_pad + d, 0, last)
        # rows past the longest pattern are never visited; clamp into the
        # computed rows so the gather stays in bounds
        flat = torch.clamp(flat, max=dirs_flat.shape[1] - 1)
        code = torch.gather(dirs_flat, 1, flat[:, None])[:, 0].to(torch.int64)
        is_i = code == DIR_I
        is_diag = (code == DIR_EQ) | (code == DIR_X)
        i = torch.where(active & (is_i | is_diag), i - 1, i)
        d = torch.where(
            active, d + torch.where(is_i, 1, torch.where(is_diag, 0, -1)), d
        )
        ops[step] = torch.where(active, code, -1).to(torch.int8)
        count = count + active.to(torch.int64)
    begin_cols = (center - half) + d
    return ops, count.to(torch.int32), begin_cols.to(torch.int32)


def _launch_groups(tasks, indices, budget_bytes):
    """Split indices into launches of at most budget_bytes of direction
    codes (halving; a single task always launches)."""
    if len(indices) <= 1 or (
        dirs_bytes([tasks[t] for t in indices]) <= budget_bytes
    ):
        return [indices]
    mid = len(indices) // 2
    return (_launch_groups(tasks, indices[:mid], budget_bytes)
            + _launch_groups(tasks, indices[mid:], budget_bytes))


def banded_cigar_traceback_device_batch(
    tasks: list[tuple[np.ndarray, np.ndarray, int, int]],
    device: torch.device,
    budget_bytes: int = DIRS_BUDGET_BYTES,
) -> list[tuple[int, list[tuple[int, str]]]]:
    """Batched reconstruction of (begin, cigar_rle) per task on `device`.

    tasks: (reference_window, pattern, end_col, distance), the arguments of
    dp_reference.banded_cigar_traceback; returns the same
    (begin, [(count, op_char), ...]) per task, byte-identical. One launch
    holds every task while their codes fit budget_bytes (at least one
    task); the longest tasks (rows x band cells) come first, so their
    blocks start first."""
    device = torch.device(device)
    results: list = [None] * len(tasks)
    order = sorted(range(len(tasks)),
                   key=lambda t: -len(tasks[t][1]) * band_width(tasks[t][3]))
    for group in _launch_groups(tasks, order, budget_bytes):
        batch = pack_batch([tasks[t] for t in group])
        ops, num_ops, begin_cols = banded_traceback(
            torch.from_numpy(batch.windows).to(device),
            torch.from_numpy(batch.patterns).to(device),
            torch.from_numpy(batch.table).to(device),
            batch,
        )
        lengths, codes, bounds = _rle_batch(ops.cpu().numpy(),
                                            batch.table[:, OPS_OFF])
        chars = _OP_CHAR_ARRAY[codes].tolist()
        for s, (t, begin) in enumerate(zip(group, begin_cols.cpu().tolist())):
            a, b = bounds[s], bounds[s + 1]
            results[t] = (begin, list(zip(lengths[a:b], chars[a:b])))
    return results


_OP_CHAR_ARRAY = np.array([_OP_CHARS[code] for code in range(4)], dtype=object)


def _rle_batch(ops: np.ndarray, slot_starts) -> tuple[list, np.ndarray, list]:
    """The runs of a batch's walks at once: (run lengths as ints, their op
    codes, bounds), task s's runs at [bounds[s], bounds[s + 1]). ops is
    K4's ops buffer: task s's slots start at slot_starts[s] and hold -1,
    then its moves forward; runs are cut at every slot start, and the -1
    runs dropped."""
    slot_starts = np.asarray(slot_starts, dtype=np.int64)
    T = slot_starts.shape[0]
    total = ops.shape[0]
    if total == 0:
        return [], np.zeros(0, dtype=np.int64), [0] * (T + 1)
    new_run = np.zeros(total, dtype=bool)
    new_run[0] = True
    new_run[1:] = ops[1:] != ops[:-1]
    new_run[slot_starts[slot_starts < total]] = True
    run_starts = np.flatnonzero(new_run)
    lengths = np.diff(np.append(run_starts, total))
    codes = ops[run_starts]
    moves = codes >= 0
    run_starts, lengths, codes = run_starts[moves], lengths[moves], codes[moves]
    task = np.searchsorted(slot_starts, run_starts, side="right") - 1
    bounds = np.append(0, np.cumsum(np.bincount(task, minlength=T))).tolist()
    return lengths.tolist(), codes.astype(np.int64), bounds
