"""On-device banded CIGAR traceback for accepted PEX roots (K4).

Counterpart of floxer_tpu/ops/traceback_device.py. For each accepted root
the device recomputes the |j - i - (end_col - m)| <= distance band around
the optimal path's diagonal, records a 2-bit direction code per cell (the
move the host walk takes there, ties I, then diagonal, then D) and walks
the codes back from (m, end_col). The host receives (begin, walk ops) and
only run-length encodes them. The result is byte-identical to
dp_reference.banded_cigar_traceback, the host pool's traceback.

`banded_directions_and_walk` launches the hand-written CUDA kernel
(csrc/traceback_banded.cu) for CUDA tensors and runs
`banded_directions_and_walk_plain`, a PyTorch loop over rows with
torch.cummin for the horizontal min-plus scan, for CPU tensors.

Against the reference: tasks are bucketed by the same (m_pad, w_pad,
n_pad) quanta, but a launch holds as many tasks as fit DIRS_BUDGET_BYTES
of direction codes (m_pad * w_pad / 4 bytes per task: ~17 MB at the 20 kb
root shape) instead of a fixed batch of 8; results do not depend on the
batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import check_operand, launch

SOURCE = "floxer_tpu_torch/csrc/traceback_banded.cu"
REPLACES = "floxer_tpu/ops/traceback_device.py:46"
# kernel launches in this process (read and reset by chip_smoke.py)
LAUNCHES = 0

BIG = 1 << 20

# direction codes (2 bits): the walk's move at a band cell
DIR_I = 0  # vertical: consume a pattern char (insertion vs reference)
DIR_EQ = 1  # diagonal match
DIR_X = 2  # diagonal substitution
DIR_D = 3  # horizontal: consume a reference char (deletion vs pattern)

_OP_CHARS = {DIR_I: "I", DIR_EQ: "=", DIR_X: "X", DIR_D: "D"}

# direction-code bytes one launch may hold on the device
DIRS_BUDGET_BYTES = 4 << 30
# the kernel keeps one dp row of w_pad int32 (plus 32 scan slots) in the
# 227 KB of shared memory a block may use
MAX_W_PAD = 232448 // 4 - 32


def _dirs_bytes_per_task(m_pad: int, w_pad: int) -> int:
    return m_pad * (-(-w_pad // 4))


def banded_directions_and_walk(
    windows: torch.Tensor,  # int32 [T, n_pad] reference rank chars
    patterns: torch.Tensor,  # int32 [T, m_pad] pattern rank chars
    n_lens: torch.Tensor,  # int32 [T]
    m_lens: torch.Tensor,  # int32 [T]
    end_cols: torch.Tensor,  # int32 [T]
    distances: torch.Tensor,  # int32 [T]
    m_pad: int,
    w_pad: int,
    n_pad: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ops int8 [m_pad + w_pad, T] walk moves in reverse order with -1
    padding, num_ops int32 [T], begin_cols int32 [T]) on the operands'
    device: K4 for CUDA tensors, the plain version for CPU tensors."""
    T = windows.shape[0]
    device = windows.device
    for tensor, name, shape in (
        (windows, "windows", (T, n_pad)),
        (patterns, "patterns", (T, m_pad)),
        (n_lens, "n_lens", (T,)),
        (m_lens, "m_lens", (T,)),
        (end_cols, "end_cols", (T,)),
        (distances, "distances", (T,)),
    ):
        check_operand(tensor, name, shape, torch.int32, device)
    if device.type == "cpu":
        return banded_directions_and_walk_plain(
            windows, patterns, n_lens, m_lens, end_cols, distances,
            m_pad, w_pad, n_pad,
        )
    return _banded_directions_and_walk_cuda(
        windows, patterns, n_lens, m_lens, end_cols, distances,
        m_pad, w_pad, n_pad,
    )


def _banded_directions_and_walk_cuda(
    windows, patterns, n_lens, m_lens, end_cols, distances, m_pad, w_pad, n_pad
):
    global LAUNCHES
    if w_pad > MAX_W_PAD:
        raise ValueError(
            f"K4 holds a band of at most {MAX_W_PAD} cells in shared "
            f"memory, got w_pad={w_pad}"
        )
    T = windows.shape[0]
    device = windows.device
    ops = torch.full((m_pad + w_pad, T), -1, dtype=torch.int8, device=device)
    num_ops = torch.empty(T, dtype=torch.int32, device=device)
    begin_cols = torch.empty(T, dtype=torch.int32, device=device)
    if T == 0:
        return ops, num_ops, begin_cols
    dirs = torch.empty(
        T * _dirs_bytes_per_task(m_pad, w_pad), dtype=torch.uint8, device=device
    )
    with torch.cuda.device(device):
        launch(
            "floxer_traceback_banded",
            windows.data_ptr(), patterns.data_ptr(), n_lens.data_ptr(),
            m_lens.data_ptr(), end_cols.data_ptr(), distances.data_ptr(),
            T, m_pad, w_pad, n_pad, dirs.data_ptr(), ops.data_ptr(),
            num_ops.data_ptr(), begin_cols.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    LAUNCHES += 1
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


def _pad_quantum(value: int, quantum: int) -> int:
    return -(-max(value, 1) // quantum) * quantum


def banded_cigar_traceback_device_batch(
    tasks: list[tuple[np.ndarray, np.ndarray, int, int]],
    device: torch.device,
    m_quantum: int = 2048,
    w_quantum: int = 256,
    budget_bytes: int = DIRS_BUDGET_BYTES,
) -> list[tuple[int, list[tuple[int, str]]]]:
    """Batched reconstruction of (begin, cigar_rle) per task on `device`.

    tasks: (reference_window, pattern, end_col, distance), the arguments of
    dp_reference.banded_cigar_traceback; returns the same
    (begin, [(count, op_char), ...]) per task, byte-identical. A launch
    holds at most budget_bytes of direction codes (at least one task)."""
    device = torch.device(device)
    results: list = [None] * len(tasks)

    buckets: dict[tuple[int, int, int], list[int]] = {}
    for t, (window, pattern, end_col, distance) in enumerate(tasks):
        m_pad = _pad_quantum(len(pattern), m_quantum)
        w_pad = _pad_quantum(2 * max(int(distance), 0) + 1, w_quantum)
        n_pad = _pad_quantum(len(window), m_quantum)
        buckets.setdefault((m_pad, w_pad, n_pad), []).append(t)

    for (m_pad, w_pad, n_pad), idxs in buckets.items():
        batch = max(1, budget_bytes // _dirs_bytes_per_task(m_pad, w_pad))
        for b0 in range(0, len(idxs), batch):
            chunk = idxs[b0 : b0 + batch]
            T = len(chunk)
            windows = np.zeros((T, n_pad), dtype=np.int32)
            patterns = np.zeros((T, m_pad), dtype=np.int32)
            scalars = np.zeros((4, T), dtype=np.int32)
            for s, t in enumerate(chunk):
                window, pattern, end_col, distance = tasks[t]
                windows[s, : len(window)] = window
                patterns[s, : len(pattern)] = pattern
                scalars[:, s] = (len(window), len(pattern), end_col, distance)
            on_device = torch.from_numpy(scalars).to(device)
            ops, num_ops, begin_cols = banded_directions_and_walk(
                torch.from_numpy(windows).to(device),
                torch.from_numpy(patterns).to(device),
                on_device[0], on_device[1], on_device[2], on_device[3],
                m_pad=m_pad, w_pad=w_pad, n_pad=n_pad,
            )
            ops = ops.cpu().numpy()  # [L, T]
            num_ops = num_ops.cpu().numpy()
            begin_cols = begin_cols.cpu().numpy()
            for s, t in enumerate(chunk):
                results[t] = (
                    int(begin_cols[s]),
                    _rle_from_reversed_ops(ops[: int(num_ops[s]), s]),
                )
    return results


def _rle_from_reversed_ops(codes: np.ndarray) -> list[tuple[int, str]]:
    """Walk-order (reversed) op codes -> forward run-length CIGAR list.
    Copied from floxer_tpu/ops/traceback_device.py:_rle_from_reversed_ops."""
    if codes.shape[0] == 0:
        return []
    forward = codes[::-1]
    change = np.flatnonzero(forward[1:] != forward[:-1])
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [forward.shape[0]]])
    return [
        (int(e - s), _OP_CHARS[int(forward[s])])
        for s, e in zip(starts, ends)
    ]
