"""K13, K13l: the row-sharded FM index's rank and locate.

Counterpart of the XLA programs of the reference's sharded index:
parallel/sharded_index.py's make_sharded_rank_fn (K13; the sharded
branch of index/device_index.py's rank_all) and sharded_locate (K13l;
locate_batch with bwt_at and _sample_lookup over the shards). Each entry
launches its hand-written CUDA kernel (csrc/fm_sharded.cu, over
csrc/fm_rank.cuh) for CUDA tensors and runs its plain PyTorch version for
CPU tensors.

The shards lie on one device, as one stacked table: rows int32 [S, R, 32]
(each shard's combined rank-row table of its real rows, so a shard's
counts are exact and its pad adds nothing), starts and lengths int32 [S].
A global position counts in shard s at clamp(position - start, 0,
length); the shards' counts are summed (the reference's psum over its
index mesh axis), as the plain versions do. The kernels take that sum as
the count of the shard that owns the position plus each symbol's total
over the shards before it (K13 and K11 over the shards: `before` int32
[S, SIGMA], index/device_index.shard_before; K13l: the index's
locate_layout), which equals it bit for bit. The index arguments are
index/device_index.py's ShardedDeviceIndex (duck-typed here).
"""

from __future__ import annotations

import torch

from ..alphabet import SIGMA
from ._build import check_operand, launch
from .cuda_fm_index import fm_rank_plain

# the columns of ShardedDeviceIndex.locate_layout, int32 a shard
# (csrc/fm_rank.cuh's FM_LAYOUT_*), and the SA samples' pad
LAYOUT_COLUMNS = 9
LAYOUT_START, LAYOUT_SAMPLE_FIRST, LAYOUT_SAMPLES, LAYOUT_BEFORE = 0, 1, 2, 3
PAD_ROW = 1 << 30

SOURCE = "floxer_tpu_torch/csrc/fm_sharded.cu"
REPLACES = {
    "K13": "floxer_tpu/parallel/sharded_index.py:93",
    "K13l": "floxer_tpu/parallel/sharded_index.py:346",
}
# kernel launches in this process (read and reset by chip_smoke.py)
RANK_LAUNCHES = 0
LOCATE_LAUNCHES = 0


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def check_shards(rows, starts, lengths, device) -> None:
    """The stacked shard tables: rows int32 [S, R, 32], starts and
    lengths int32 [S]."""
    S = rows.shape[0]
    check_operand(rows, "rank_rows", (S, rows.shape[1], 32), torch.int32,
                  device)
    check_operand(starts, "shard_starts", (S,), torch.int32, device)
    check_operand(lengths, "shard_lengths", (S,), torch.int32, device)


def _require_cuda(tensor) -> None:
    if tensor.device.type != "cuda":
        raise ValueError(f"a CUDA kernel got operands on {tensor.device}")


# ---------------------------------------------------------------- K13 rank


def check_before(before, rows, device) -> None:
    """Each symbol's total over the shards before each: int32 [S, SIGMA]
    (the kernels' operand; the plain versions sum the shards instead)."""
    if before is None:
        raise ValueError("the sharded rank kernel needs shard_before, each "
                         "symbol's total over the shards before each")
    check_operand(before, "shard_before", (rows.shape[0], SIGMA),
                  torch.int32, device)


def fm_sharded_rank(positions, rows, row_offset, starts, lengths,
                    before=None):
    """int32 [B, SIGMA]: the occurrences of each symbol before each global
    position, summed over the shards (positions of the direction whose
    rows start at row_offset in every shard). The kernel for CUDA tensors
    (which reads `before`, the shards' totals), the plain version for CPU
    tensors."""
    check_shards(rows, starts, lengths, positions.device)
    check_operand(positions, "positions", (positions.shape[0],), torch.int32,
                  positions.device)
    if positions.device.type == "cpu":
        return fm_sharded_rank_plain(positions, rows, row_offset, starts,
                                     lengths)
    return fm_sharded_rank_cuda(positions, rows, row_offset, starts, lengths,
                                before)


def fm_sharded_rank_cuda(positions, rows, row_offset, starts, lengths,
                         before=None):
    """K13 on CUDA operands: each position's owner shard ranked, plus
    before[owner]; raises on CPU tensors and without `before`."""
    global RANK_LAUNCHES
    check_shards(rows, starts, lengths, positions.device)
    _require_cuda(positions)
    check_before(before, rows, positions.device)
    B = positions.shape[0]
    out = torch.empty((B, SIGMA), dtype=torch.int32, device=positions.device)
    if B == 0:
        return out
    with torch.cuda.device(positions.device):
        launch(
            "floxer_fm_sharded_rank", rows.data_ptr(), rows.shape[1],
            int(row_offset), starts.data_ptr(), lengths.data_ptr(),
            before.data_ptr(), rows.shape[0], positions.data_ptr(), B,
            out.data_ptr(),
            _stream(positions.device),
        )
    RANK_LAUNCHES += 1
    return out


def local_positions(positions, start, length):
    """int64 [B]: global positions clamped into one shard's rows."""
    local = positions.to(torch.int64) - start
    return torch.minimum(torch.clamp(local, min=0), length)


def fm_sharded_rank_plain(positions, rows, row_offset, starts, lengths):
    """K13's arithmetic in plain PyTorch: each shard's K9 count at the
    clamped position, summed."""
    counts = torch.zeros((positions.shape[0], SIGMA), dtype=torch.int64,
                         device=positions.device)
    starts, lengths = starts.to(torch.int64), lengths.to(torch.int64)
    for shard in range(rows.shape[0]):
        local = local_positions(positions, starts[shard], lengths[shard])
        counts += fm_rank_plain(local, rows[shard], row_offset).to(
            torch.int64)
    return counts.to(torch.int32)


def sharded_bwt_at_plain(bwt, starts, lengths, rows):
    """int64 [B]: the BWT symbols at global rows, each from the shard that
    owns it (bwt uint8 [S, L]; the other shards add 0)."""
    rows = rows.to(torch.int64)
    symbols = torch.zeros_like(rows)
    for shard in range(bwt.shape[0]):
        start, length = int(starts[shard]), int(lengths[shard])
        owned = (rows >= start) & (rows < start + length)
        local = (rows - start).clamp(0, max(length - 1, 0))
        symbols += torch.where(owned, bwt[shard][local].to(torch.int64), 0)
    return symbols


def sharded_sample_lookup_plain(sampled_rows, sampled_values, rows):
    """(hit bool [B], sampled text position int64 [B], 0 where no hit):
    every shard searches its own chunk (int32 [S, ns], sorted, padded
    with 1 << 30), and the hits and values are summed."""
    rows = rows.to(torch.int64)
    hits = torch.zeros_like(rows)
    values = torch.zeros_like(rows)
    for shard in range(sampled_rows.shape[0]):
        chunk = sampled_rows[shard].to(torch.int64)
        at = torch.searchsorted(chunk, rows).clamp(max=chunk.shape[0] - 1)
        hit = chunk[at] == rows
        hits += hit.to(torch.int64)
        values += torch.where(
            hit, sampled_values[shard].to(torch.int64)[at], 0)
    return hits > 0, values


# -------------------------------------------------------------- K13l locate


def _check_locate(index, rows):
    device = rows.device
    fwd = index.fwd
    check_shards(fwd.rank_rows, fwd.shard_starts, fwd.shard_lengths, device)
    S = fwd.rank_rows.shape[0]
    check_operand(fwd.bwt, "bwt", (S, fwd.bwt.shape[1]), torch.uint8, device)
    check_operand(index.C, "C", (SIGMA + 1,), torch.int32, device)
    ns = index.sampled_rows.shape[1]
    for tensor, name in ((index.sampled_rows, "sampled_rows"),
                         (index.sampled_values, "sampled_values")):
        check_operand(tensor, name, (S, ns), torch.int32, device)
    check_operand(index.seq_starts, "seq_starts",
                  (index.seq_starts.shape[0],), torch.int32, device)
    check_operand(index.locate_layout, "locate_layout",
                  (S, LAYOUT_COLUMNS), torch.int32, device)
    check_operand(rows, "rows", (rows.shape[0],), torch.int32, device)


def fm_sharded_locate(index, rows, sampling_rate: int):
    """SA rows -> (reference ids, positions in the reference), int32 [B],
    over the shards: at most sampling_rate - 1 LF steps to a sampled row,
    then the sequence search."""
    _check_locate(index, rows)
    if rows.device.type == "cpu":
        return fm_sharded_locate_plain(index, rows, sampling_rate)
    return fm_sharded_locate_cuda(index, rows, sampling_rate)


def fm_sharded_locate_cuda(index, rows, sampling_rate: int):
    """K13l on CUDA operands (the walk resolves each row's owner through
    index.locate_layout); raises on CPU tensors."""
    global LOCATE_LAUNCHES
    _check_locate(index, rows)
    _require_cuda(rows)
    fwd = index.fwd
    B = rows.shape[0]
    seq_ids = torch.empty(B, dtype=torch.int32, device=rows.device)
    positions = torch.empty(B, dtype=torch.int32, device=rows.device)
    if B == 0:
        return seq_ids, positions
    with torch.cuda.device(rows.device):
        launch(
            "floxer_fm_sharded_locate", fwd.rank_rows.data_ptr(),
            fwd.rank_rows.shape[1], fwd.rank_rows.shape[0],
            fwd.bwt.data_ptr(), fwd.bwt.shape[1], index.C.data_ptr(),
            index.sampled_rows.data_ptr(), index.sampled_values.data_ptr(),
            index.sampled_rows.shape[1], index.seq_starts.data_ptr(),
            index.seq_starts.shape[0], int(sampling_rate),
            index.locate_layout.data_ptr(), rows.data_ptr(), B,
            seq_ids.data_ptr(), positions.data_ptr(), _stream(rows.device),
        )
    LOCATE_LAUNCHES += 1
    return seq_ids, positions


def fm_sharded_locate_plain(index, rows, sampling_rate: int):
    """K13l's walk in plain PyTorch: the reference's fixed-trip loop over
    the batch, its symbol, rank and sample lookups over the shards."""
    fwd = index.fwd
    C = index.C.to(torch.int64)
    current = rows.to(torch.int64)
    steps = torch.zeros_like(current)
    done = torch.zeros(current.shape, dtype=torch.bool, device=rows.device)
    for _ in range(sampling_rate):
        hit, value = sharded_sample_lookup_plain(
            index.sampled_rows, index.sampled_values, current)
        steps = torch.where(hit & ~done, steps + value, steps)
        symbols = sharded_bwt_at_plain(fwd.bwt, fwd.shard_starts,
                                       fwd.shard_lengths, current)
        counts = fm_sharded_rank_plain(current, fwd.rank_rows, 0,
                                       fwd.shard_starts, fwd.shard_lengths)
        lf = C[symbols] + counts.to(torch.int64).gather(
            1, symbols[:, None])[:, 0]
        moving = ~(hit | done)
        current = torch.where(moving, lf, current)
        steps = torch.where(moving, steps + 1, steps)
        done = done | hit
    starts = index.seq_starts.to(torch.int64)
    seq = torch.searchsorted(starts, steps, right=True) - 1
    positions = steps - starts[seq]
    return seq.to(torch.int32), positions.to(torch.int32)

