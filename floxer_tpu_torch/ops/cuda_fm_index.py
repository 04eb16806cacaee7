"""K9, K9x, K9l: the device FM index's rank, extension and locate.

Counterpart of the XLA programs of floxer_tpu/index/device_index.py
(rank_all / rank_rows_lookup, extend_left_all / extend_right_all,
locate_batch). Each entry launches its hand-written CUDA kernel
(csrc/fm_index.cu, over csrc/fm_rank.cuh) for CUDA tensors and runs its
plain PyTorch version for CPU tensors. In the combined layout K9 and K9x
give each lane its own query and copy a warp's 32 rank rows into shared
memory 8 lanes a row, each lane one 16-byte piece; in the planes layout
a group of 8 lanes takes a query. Either way the tables must start on a
16-byte boundary (the CUDA wrappers check it). K9x reads a second row
only for a cursor whose interval ends in another block. Tables are int32
tensors holding the uint32 words; the plain versions widen them to int64 masked to 32
bits, since torch has no uint32 shifts or popcount on the CPU.

The index arguments are index/device_index.py's DeviceIndex and
DeviceSingleIndex (duck-typed here, so this module imports nothing of it).
"""

from __future__ import annotations

import torch

from ..alphabet import SIGMA
from ._build import check_operand, launch
from .myers import MASK32

SOURCE = "floxer_tpu_torch/csrc/fm_index.cu"
REPLACES = {
    "K9": "floxer_tpu/index/device_index.py:260",
    "K9x": "floxer_tpu/index/device_index.py:370",
    "K9l": "floxer_tpu/index/device_index.py:455",
}
OCC_BLOCK = 128
PLANE_WORDS = OCC_BLOCK // 32
# int32 words of a sampled-row plane entry (index/device_index.sample_plane)
SAMPLE_PLANE_WORDS = 8
# kernel launches in this process (read and reset by chip_smoke.py)
RANK_LAUNCHES = 0
EXTEND_LAUNCHES = 0
LOCATE_LAUNCHES = 0


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _pointer(tensor) -> int | None:
    return None if tensor is None else tensor.data_ptr()


def _check_table(rows, occ, planes, device) -> None:
    """One direction's rank operands: the combined int32 [R, 32] table, or
    occ int32 [nb + 1, SIGMA] and planes int32 [nb, SIGMA, 4]."""
    if rows is not None:
        check_operand(rows, "rank_rows", (rows.shape[0], 32), torch.int32,
                      device)
        return
    if occ is None or planes is None:
        raise ValueError("a rank needs the combined table or occ and planes")
    nb = planes.shape[0]
    check_operand(planes, "planes", (nb, SIGMA, PLANE_WORDS), torch.int32,
                  device)
    check_operand(occ, "occ", (nb + 1, SIGMA), torch.int32, device)


def _check_vector(tensor, name, B, device, dtype=torch.int32) -> None:
    check_operand(tensor, name, (B,), dtype, device)


def _require_cuda(tensor) -> None:
    if tensor.device.type != "cuda":
        raise ValueError(f"a CUDA kernel got operands on {tensor.device}")


def _require_pieces(rows, planes) -> None:
    """K9's and K9x's lanes load 16-byte pieces of the rank rows or of the
    plane rows: the table must start on a 16-byte boundary."""
    table = rows if rows is not None else planes
    if table.data_ptr() % 16:
        raise ValueError("the rank table must start on a 16-byte boundary")


# ---------------------------------------------------------------- K9 rank


def fm_rank(positions, rows=None, row_offset=0, occ=None, planes=None):
    """int32 [B, SIGMA]: occurrences of each symbol before each position.
    rows: the combined table (positions of the direction at row_offset);
    else occ and planes of one direction. The kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check_table(rows, occ, planes, positions.device)
    _check_vector(positions, "positions", positions.shape[0], positions.device)
    if positions.device.type == "cpu":
        return fm_rank_plain(positions, rows, row_offset, occ, planes)
    return fm_rank_cuda(positions, rows, row_offset, occ, planes)


def fm_rank_cuda(positions, rows=None, row_offset=0, occ=None, planes=None):
    """K9 on CUDA operands; raises on CPU tensors."""
    global RANK_LAUNCHES
    _check_table(rows, occ, planes, positions.device)
    _require_cuda(positions)
    _require_pieces(rows, planes)
    B = positions.shape[0]
    out = torch.empty((B, SIGMA), dtype=torch.int32, device=positions.device)
    if B == 0:
        return out
    with torch.cuda.device(positions.device):
        launch(
            "floxer_fm_rank", _pointer(rows), _pointer(occ), _pointer(planes),
            int(row_offset), positions.data_ptr(), B, out.data_ptr(),
            _stream(positions.device),
        )
    RANK_LAUNCHES += 1
    return out


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 tensors holding 32-bit values (SWAR)."""
    x = words - ((words >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def word_masks(r: torch.Tensor) -> torch.Tensor:
    """int64 [B, PLANE_WORDS]: word w keeps its lowest clamp(r - 32 w, 0,
    32) bits."""
    w_base = 32 * torch.arange(PLANE_WORDS, dtype=torch.int64,
                               device=r.device)
    below = (r.to(torch.int64)[:, None] - w_base[None, :]).clamp(0, 32)
    return (torch.ones_like(below) << below) - 1


def fm_rank_plain(positions, rows=None, row_offset=0, occ=None, planes=None):
    """K9's arithmetic in plain PyTorch (int64 masked to 32 bits)."""
    p = positions.to(torch.int64)
    if rows is not None:
        p = p + int(row_offset) * OCC_BLOCK
        block = torch.div(p, OCC_BLOCK, rounding_mode="floor")
        gathered = rows[block].to(torch.int64) & MASK32  # [B, 32]
        base = gathered[:, 0:5 * SIGMA:5]  # [B, SIGMA]
        words = torch.stack(
            [gathered[:, 5 * s + 1:5 * s + 1 + PLANE_WORDS]
             for s in range(SIGMA)], dim=1,
        )  # [B, SIGMA, 4]
    else:
        block = torch.div(p, OCC_BLOCK, rounding_mode="floor")
        base = occ[block].to(torch.int64)
        words = planes[block].to(torch.int64) & MASK32
    masks = word_masks(p - block * OCC_BLOCK)
    counts = base + popcount32(words & masks[:, None, :]).sum(dim=2)
    return counts.to(torch.int32)


# ------------------------------------------------------------ K9x extend


def _extend_table(index, left: bool):
    """The rank operands of the direction an extension ranks: the forward
    index for a left extension, the reverse one for a right extension."""
    single = index.fwd if left else index.rev
    return single.rank_rows, single.block_offset, single.occ, single.planes


def _check_extend(index, lb, lb_rev, length, left):
    device = lb.device
    rows, _, occ, planes = _extend_table(index, left)
    _check_table(rows, occ, planes, device)
    check_operand(index.C, "C", (SIGMA + 1,), torch.int32, device)
    B = lb.shape[0]
    for tensor, name in ((lb, "lb"), (lb_rev, "lb_rev"), (length, "length")):
        _check_vector(tensor, name, B, device)


def fm_extend(index, lb, lb_rev, length, left: bool):
    """One bidirectional extension step of [B] cursors by every symbol:
    (lb, lb_rev, length), each int32 [B, SIGMA]. left: prepend (ranks on
    the forward index), else append (ranks on the reverse index)."""
    _check_extend(index, lb, lb_rev, length, left)
    if lb.device.type == "cpu":
        return fm_extend_plain(index, lb, lb_rev, length, left)
    return fm_extend_cuda(index, lb, lb_rev, length, left)


def fm_extend_cuda(index, lb, lb_rev, length, left: bool):
    """K9x on CUDA operands; raises on CPU tensors."""
    global EXTEND_LAUNCHES
    _check_extend(index, lb, lb_rev, length, left)
    _require_cuda(lb)
    rows, offset, occ, planes = _extend_table(index, left)
    _require_pieces(rows, planes)
    B = lb.shape[0]
    outs = [torch.empty((B, SIGMA), dtype=torch.int32, device=lb.device)
            for _ in range(3)]
    if B == 0:
        return tuple(outs)
    with torch.cuda.device(lb.device):
        launch(
            "floxer_fm_extend", _pointer(rows), _pointer(occ),
            _pointer(planes), int(offset), index.C.data_ptr(),
            lb.data_ptr(), lb_rev.data_ptr(), length.data_ptr(), B,
            1 if left else 0, *(t.data_ptr() for t in outs),
            _stream(lb.device),
        )
    EXTEND_LAUNCHES += 1
    return tuple(outs)


def fm_extend_plain(index, lb, lb_rev, length, left: bool):
    """K9x's arithmetic in plain PyTorch."""
    rows, offset, occ, planes = _extend_table(index, left)
    base, secondary = (lb, lb_rev) if left else (lb_rev, lb)
    lo = fm_rank_plain(base, rows, offset, occ, planes).to(torch.int64)
    hi = fm_rank_plain(base + length, rows, offset, occ, planes).to(
        torch.int64
    )
    counts = hi - lo
    prefix = torch.cumsum(counts, dim=1) - counts
    primary = index.C[:SIGMA].to(torch.int64)[None, :] + lo
    secondary = secondary.to(torch.int64)[:, None] + prefix
    new_lb, new_lb_rev = (primary, secondary) if left else (secondary, primary)
    return (new_lb.to(torch.int32), new_lb_rev.to(torch.int32),
            counts.to(torch.int32))


# ------------------------------------------------------------ K9l locate


def _check_locate(index, rows):
    device = rows.device
    fwd = index.fwd
    _check_table(fwd.rank_rows, fwd.occ, fwd.planes, device)
    check_operand(fwd.bwt, "bwt", (fwd.bwt.shape[0],), torch.uint8, device)
    check_operand(index.C, "C", (SIGMA + 1,), torch.int32, device)
    ns = index.sampled_rows.shape[0]
    _check_vector(index.sampled_rows, "sampled_rows", ns, device)
    _check_vector(index.sampled_values, "sampled_values", ns, device)
    _check_vector(index.seq_starts, "seq_starts", index.seq_starts.shape[0],
                  device)
    _check_vector(rows, "rows", rows.shape[0], device)


def fm_locate(index, rows, sampling_rate: int):
    """SA rows -> (reference ids, positions in the reference), int32 [B]:
    at most sampling_rate - 1 LF steps to a sampled row, then the
    sequence search."""
    _check_locate(index, rows)
    if rows.device.type == "cpu":
        return fm_locate_plain(index, rows, sampling_rate)
    return fm_locate_cuda(index, rows, sampling_rate)


def check_sample_plane(index, device) -> None:
    """The sampled-row plane the CUDA locates (K9l, K12) read in place of
    the search over sampled_rows: int32 [n // 128 + 1, 8]; an index
    without one is refused (the card has no search to fall back on)."""
    plane = getattr(index, "sample_plane", None)
    if plane is None:
        raise ValueError("the CUDA locate needs the index's sampled-row "
                         "plane (DeviceIndex.from_host builds it)")
    check_operand(plane, "sample_plane",
                  (index.n // OCC_BLOCK + 1, SAMPLE_PLANE_WORDS),
                  torch.int32, device)


def fm_locate_cuda(index, rows, sampling_rate: int):
    """K9l on CUDA operands (the SA samples through index.sample_plane);
    raises on CPU tensors and on an index without the plane."""
    global LOCATE_LAUNCHES
    _check_locate(index, rows)
    _require_cuda(rows)
    check_sample_plane(index, rows.device)
    fwd = index.fwd
    B = rows.shape[0]
    seq_ids = torch.empty(B, dtype=torch.int32, device=rows.device)
    positions = torch.empty(B, dtype=torch.int32, device=rows.device)
    if B == 0:
        return seq_ids, positions
    with torch.cuda.device(rows.device):
        launch(
            "floxer_fm_locate", _pointer(fwd.rank_rows), fwd.occ.data_ptr(),
            fwd.planes.data_ptr(), fwd.bwt.data_ptr(), index.C.data_ptr(),
            index.sample_plane.data_ptr(), index.sampled_values.data_ptr(),
            index.n, index.seq_starts.data_ptr(),
            index.seq_starts.shape[0], int(sampling_rate), rows.data_ptr(),
            B, seq_ids.data_ptr(), positions.data_ptr(), _stream(rows.device),
        )
    LOCATE_LAUNCHES += 1
    return seq_ids, positions


def fm_locate_plain(index, rows, sampling_rate: int):
    """K9l's walk in plain PyTorch: the reference's fixed-trip loop over
    the batch (rows that hit a sampled row keep their value)."""
    fwd = index.fwd
    sampled = index.sampled_rows.to(torch.int64)
    values = index.sampled_values.to(torch.int64)
    C = index.C.to(torch.int64)
    current = rows.to(torch.int64)
    steps = torch.zeros_like(current)
    done = torch.zeros(current.shape, dtype=torch.bool, device=rows.device)
    for _ in range(sampling_rate):
        at = torch.searchsorted(sampled, current).clamp(max=len(sampled) - 1)
        hit = sampled[at] == current
        steps = torch.where(hit & ~done, steps + values[at], steps)
        symbols = fwd.bwt[current].to(torch.int64)
        counts = fm_rank_plain(current, fwd.rank_rows, 0, fwd.occ, fwd.planes)
        lf = C[symbols] + counts.to(torch.int64).gather(1, symbols[:, None])[:, 0]
        moving = ~(hit | done)
        current = torch.where(moving, lf, current)
        steps = torch.where(moving, steps + 1, steps)
        done = done | hit
    starts = index.seq_starts.to(torch.int64)
    seq = torch.searchsorted(starts, steps, right=True) - 1
    positions = steps - starts[seq]
    return seq.to(torch.int32), positions.to(torch.int32)
