"""Counterpart of floxer_tpu/index/device_index.py: the device-resident FM
index and its batched rank, extension, LF and locate.

The BWT, its occ checkpoints, the bit planes and the SA samples live on
one torch device. A rank query for a batch of positions is a checkpoint
read plus masked popcounts of the block's plane words; on the card it is
K9 (csrc/fm_rank.cuh, launched by ops/cuda_fm_index.py), on the CPU its
plain version. The extension and locate steps are K9x and K9l.

Layout (one direction, as the reference ships it):
  - bwt:    uint8 [n]
  - occ:    int32 [nb + 1, SIGMA] cumulative counts at block boundaries
  - planes: int32 [nb, SIGMA, OCC_BLOCK // 32], uint32 bits: bit j of word
            w in block b is set iff bwt[b * OCC_BLOCK + 32 w + j] == symbol
The combined rank-row table holds both directions in one int32
[nb_fwd + 1 + nb_rev, 32] array: column 5 s is symbol s's checkpoint,
columns 5 s + 1 .. 5 s + 4 its plane words, and the reverse direction
starts at row rev_block_offset, so one 128-byte row answers a rank of
either direction. Past 2^31 combined positions its int32 addressing
would wrap, so the index keeps the per-direction planes layout only.

The sharded index (ShardedSingleIndex, ShardedDeviceIndex) and the dense
rank are not ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..alphabet import SIGMA
from ..ops import cuda_fm_index
from .fmindex import OCC_BLOCK, FmIndex

# int32 words of one rank row: a checkpoint and OCC_BLOCK // 32 plane
# words per symbol, zero padded to 32
RANK_ROW_WORDS = 32
# combined positions (both directions' blocks and the pad row, times
# OCC_BLOCK) from which the combined table would overflow int32
COMBINED_POSITION_LIMIT = 2**31


@dataclass
class DeviceSingleIndex:
    """One direction of the index. rank_rows and block_offset are the
    DeviceIndex's combined table and this direction's first row in it
    (None when the index keeps the planes layout only)."""

    bwt: torch.Tensor  # uint8 [n]
    occ: torch.Tensor  # int32 [nb + 1, SIGMA]
    planes: torch.Tensor  # int32 [nb, SIGMA, OCC_BLOCK // 32]
    rank_rows: torch.Tensor | None = None
    block_offset: int = 0


@dataclass
class DeviceIndex:
    fwd: DeviceSingleIndex
    rev: DeviceSingleIndex
    C: torch.Tensor  # int32 [SIGMA + 1]
    sampled_rows: torch.Tensor  # int32 [ns], sorted
    sampled_values: torch.Tensor  # int32 [ns]
    seq_starts: torch.Tensor  # int32 [num_seqs]
    rank_rows: torch.Tensor | None  # int32 [nb_fwd + 1 + nb_rev, 32]
    rev_block_offset: int
    sampling_rate: int

    @property
    def device(self) -> torch.device:
        return self.C.device

    @property
    def n(self) -> int:
        return self.fwd.bwt.shape[0]

    @classmethod
    def from_host(
        cls, index: FmIndex, device: torch.device, force_planes: bool = False
    ) -> "DeviceIndex":
        """Upload the port's host index to `device`. force_planes keeps
        the per-direction planes layout even where the combined table
        fits (the layout a genome past 2^31 combined positions gets)."""
        fwd_planes = pack_bit_planes(index.fwd.bwt)
        rev_planes = pack_bit_planes(index.rev.bwt)
        rows = None
        rev_block_offset = 0
        if not force_planes and not combined_overflows(fwd_planes, rev_planes):
            rows = rank_row_table(
                index.fwd.occ_checkpoints, fwd_planes,
                index.rev.occ_checkpoints, rev_planes,
            )
            rev_block_offset = fwd_planes.shape[0] + 1
        rank_rows = None if rows is None else _int32_bits(rows, device)

        def single(host, planes, offset):
            return DeviceSingleIndex(
                torch.from_numpy(np.ascontiguousarray(host.bwt)).to(device),
                _int32(host.occ_checkpoints, device),
                _int32_bits(planes, device),
                rank_rows,
                offset,
            )

        return cls(
            fwd=single(index.fwd, fwd_planes, 0),
            rev=single(index.rev, rev_planes, rev_block_offset),
            C=_int32(index.C, device),
            sampled_rows=_int32(index.sampled_rows, device),
            sampled_values=_int32(index.sampled_values, device),
            seq_starts=_int32(index.seq_starts, device),
            rank_rows=rank_rows,
            rev_block_offset=rev_block_offset,
            sampling_rate=index.sampling_rate,
        )


def _int32(array, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(array), dtype=np.int32)
    ).to(device)


def _int32_bits(array: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(array, dtype=np.uint32).view(np.int32)
    ).to(device)


def pack_bit_planes(bwt) -> np.ndarray:
    """Host-side bit-plane packing of a BWT: uint32 [num_blocks, SIGMA,
    OCC_BLOCK // 32], little-endian bit order within each word (bit j of
    word w in block b <=> position b * OCC_BLOCK + 32 * w + j)."""
    n = bwt.shape[0]
    num_blocks = n // OCC_BLOCK + 1
    padded = np.full(num_blocks * OCC_BLOCK, SIGMA, dtype=np.uint8)
    padded[:n] = bwt  # pad symbol SIGMA: set in no plane
    words_per_block = OCC_BLOCK // 32
    planes = np.empty((num_blocks, SIGMA, words_per_block), dtype=np.uint32)
    view = padded.reshape(num_blocks, words_per_block, 32)
    for symbol in range(SIGMA):
        packed = np.packbits(view == symbol, axis=-1, bitorder="little")
        planes[:, symbol, :] = (
            np.ascontiguousarray(packed).view("<u4").reshape(
                num_blocks, words_per_block
            )
        )
    return planes


def combined_overflows(fwd_planes, rev_planes) -> bool:
    """The int32 guard: True when the combined table's positions (both
    directions' blocks and the pad row between them) reach 2^31."""
    rows = fwd_planes.shape[0] + 1 + rev_planes.shape[0]
    return rows * OCC_BLOCK >= COMBINED_POSITION_LIMIT


def rank_row_table(fwd_occ, fwd_planes, rev_occ, rev_planes) -> np.ndarray:
    """uint32 [nb_fwd + 1 + nb_rev, 32]: each direction's flat rows
    (column 5 s the checkpoint of block b, 5 s + 1 .. 5 s + 4 its plane
    words), fwd first, one zero row, then rev. A position in block b reads
    row b for both its checkpoint and its planes."""

    def rows_of(occ, planes):
        nb, _, words = planes.shape
        rows = np.zeros((nb, RANK_ROW_WORDS), dtype=np.uint32)
        for s in range(SIGMA):
            rows[:, 5 * s] = np.asarray(occ)[:nb, s].astype(np.uint32)
            rows[:, 5 * s + 1 : 5 * s + 1 + words] = planes[:, s, :]
        return rows

    fwd_rows = rows_of(fwd_occ, fwd_planes)
    pad = np.zeros_like(fwd_rows[:1])
    return np.concatenate([fwd_rows, pad, rows_of(rev_occ, rev_planes)])


def rank_all(single: DeviceSingleIndex, positions: torch.Tensor) -> torch.Tensor:
    """occ of every symbol before each position: [B] -> int32 [B, SIGMA]
    (K9), through the combined table when the index has one, else through
    this direction's occ and planes."""
    return cuda_fm_index.fm_rank(
        positions.to(torch.int32).contiguous(), single.rank_rows,
        single.block_offset, single.occ, single.planes,
    )


def rank_rows_lookup(rank_rows: torch.Tensor, positions: torch.Tensor):
    """Rank over the combined table: [B] combined positions (reverse ones
    already offset by rev_block_offset * OCC_BLOCK) -> int32 [B, SIGMA]
    (the reference's list of SIGMA vectors, stacked)."""
    return cuda_fm_index.fm_rank(
        positions.to(torch.int32).contiguous(), rank_rows, 0, None, None
    )


def bwt_at(single: DeviceSingleIndex, rows: torch.Tensor) -> torch.Tensor:
    """BWT symbols at rows, as int32."""
    return single.bwt[rows.long()].to(torch.int32)


def rank_symbol(
    single: DeviceSingleIndex, symbol: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """occ(symbol, position) batched: [B], [B] -> int32 [B]."""
    counts = rank_all(single, positions)
    return counts.gather(1, symbol.long()[:, None])[:, 0]


def extend_left_all(index: DeviceIndex, lb, lb_rev, length):
    """All-SIGMA left extension of a batch of bidirectional cursors (K9x):
    [B] -> (lb, lb_rev, length), each int32 [B, SIGMA]."""
    return cuda_fm_index.fm_extend(index, lb, lb_rev, length, left=True)


def extend_right_all(index: DeviceIndex, lb, lb_rev, length):
    """All-SIGMA right extension (K9x on the reverse direction)."""
    return cuda_fm_index.fm_extend(index, lb, lb_rev, length, left=False)


def lf_step(index: DeviceIndex, rows: torch.Tensor) -> torch.Tensor:
    """One batched LF step: row of suffix p -> row of suffix p - 1."""
    symbols = bwt_at(index.fwd, rows)
    return index.C[symbols.long()] + rank_symbol(index.fwd, symbols, rows)


def locate_batch(index: DeviceIndex, rows: torch.Tensor,
                 sampling_rate: int | None = None):
    """SA rows -> (reference ids, positions in the reference), int32 [B]
    each (K9l): at most sampling_rate - 1 LF steps to a sampled row, then a
    binary search over the sequence starts. The walk bound defaults to
    the index's own sampling rate."""
    if sampling_rate is None:
        sampling_rate = index.sampling_rate
    return cuda_fm_index.fm_locate(
        index, rows.to(torch.int32).contiguous(), sampling_rate
    )
