"""Counterpart of floxer_tpu/index/device_index.py: the device-resident FM
index and its batched rank, extension, LF and locate.

The BWT, its occ checkpoints, the bit planes and the SA samples live on
one torch device. A rank query for a batch of positions is a checkpoint
read plus masked popcounts of the block's plane words; on the card it is
K9 (csrc/fm_rank.cuh, launched by ops/cuda_fm_index.py), on the CPU its
plain version. The extension and locate steps are K9x and K9l. K9l (and
K12's locates) find a row's SA sample through the sampled-row plane
(sample_plane), built at upload beside the sorted sampled_rows that the
plain versions search.

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

The row-sharded index (ShardedSingleIndex, ShardedDeviceIndex: the
reference's counterparts at :169 and :401) keeps S shards of BWT rows on
one device: each shard's combined rank-row table of its own rows (local
checkpoints and the planes of its real rows only, the pad symbol SIGMA in
no plane), stacked into int32 [S, R, 32], and its chunk of the SA
samples. rank_all, bwt_at, _sample_lookup and locate_batch take either
index; over the shards the rank is K13 and the locate K13l
(ops/cuda_sharded.py): the reference psums over its index mesh axis
each shard's count at the position clamped into its rows, and the
kernels take the count of the shard that owns the position plus each
symbol's total over the shards before it (shard_before, held on each
direction). The reference's dense rank (_rank_all_dense, the one-hot
window over the BWT) is not ported: the plane layout gives the same
counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..alphabet import SIGMA
from ..ops import cuda_fm_index, cuda_sharded
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
    # int32 [n // OCC_BLOCK + 1, 8] (sample_plane), what the CUDA locates
    # (K9l, K12) read in place of a search over sampled_rows
    sample_plane: torch.Tensor
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
            sample_plane=_int32_bits(
                sample_plane(index.sampled_rows, index.n), device),
            seq_starts=_int32(index.seq_starts, device),
            rank_rows=rank_rows,
            rev_block_offset=rev_block_offset,
            sampling_rate=index.sampling_rate,
        )


def sample_plane(sampled_rows, n: int) -> np.ndarray:
    """uint32 [n // OCC_BLOCK + 1, 8]: block b's entry (a 32-byte sector)
    holds the count of sampled rows before row b * OCC_BLOCK (word 0) and
    the block's membership bits (words 1 .. OCC_BLOCK // 32, bit j of word
    w for row b * OCC_BLOCK + 32 w + j, little-endian as the rank planes),
    so a sampled row's index in the sorted sampled_rows is word 0 plus the
    set bits below it in its block; words 5..7 are zero."""
    rows = np.asarray(sampled_rows, dtype=np.int64)
    num_blocks = n // OCC_BLOCK + 1
    member = np.zeros(num_blocks * OCC_BLOCK, dtype=bool)
    member[rows] = True
    words = OCC_BLOCK // 32
    plane = np.zeros((num_blocks, cuda_fm_index.SAMPLE_PLANE_WORDS),
                     dtype=np.uint32)
    plane[:, 0] = np.searchsorted(
        rows, np.arange(num_blocks, dtype=np.int64) * OCC_BLOCK)
    packed = np.packbits(member.reshape(num_blocks, words, 32), axis=-1,
                         bitorder="little")
    plane[:, 1:1 + words] = np.ascontiguousarray(packed).view(
        "<u4").reshape(num_blocks, words)
    return plane


def _int32(array, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(array), dtype=np.int32)
    ).to(device)


def _int32_bits(array: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(array, dtype=np.uint32).view(np.int32)
    ).to(device)


def pack_bit_planes(bwt, num_blocks: int | None = None) -> np.ndarray:
    """Host-side bit-plane packing of a BWT: uint32 [num_blocks, SIGMA,
    OCC_BLOCK // 32], little-endian bit order within each word (bit j of
    word w in block b <=> position b * OCC_BLOCK + 32 * w + j); num_blocks
    defaults to n // OCC_BLOCK + 1 (a shard's table takes its padded
    length's)."""
    n = bwt.shape[0]
    if num_blocks is None:
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


def direction_rows(occ, planes) -> np.ndarray:
    """uint32 [nb, 32]: one direction's flat rows (column 5 s the
    checkpoint of block b, 5 s + 1 .. 5 s + 4 its plane words)."""
    nb, _, words = planes.shape
    rows = np.zeros((nb, RANK_ROW_WORDS), dtype=np.uint32)
    for s in range(SIGMA):
        rows[:, 5 * s] = np.asarray(occ)[:nb, s].astype(np.uint32)
        rows[:, 5 * s + 1 : 5 * s + 1 + words] = planes[:, s, :]
    return rows


def rank_row_table(fwd_occ, fwd_planes, rev_occ, rev_planes) -> np.ndarray:
    """uint32 [nb_fwd + 1 + nb_rev, 32]: each direction's flat rows, fwd
    first, one zero row, then rev. A position in block b reads row b for
    both its checkpoint and its planes."""
    fwd_rows = direction_rows(fwd_occ, fwd_planes)
    pad = np.zeros_like(fwd_rows[:1])
    return np.concatenate([fwd_rows, pad, direction_rows(rev_occ, rev_planes)])


def rank_all(single, positions: torch.Tensor) -> torch.Tensor:
    """occ of every symbol before each position: [B] -> int32 [B, SIGMA]
    (K9), through the combined table when the index has one, else through
    this direction's occ and planes; over a ShardedSingleIndex, K13: the
    shards' counts at the positions clamped into their rows, summed (the
    owner's count plus the earlier shards' totals)."""
    if isinstance(single, ShardedSingleIndex):
        return cuda_sharded.fm_sharded_rank(
            positions.to(torch.int32).contiguous(), single.rank_rows,
            single.block_offset, single.shard_starts, single.shard_lengths,
            single.shard_before,
        )
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


def bwt_at(single, rows: torch.Tensor) -> torch.Tensor:
    """BWT symbols at rows, as int32; over a ShardedSingleIndex each from
    the shard that owns the row (the reference's masked psum)."""
    if isinstance(single, ShardedSingleIndex):
        return cuda_sharded.sharded_bwt_at_plain(
            single.bwt, single.shard_starts, single.shard_lengths, rows
        ).to(torch.int32)
    return single.bwt[rows.long()].to(torch.int32)


def _sample_lookup(index, rows: torch.Tensor):
    """(hit bool [B], sampled text position int32 [B], 0 where no hit) of
    SA rows; a sharded index sums its shards' hits and values (one shard
    at most holds a row; the chunks' pads are 1 << 30)."""
    if isinstance(index, ShardedDeviceIndex):
        hit, value = cuda_sharded.sharded_sample_lookup_plain(
            index.sampled_rows, index.sampled_values, rows)
        return hit, value.to(torch.int32)
    sampled = index.sampled_rows.to(torch.int64)
    rows = rows.to(torch.int64)
    at = torch.searchsorted(sampled, rows).clamp(max=sampled.shape[0] - 1)
    hit = sampled[at] == rows
    return hit, torch.where(hit, index.sampled_values[at], 0).to(torch.int32)


def rank_symbol(
    single, symbol: torch.Tensor, positions: torch.Tensor
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


def lf_step(index, rows: torch.Tensor) -> torch.Tensor:
    """One batched LF step: row of suffix p -> row of suffix p - 1."""
    symbols = bwt_at(index.fwd, rows)
    return index.C[symbols.long()] + rank_symbol(index.fwd, symbols, rows)


def locate_batch(index, rows: torch.Tensor,
                 sampling_rate: int | None = None):
    """SA rows -> (reference ids, positions in the reference), int32 [B]
    each (K9l; K13l over a ShardedDeviceIndex): at most sampling_rate - 1
    LF steps to a sampled row, then a binary search over the sequence
    starts. The walk bound defaults to the index's own sampling rate."""
    if sampling_rate is None:
        sampling_rate = index.sampling_rate
    rows = rows.to(torch.int32).contiguous()
    if isinstance(index, ShardedDeviceIndex):
        return cuda_sharded.fm_sharded_locate(index, rows, sampling_rate)
    return cuda_fm_index.fm_locate(index, rows, sampling_rate)


# ---------------------------------------------------------------------------
# The row-sharded index: S shards of BWT rows on one device


@dataclass
class ShardedSingleIndex:
    """One direction of the row-sharded index: its shards' BWT rows, the
    global row each starts at, the real rows each holds and each symbol's
    total over the shards before each (shard_before), and the index's
    stacked shard tables with this direction's first row in each
    (block_offset)."""

    bwt: torch.Tensor  # uint8 [S, L]
    shard_starts: torch.Tensor  # int32 [S]
    shard_lengths: torch.Tensor  # int32 [S]
    shard_before: torch.Tensor  # int32 [S, SIGMA]
    rank_rows: torch.Tensor  # int32 [S, R, 32]
    block_offset: int
    global_n: int


def index_size(single) -> int:
    """Global text length of a (possibly sharded) single-direction
    index."""
    if isinstance(single, ShardedSingleIndex):
        return single.global_n
    return single.bwt.shape[0]


@dataclass
class ShardedDeviceIndex:
    """A DeviceIndex whose BWT rows, rank tables and SA samples are
    row-sharded (parallel/sharded_index.shard_full_index) and stacked on
    one device; C and seq_starts whole. rank_rows holds each shard's
    combined table: its forward blocks, one zero row, its reverse blocks
    from row rev_block_offset."""

    fwd: ShardedSingleIndex
    rev: ShardedSingleIndex
    C: torch.Tensor  # int32 [SIGMA + 1]
    sampled_rows: torch.Tensor  # int32 [S, ns_per_shard], pad 1 << 30
    sampled_values: torch.Tensor  # int32 [S, ns_per_shard]
    seq_starts: torch.Tensor  # int32 [num_seqs]
    rank_rows: torch.Tensor  # int32 [S, nb + 1 + nb, 32]
    rev_block_offset: int
    sampling_rate: int
    locate_layout: torch.Tensor  # int32 [S, 9] (K13l's; locate_layout)

    @property
    def device(self) -> torch.device:
        return self.C.device

    @property
    def n(self) -> int:
        return self.fwd.global_n

    @property
    def num_shards(self) -> int:
        return self.rank_rows.shape[0]

    @classmethod
    def from_host(cls, index: FmIndex, num_shards: int,
                  device: torch.device) -> "ShardedDeviceIndex":
        """Row-shard the port's host index into num_shards shards on
        `device`."""
        from ..parallel.sharded_index import shard_full_index

        return cls.from_shards(shard_full_index(index, num_shards), device)

    @classmethod
    def from_shards(cls, sh, device: torch.device) -> "ShardedDeviceIndex":
        """Upload a ShardedHostIndex (parallel/sharded_index.py) to
        `device`: each shard's combined table built from its own rows."""
        rank_rows = _int32_bits(shard_rank_rows(sh.fwd, sh.rev), device)
        # each shard's forward blocks, then the zero row
        rev_block_offset = sh.fwd.bwt_shards.shape[1] // OCC_BLOCK + 2

        def single(host, offset):
            return ShardedSingleIndex(
                torch.from_numpy(np.ascontiguousarray(host.bwt_shards)).to(
                    device),
                _int32(host.shard_starts, device),
                _int32(host.shard_lengths, device),
                _int32(shard_before(host), device),
                rank_rows, offset, sh.global_n,
            )

        return cls(
            fwd=single(sh.fwd, 0),
            rev=single(sh.rev, rev_block_offset),
            C=_int32(sh.C, device),
            sampled_rows=_int32(sh.sampled_rows, device),
            sampled_values=_int32(sh.sampled_values, device),
            seq_starts=_int32(sh.seq_starts, device),
            rank_rows=rank_rows,
            rev_block_offset=rev_block_offset,
            sampling_rate=sh.sampling_rate,
            locate_layout=_int32(locate_layout(sh), device),
        )


def locate_layout(sh) -> np.ndarray:
    """int64 [S, cuda_sharded.LAYOUT_COLUMNS]: what K13l reads of a
    ShardedHostIndex to resolve the one shard that owns a row: each
    forward shard's first row, its sample chunk's first real row (1 << 30
    for a chunk of pads only) and its real samples, and each symbol's
    total over the shards before it (their ranks at their ends, so a rank
    over the shards is the owner's local rank plus it)."""
    c = cuda_sharded
    fwd = sh.fwd
    S = fwd.shard_starts.shape[0]
    layout = np.zeros((S, c.LAYOUT_COLUMNS), dtype=np.int64)
    layout[:, c.LAYOUT_START] = fwd.shard_starts
    layout[:, c.LAYOUT_BEFORE:c.LAYOUT_BEFORE + SIGMA] = shard_before(fwd)
    rows = np.asarray(sh.sampled_rows, dtype=np.int64)
    real = rows != c.PAD_ROW
    layout[:, c.LAYOUT_SAMPLES] = real.sum(axis=1)
    layout[:, c.LAYOUT_SAMPLE_FIRST] = np.where(real.any(axis=1), rows[:, 0],
                                                c.PAD_ROW)
    return layout


def shard_before(sharded) -> np.ndarray:
    """int64 [S, SIGMA]: each symbol's total over the real rows of the
    shards before each shard of one direction (a HostShardedSingle): their
    ranks at their ends, so a rank over the shards is the owner's local
    rank plus its row (0 for the first shard)."""
    S = sharded.shard_starts.shape[0]
    totals = np.stack([
        np.bincount(sharded.bwt_shards[s, :int(sharded.shard_lengths[s])],
                    minlength=SIGMA)[:SIGMA]
        for s in range(S)
    ]).astype(np.int64)
    before = np.zeros((S, SIGMA), dtype=np.int64)
    before[1:] = np.cumsum(totals, axis=0)[:-1]
    return before


def shard_planes(sharded) -> list[np.ndarray]:
    """Each shard's bit planes of one direction (a HostShardedSingle):
    its real rows only (lengths[s]), the padded length's blocks, the pad
    symbol SIGMA in no plane. The reference pads a shard's BWT with 0 and
    masks the pad in its rank; planes of those zeros would count them."""
    num_blocks = sharded.bwt_shards.shape[1] // OCC_BLOCK + 1
    return [
        pack_bit_planes(sharded.bwt_shards[s, :int(length)], num_blocks)
        for s, length in enumerate(sharded.shard_lengths)
    ]


def shard_rank_rows(fwd, rev=None) -> np.ndarray:
    """uint32 [S, R, 32]: each shard's rank rows from its local occ
    checkpoints and planes: one direction's (R = nb), or with `rev` the
    combined table of both (R = nb + 1 + nb, the reverse from row nb + 1).
    Raises where a shard's combined positions would pass int32."""
    fwd_planes = shard_planes(fwd)
    if rev is None:
        return np.stack([direction_rows(occ, planes) for occ, planes
                         in zip(fwd.occ_shards, fwd_planes)])
    tables = []
    for s, (planes, rev_planes) in enumerate(
        zip(fwd_planes, shard_planes(rev))
    ):
        if combined_overflows(planes, rev_planes):
            raise ValueError(
                "a shard's combined rank table passes 2^31 positions; "
                "use more index shards"
            )
        tables.append(rank_row_table(fwd.occ_shards[s], planes,
                                     rev.occ_shards[s], rev_planes))
    return np.stack(tables)
