"""The port's row-sharded FM index (floxer_tpu_torch.parallel.sharded_index,
index/device_index.ShardedDeviceIndex, and the plain versions of K13, K13l
and K11 over the shards) against the reference's
(floxer_tpu.parallel.sharded_index on its 8 virtual CPU devices), the
unsharded port and the host index; after tests/test_sharded_index.py.

Both packages get the same numpy sequences and positions, made from a
seed. The port's index axis is a list of CPU devices (one device
repeated, as the card is on a one-card machine), and its plain versions
sum the shards' counts where the reference psums them. Every comparison
is exact (tolerance 0). The kernels' own per-query functions
(csrc/fm_rank.cuh: the sharded rank, the locate walk over the shards and
the extension K11 runs) are built with g++ here and held to the plain
versions: K13's and K13l's threads one query after another, and
emulate_k11 (K11 in numpy, on one block and on a cluster of two) with the
g++ extension.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from floxer_tpu.index.device_index import DeviceIndex as RefDeviceIndex
from floxer_tpu.index.fmindex import FmIndex as RefFmIndex
from floxer_tpu.parallel import sharded_index as ref_si
from floxer_tpu.schemes import expand_scheme as ref_expand
from floxer_tpu.search_device import SchemeTables as RefSchemeTables
from floxer_tpu.search_device import _frontier_search as ref_frontier
from floxer_tpu_torch import pex, search_device, search_host
from floxer_tpu_torch.cli import parse_and_validate
from floxer_tpu_torch import pipeline
from floxer_tpu_torch.index import device_index as port_di
from floxer_tpu_torch.index.device_index import (
    DeviceIndex,
    ShardedDeviceIndex,
    index_size,
)
from floxer_tpu_torch.index.fmindex import FmIndex
from floxer_tpu_torch.ops import cuda_sharded
from floxer_tpu_torch.ops.frontier import frontier_search_plain
from floxer_tpu_torch.parallel import sharded_index as port_si
from floxer_tpu_torch.schemes import expand_scheme
from floxer_tpu_torch.search_device import SchemeTables
from test_torch_frontier import emulate_k11
from test_torch_search_device import chunk_jobs, of_package, result_view

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "floxer_tpu_torch" / "csrc"


def cpu_mesh_1d(num_shards):
    return port_si.make_index_mesh([CPU] * num_shards)


def ref_mesh_1d(num_shards):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:num_shards]), (ref_si.INDEX_AXIS,))


# ------------------------------------------------ g++ builds of fm_rank.cuh

EMULATION = r"""
#define __host__
#define __device__
#include "fm_rank.cuh"

static FmShardedRankTable table(const unsigned* rows, int shard_rows,
                                int row_offset, const int* starts,
                                const int* lengths, const int* before,
                                int num_shards) {
  FmShardedRankTable t;
  t.rows = rows; t.shard_rows = shard_rows; t.row_offset = row_offset;
  t.starts = starts; t.lengths = lengths; t.before = before;
  t.num_shards = num_shards;
  return t;
}

extern "C" {

// K13's threads, one query after another
void emu_sharded_rank(const unsigned* rows, int shard_rows, int row_offset,
                      const int* starts, const int* lengths,
                      const int* before, int num_shards,
                      const int* positions, int B, int* out) {
  const FmShardedRankTable t = table(rows, shard_rows, row_offset, starts,
                                     lengths, before, num_shards);
  for (int i = 0; i < B; ++i) fm_rank(t, positions[i], out + 6 * i);
}

// K13l's threads
void emu_sharded_locate(const unsigned* rows, int shard_rows, int num_shards,
                        const unsigned char* bwt, int bwt_stride,
                        const int* C, const int* sampled_rows,
                        const int* sampled_values, int ns,
                        const int* seq_starts, int num_seqs,
                        int sampling_rate, const int* layout,
                        const int* query_rows, int B, int* seq_ids,
                        int* positions) {
  FmShardedLocateTables t;
  t.fwd = table(rows, shard_rows, 0, nullptr, nullptr, nullptr, num_shards);
  t.bwt = bwt; t.bwt_stride = bwt_stride; t.C = C;
  t.sampled_rows = sampled_rows; t.sampled_values = sampled_values;
  t.ns = ns; t.seq_starts = seq_starts; t.num_seqs = num_seqs;
  t.sampling_rate = sampling_rate; t.layout = layout;
  for (int i = 0; i < B; ++i)
    fm_locate_row(t, query_rows[i], seq_ids + i, positions + i);
}

// the interval rank over the shard tables: lo [B, 6] and count [B, 6]
void emu_sharded_interval(const unsigned* rows, int shard_rows,
                          int row_offset, const int* starts,
                          const int* lengths, const int* before,
                          int num_shards, const int* base, const int* length,
                          int B, int* lo, int* count) {
  const FmShardedRankTable t = table(rows, shard_rows, row_offset, starts,
                                     lengths, before, num_shards);
  for (int i = 0; i < B; ++i)
    fm_interval_rank(t, base[i], length[i], lo + 6 * i, count + 6 * i);
}

// the extension K11 runs for an expanded state, over the shard tables
void emu_sharded_extend(const unsigned* rows, int shard_rows, int row_offset,
                        const int* starts, const int* lengths,
                        const int* before, int num_shards, const int* C,
                        const int* lb, const int* lb_rev, const int* length,
                        int B, int left, int* new_lb, int* new_lb_rev,
                        int* counts) {
  const FmShardedRankTable t = table(rows, shard_rows, row_offset, starts,
                                     lengths, before, num_shards);
  for (int i = 0; i < B; ++i)
    fm_extend_all(t, C, lb[i], lb_rev[i], length[i], left != 0,
                  new_lb + 6 * i, new_lb_rev + 6 * i, counts + 6 * i);
}

}
"""


@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    """The g++ build of csrc/fm_rank.cuh's sharded functions (ctypes)."""
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.fail("g++ is needed to build the kernels' host emulation")
    build = tmp_path_factory.mktemp("emulation")
    source = build / "emulation.cpp"
    source.write_text(EMULATION)
    library = build / "libemulation.so"
    subprocess.run(
        [compiler, "-O2", "-std=c++17", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-I", str(CSRC), str(source), "-o",
         str(library)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(library))


def _ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def emulate_rank(lib, positions, rows, row_offset, starts, lengths, before):
    out = torch.zeros((positions.shape[0], 6), dtype=torch.int32)
    lib.emu_sharded_rank(
        _ptr(rows), rows.shape[1], row_offset, _ptr(starts), _ptr(lengths),
        _ptr(before), rows.shape[0], _ptr(positions), positions.shape[0],
        _ptr(out),
    )
    return out


def emulate_locate(lib, index, rows):
    fwd = index.fwd
    seq_ids = torch.zeros(rows.shape[0], dtype=torch.int32)
    positions = torch.zeros_like(seq_ids)
    lib.emu_sharded_locate(
        _ptr(fwd.rank_rows), fwd.rank_rows.shape[1], index.num_shards,
        _ptr(fwd.bwt),
        fwd.bwt.shape[1], _ptr(index.C), _ptr(index.sampled_rows),
        _ptr(index.sampled_values), index.sampled_rows.shape[1],
        _ptr(index.seq_starts), index.seq_starts.shape[0],
        index.sampling_rate, _ptr(index.locate_layout), _ptr(rows),
        rows.shape[0], _ptr(seq_ids), _ptr(positions),
    )
    return seq_ids, positions


def emulated_extension(lib):
    """An `extend` for emulate_k11: fm_extend_all over the shard tables."""

    def extend(index, lb, lb_rev, length, left):
        single = index.fwd if left else index.rev
        outs = [torch.zeros((lb.shape[0], 6), dtype=torch.int32)
                for _ in range(3)]
        lib.emu_sharded_extend(
            _ptr(single.rank_rows), single.rank_rows.shape[1],
            single.block_offset, _ptr(single.shard_starts),
            _ptr(single.shard_lengths), _ptr(single.shard_before),
            index.num_shards, _ptr(index.C),
            *(_ptr(t.contiguous()) for t in (lb, lb_rev, length)),
            lb.shape[0], 1 if left else 0, *(_ptr(t) for t in outs),
        )
        return tuple(outs)

    return extend


def emulate_interval(lib, base, length, rows, row_offset, starts, lengths,
                     before):
    lo = torch.zeros((base.shape[0], 6), dtype=torch.int32)
    count = torch.zeros_like(lo)
    lib.emu_sharded_interval(
        _ptr(rows), rows.shape[1], row_offset, _ptr(starts), _ptr(lengths),
        _ptr(before), rows.shape[0], _ptr(base), _ptr(length),
        base.shape[0], _ptr(lo), _ptr(count),
    )
    return lo, count


# ------------------------------------------------------------------- rank


@pytest.mark.parametrize("index_axis", [2, 4])
def test_sharded_rank_matches_reference_and_host(index_axis, emulation):
    """tests/test_sharded_index.py:15's case: the port's sharded rank on a
    (reads x index) mesh of the CPU equals the reference's collective rank
    and the host index; the g++ build of K13's thread too."""
    rng = np.random.default_rng(3)
    sequences = [rng.integers(1, 5, size=1500).astype(np.uint8)]
    ref_host, host = RefFmIndex(sequences), FmIndex(sequences)
    batch = 8 // index_axis * 16
    positions = rng.integers(0, host.n + 1, size=batch).astype(np.int32)

    want = np.asarray(ref_si.sharded_rank_all(
        ref_si.make_2d_mesh(jax.devices()[:8], index_axis_size=index_axis),
        ref_si.shard_single_index(ref_host.fwd.bwt, index_axis), positions,
    ))
    sharded = port_si.shard_single_index(host.fwd.bwt, index_axis)
    mesh = port_si.make_2d_mesh([CPU] * 8, index_axis_size=index_axis)
    got = port_si.sharded_rank_all(mesh, sharded, positions)
    assert np.array_equal(got.numpy(), want)
    for i, pos in enumerate(positions):
        assert np.array_equal(want[i], host.fwd.occ_all(int(pos)))
    rows, starts, lengths, before = port_si.upload_shards(sharded, CPU)
    emulated = emulate_rank(emulation, torch.from_numpy(positions), rows, 0,
                            starts, lengths, before)
    assert torch.equal(emulated, got)


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
def test_owner_rank_matches_reference_psum(num_shards, emulation):
    """K13's rank resolves the shard that owns a position and adds the
    earlier shards' totals (shard_before): through the g++ build of its
    thread it equals the reference's psum of every shard's clamped rank at
    -1, 0, each shard's start and end, n, n + 1 and seeded positions
    around them, in both directions, on a 247-row text whose last shards
    are empty at 3 and 4 shards; and the plain version (int64 offsets) at
    the int32 extremes."""
    rng = np.random.default_rng(41)
    sequences = [rng.integers(1, 5, size=200).astype(np.uint8),
                 rng.integers(1, 6, size=45).astype(np.uint8)]
    ref_host, host = RefFmIndex(sequences), FmIndex(sequences)
    n = host.n
    index = ShardedDeviceIndex.from_host(host, num_shards, CPU)
    lengths = index.fwd.shard_lengths.numpy()
    assert (lengths == 0).any() == (num_shards >= 3)
    edges = {-1, 0, n, n + 1}
    for start, length in zip(index.fwd.shard_starts.tolist(), lengths):
        edges |= {start - 1, start, start + 1, start + int(length),
                  start + int(length) + 1}
    seeded = rng.integers(-3, n + 4, size=64)
    positions = np.array(sorted(edges) + seeded.tolist(), dtype=np.int32)
    if positions.shape[0] % 2:
        positions = np.append(positions, np.int32(n))
    ref_mesh = ref_si.make_2d_mesh(jax.devices()[:2 * num_shards],
                                   index_axis_size=num_shards)
    tensor = torch.from_numpy(positions)
    for direction in ("fwd", "rev"):
        single = getattr(index, direction)
        want = np.asarray(ref_si.sharded_rank_all(
            ref_mesh, ref_si.shard_single_index(
                getattr(ref_host, direction).bwt, num_shards), positions))
        got = emulate_rank(emulation, tensor, single.rank_rows,
                           single.block_offset, single.shard_starts,
                           single.shard_lengths, single.shard_before)
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(got, port_di.rank_all(single, tensor))
        extremes = torch.tensor([-2**31, -2**31 + 1, 2**31 - 1],
                                dtype=torch.int32)
        args = (single.rank_rows, single.block_offset, single.shard_starts,
                single.shard_lengths)
        assert torch.equal(
            emulate_rank(emulation, extremes, *args, single.shard_before),
            cuda_sharded.fm_sharded_rank_plain(extremes, *args))


@pytest.mark.parametrize("num_shards", [2, 3, 4])
def test_owner_interval_rank_matches_reference_psum(num_shards, emulation):
    """The interval rank over the shard tables (K11s's extension: one row
    when both ends have one owner and share its block) through the g++
    build: lo is the reference's psum rank at the base and count its rank
    at base + length less lo, for intervals that straddle each owner
    boundary by 1-3 positions on either side, sit inside one block of one
    owner, end at n or at an empty trailing shard's start, in both
    directions, on the 247-row text of the owner test."""
    rng = np.random.default_rng(43)
    sequences = [rng.integers(1, 5, size=200).astype(np.uint8),
                 rng.integers(1, 6, size=45).astype(np.uint8)]
    ref_host, host = RefFmIndex(sequences), FmIndex(sequences)
    n = host.n
    index = ShardedDeviceIndex.from_host(host, num_shards, CPU)
    bases, lengths = [], []
    for start in index.fwd.shard_starts.tolist():
        for before_edge in (1, 2, 3):
            for past_edge in (0, 1, 3):
                if 0 <= start - before_edge and start + past_edge <= n:
                    bases.append(start - before_edge)
                    lengths.append(before_edge + past_edge)
        if start + 5 <= n:
            bases.append(start + 1)
            lengths.append(4)
    for base in range(0, n + 1, 37):
        bases.append(base)
        lengths.append(n - base)
        bases.append(base)
        lengths.append(min(3, n - base))
    if len(bases) % 2:  # the reference's batch splits over 2 reads devices
        bases.append(n)
        lengths.append(0)
    base = np.array(bases, dtype=np.int32)
    length = np.array(lengths, dtype=np.int32)
    ref_mesh = ref_si.make_2d_mesh(jax.devices()[:2 * num_shards],
                                   index_axis_size=num_shards)
    for direction in ("fwd", "rev"):
        single = getattr(index, direction)
        ref_single = ref_si.shard_single_index(
            getattr(ref_host, direction).bwt, num_shards)
        want_lo = np.asarray(ref_si.sharded_rank_all(ref_mesh, ref_single,
                                                     base))
        want_hi = np.asarray(ref_si.sharded_rank_all(ref_mesh, ref_single,
                                                     base + length))
        lo, count = emulate_interval(
            emulation, torch.from_numpy(base), torch.from_numpy(length),
            single.rank_rows, single.block_offset, single.shard_starts,
            single.shard_lengths, single.shard_before)
        assert np.array_equal(lo.numpy(), want_lo)
        assert np.array_equal(count.numpy(), want_hi - want_lo)


def test_shard_tables_count_only_real_rows():
    """A shard's planes hold its real rows only: the zeros the reference
    pads a shard's BWT with are set in no plane, and a shard's checkpoints
    are its own (local) counts."""
    rng = np.random.default_rng(4)
    bwt = rng.integers(0, 6, size=300).astype(np.uint8)
    sharded = port_si.shard_single_index(bwt, 2)
    assert list(sharded.shard_lengths) == [256, 44]
    rows = port_di.shard_rank_rows(sharded)
    planes = port_di.shard_planes(sharded)
    assert rows.shape == (2, 256 // 128 + 1, 32)
    for s, length in enumerate(sharded.shard_lengths):
        chunk = sharded.bwt_shards[s, :length]
        for symbol in range(6):
            bits = np.unpackbits(planes[s][:, symbol, :].view(np.uint8),
                                 bitorder="little")
            assert np.array_equal(np.flatnonzero(bits),
                                  np.flatnonzero(chunk == symbol))
        assert np.array_equal(rows[s][:, 0:30:5],
                              sharded.occ_shards[s][:rows.shape[1]])


# ----------------------------------------------------------------- locate


@pytest.mark.parametrize("num_shards", [2, 4])
def test_sharded_locate_matches_reference(num_shards, emulation):
    """tests/test_sharded_index.py:47's case: the port's sharded locate
    equals the reference's, and the unsharded locate; the g++ build of
    K13l's thread too."""
    rng = np.random.default_rng(11)
    sequences = [
        rng.integers(1, 5, size=700).astype(np.uint8),
        rng.integers(1, 5, size=450).astype(np.uint8),
    ]
    ref_host, host = RefFmIndex(sequences), FmIndex(sequences)
    rows = rng.integers(0, host.n, size=32).astype(np.int32)

    want_ids, want_pos = ref_si.sharded_locate(
        ref_mesh_1d(num_shards), ref_si.shard_full_index(ref_host, num_shards),
        rows,
    )
    sh = port_si.shard_full_index(host, num_shards)
    got_ids, got_pos = port_si.sharded_locate(cpu_mesh_1d(num_shards), sh,
                                              rows)
    assert np.array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert np.array_equal(got_pos.numpy(), np.asarray(want_pos))
    flat_ids, flat_pos = port_di.locate_batch(
        DeviceIndex.from_host(host, CPU), torch.from_numpy(rows))
    assert torch.equal(got_ids, flat_ids) and torch.equal(got_pos, flat_pos)
    index = ShardedDeviceIndex.from_shards(sh, CPU)
    emulated = emulate_locate(emulation, index, torch.from_numpy(rows))
    assert torch.equal(emulated[0], got_ids)
    assert torch.equal(emulated[1], got_pos)


@pytest.mark.parametrize("num_shards", [3, 4])
def test_sharded_locate_edge_rows(num_shards, emulation):
    """K13l's owner resolution at its edges, through the g++ build of its
    thread: the first and last row of every shard, row 0, the text's last
    row, the rows beside every sample chunk's bounds (which fall between
    the row shards' bounds) and then every row, on a 247-row text whose
    last shard is empty; each equal to the plain version, the unsharded
    locate and the reference's sharded locate."""
    rng = np.random.default_rng(31)
    sequences = [rng.integers(1, 5, size=200).astype(np.uint8),
                 rng.integers(1, 5, size=45).astype(np.uint8)]
    ref_host, host = RefFmIndex(sequences), FmIndex(sequences)
    n = host.n
    sh = port_si.shard_full_index(host, num_shards)
    index = ShardedDeviceIndex.from_shards(sh, CPU)
    starts = sh.fwd.shard_starts
    ends = starts + sh.fwd.shard_lengths
    assert sh.fwd.shard_lengths[-1] == 0 and sh.fwd.shard_lengths[0] > 0
    layout = index.locate_layout.numpy()
    real = sh.sampled_rows != 1 << 30
    chunk_bounds = {int(b) for r, m in zip(sh.sampled_rows, real)
                    for b in (r[m][0], r[m][-1])}
    assert chunk_bounds - set(starts.tolist()) - set((ends - 1).tolist())
    assert layout[:, cuda_sharded.LAYOUT_SAMPLE_FIRST].tolist() == [
        int(r[0]) for r in sh.sampled_rows]

    edges = {0, n - 1}
    for start, end in zip(starts, ends):
        if end > start:
            edges |= {int(start), int(end) - 1}
    for bound in chunk_bounds:
        edges |= {b for b in (bound - 1, bound, bound + 1) if 0 <= b < n}
    edge_rows = np.array(sorted(edges), dtype=np.int32)
    every_row = np.arange(n, dtype=np.int32)
    flat = DeviceIndex.from_host(host, CPU)
    ref_sh = ref_si.shard_full_index(ref_host, num_shards)
    for rows in (edge_rows, every_row):
        tensor = torch.from_numpy(rows)
        want = cuda_sharded.fm_sharded_locate_plain(index, tensor,
                                                    index.sampling_rate)
        ref_ids, ref_pos = ref_si.sharded_locate(ref_mesh_1d(num_shards),
                                                 ref_sh, rows)
        assert np.array_equal(want[0].numpy(), np.asarray(ref_ids))
        assert np.array_equal(want[1].numpy(), np.asarray(ref_pos))
        for got in (emulate_locate(emulation, index, tensor),
                    port_di.locate_batch(flat, tensor)):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


# --------------------------------------------------------------- frontier


def frontier_case(errors):
    """tests/test_sharded_index.py:80's seeds: four of 12 chars from a
    900-char text, each mutated once with probability 0.7 when errors > 0,
    padded to 8 seeds with the dead class."""
    rng = np.random.default_rng(5)
    sequences = [rng.integers(1, 5, size=900).astype(np.uint8)]
    seed_len = 12
    padded = np.zeros((8, seed_len), dtype=np.int32)
    for i in range(4):
        start = int(rng.integers(0, 900 - seed_len))
        pattern = sequences[0][start : start + seed_len].copy()
        if errors and rng.random() < 0.7:
            pos = int(rng.integers(0, seed_len))
            pattern[pos] = 1 + (pattern[pos] % 4)
        padded[i] = pattern
    return sequences, padded


@pytest.mark.parametrize("errors", [0, 1, 2])
def test_sharded_frontier_search_matches_reference(errors, emulation):
    """The port's sharded frontier search at 4 shards equals the
    reference's sharded and unsharded searches (reports in order, count,
    overflow) and the port's unsharded one, iterations and expanded
    states included; emulate_k11 over the g++ sharded extension gives the
    same."""
    sequences, padded = frontier_case(errors)
    ref_host, host = RefFmIndex(sequences), FmIndex(sequences)
    seed_len = padded.shape[1]
    ref_tables = RefSchemeTables.from_searches(ref_expand(errors, seed_len))
    tables = SchemeTables.from_searches(expand_scheme(errors, seed_len))
    seed_class = np.full(8, tables.dead_class, dtype=np.int32)
    seed_class[:4] = 0
    max_iterations = seed_len + errors + 2 * tables.num_parts + 2
    capacity, report_capacity = 1 << 12, 1 << 10

    want = ref_si.sharded_frontier_search(
        ref_mesh_1d(4), ref_si.shard_full_index(ref_host, 4), padded,
        seed_class, ref_tables, capacity, report_capacity, max_iterations,
    )
    flat = ref_frontier(
        RefDeviceIndex.from_host(ref_host), padded, seed_class,
        ref_tables.start, ref_tables.end, ref_tables.direction,
        ref_tables.lower, ref_tables.upper, ref_tables.num_searches,
        ref_tables.num_parts, capacity, report_capacity, max_iterations,
    )
    want_n = int(want[1])
    assert want_n == int(flat[1]) and want_n > 0
    got = port_si.sharded_frontier_search(
        cpu_mesh_1d(4), port_si.shard_full_index(host, 4), padded,
        seed_class, tables, capacity, report_capacity, max_iterations,
    )
    assert got[1] == want_n
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[2], np.asarray(want[2]))

    index = ShardedDeviceIndex.from_host(host, 4, CPU)
    operands = (torch.from_numpy(padded), torch.from_numpy(seed_class),
                torch.from_numpy(tables.fused()), tables.num_searches,
                tables.num_parts, capacity, report_capacity, max_iterations)
    sharded_stats, flat_stats = {}, {}
    sharded = frontier_search_plain(index, *operands, sharded_stats)
    unsharded = frontier_search_plain(DeviceIndex.from_host(host, CPU),
                                      *operands, flat_stats)
    assert torch.equal(sharded[0], unsharded[0])
    assert sharded[1] == unsharded[1] == want_n
    assert torch.equal(sharded[2], unsharded[2])
    assert sharded_stats == flat_stats
    # on one block of K11's threads and on a cluster of 2 blocks of 32
    for blocks, threads in ((1, 512), (2, 32)):
        emulated = emulate_k11(
            index, padded.astype(np.int64), seed_class.astype(np.int64),
            tables.fused().astype(np.int64), tables.num_searches,
            tables.num_parts, capacity, report_capacity, max_iterations,
            threads=threads, blocks=blocks,
            extend=emulated_extension(emulation),
        )
        assert np.array_equal(emulated[0], sharded[0].numpy())
        assert emulated[1:3] == (want_n, bool(sharded[2][0]))
        assert emulated[3:] == (sharded_stats["iterations"],
                                sharded_stats["expanded"])


# ------------------------------------------------------ empty trailing shards


@pytest.mark.parametrize("num_shards", [8, 32])
def test_empty_trailing_shards_count_nothing(num_shards, emulation):
    """A short text cut into many 128-aligned shards leaves the last ones
    empty (length 0), and at 32 shards the last sample chunk holds pads
    only: the rank, the locate and the frontier search over them equal
    the unsharded ones and the reference's, and the g++ builds agree."""
    rng = np.random.default_rng(8)
    sequences = [rng.integers(1, 5, size=300).astype(np.uint8),
                 rng.integers(1, 5, size=60).astype(np.uint8)]
    ref_host, host = RefFmIndex(sequences), FmIndex(sequences)
    sh = port_si.shard_full_index(host, num_shards)
    assert (sh.fwd.shard_lengths == 0).sum() >= num_shards - 3
    pads_only = (sh.sampled_rows == 1 << 30).all(axis=1)
    assert pads_only[-1] == (num_shards == 32)
    index = ShardedDeviceIndex.from_shards(sh, CPU)
    flat = DeviceIndex.from_host(host, CPU)
    assert index_size(index.fwd) == index_size(flat.fwd) == host.n

    positions = torch.arange(host.n + 1, dtype=torch.int32)
    for single, flat_single in ((index.fwd, flat.fwd), (index.rev, flat.rev)):
        got = port_di.rank_all(single, positions)
        assert torch.equal(got, port_di.rank_all(flat_single, positions))
        assert torch.equal(got, emulate_rank(
            emulation, positions, single.rank_rows, single.block_offset,
            single.shard_starts, single.shard_lengths, single.shard_before))
    rows = torch.arange(host.n, dtype=torch.int32)
    assert torch.equal(port_di.bwt_at(index.fwd, rows),
                       port_di.bwt_at(flat.fwd, rows))
    hit, value = port_di._sample_lookup(index, rows)
    flat_hit, flat_value = port_di._sample_lookup(flat, rows)
    assert torch.equal(hit, flat_hit) and torch.equal(value, flat_value)
    located = port_di.locate_batch(index, rows)
    for got, want in zip(located, port_di.locate_batch(flat, rows)):
        assert torch.equal(got, want)
    for got, want in zip(emulate_locate(emulation, index, rows), located):
        assert torch.equal(got, want)
    if num_shards == 8:
        ref_ids, ref_pos = ref_si.sharded_locate(
            ref_mesh_1d(8), ref_si.shard_full_index(ref_host, 8),
            rows.numpy())
        assert np.array_equal(located[0].numpy(), np.asarray(ref_ids))
        assert np.array_equal(located[1].numpy(), np.asarray(ref_pos))

    tables = SchemeTables.from_searches(expand_scheme(2, 14))
    padded = np.stack([sequences[0][i:i + 14] for i in (10, 200, 280)]
                      + [sequences[1][30:44]]).astype(np.int32)
    padded[1, 5] = 1 + padded[1, 5] % 4
    seed_class = np.zeros(4, dtype=np.int32)
    operands = (torch.from_numpy(padded), torch.from_numpy(seed_class),
                torch.from_numpy(tables.fused()), tables.num_searches,
                tables.num_parts, 1 << 12, 1 << 10, 14 + 2 + 2 *
                tables.num_parts + 2)
    sharded = frontier_search_plain(index, *operands)
    unsharded = frontier_search_plain(flat, *operands)
    assert sharded[1] == unsharded[1] > 0
    assert torch.equal(sharded[0], unsharded[0])


# ---------------------------------------------------------- chunk search


def test_sharded_chunk_search_matches_host_chunk():
    """tests/test_sharded_index.py:147's case: the sharded searcher's
    search_seeds_many (the legacy block loop over the shard tables, the
    native select, the host redo) equals the host chunk search on a
    cap-free workload with mixed seed lengths and error counts."""
    rng = np.random.default_rng(77)
    sequences = [
        rng.integers(1, 5, size=2500).astype(np.uint8),
        rng.integers(1, 5, size=800).astype(np.uint8),
    ]
    host = FmIndex(sequences)
    searcher = search_host.Searcher(
        index=host, num_reference_sequences=len(sequences),
        config=search_host.SearchConfig(),
    )
    sharded = search_device.make_sharded_searcher(searcher, host, 4, CPU)
    assert sharded._one_dispatch_chunk is False
    assert getattr(sharded, "_device_index", None) is None

    jobs = of_package(chunk_jobs(sequences, rng, 6, (20, 28), 2), pex)
    want = searcher.search_seeds_many(jobs)
    got = sharded.search_seeds_many(jobs)
    assert len(got) == len(want)
    for j, (w, g) in enumerate(zip(want, got)):
        assert result_view(g) == result_view(w), f"job {j}"
    per_query = sharded.search_seeds(*jobs[0])
    assert result_view(per_query) == result_view(want[0])


# -------------------------------------------------------------------- CLI


def cli_args(data_dir, output, extra=()):
    return [
        "--reference", str(data_dir / "reference.fasta"),
        "--queries", str(data_dir / "queries.fastq"),
        "--output", str(output),
        "--query-errors", "2", "--seed-errors", "1",
        "--extra-verification-ratio", "2", "--interval-optimization",
        *extra,
    ]


@pytest.fixture(scope="module")
def reference_sam(tmp_path_factory, data_dir):
    """SAM of the JAX package (python -m floxer_tpu, CPU backend)."""
    output = tmp_path_factory.mktemp("reference") / "out.sam"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT),
           "FLOXER_TPU_PLATFORM": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", "floxer_tpu", *cli_args(data_dir, output)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=420,
    )
    assert proc.returncode == 0, proc.stderr
    return output.read_bytes()


@pytest.mark.parametrize("extra", [
    ["--index-shards", "8"],
    ["--index-shards", "8", "--device-search"],
    ["--index-shards", "2", "--engine", "reference"],
])
def test_sharded_cli_matches_unsharded_and_reference(
    tmp_path, data_dir, reference_sam, monkeypatch, extra
):
    """tests/test_sharded_index.py:180's case in this process on the CPU:
    the CLI with --index-shards writes the unsharded port run's SAM and
    the reference's, its searches over the sharded index (8 shards of the
    81-row index leave the last ones empty)."""
    from floxer_tpu_torch.ops import frontier

    indexes = []
    original = frontier.frontier_search_plain

    def counted(index, *args, **kwargs):
        indexes.append(index)
        return original(index, *args, **kwargs)

    monkeypatch.setattr(frontier, "frontier_search_plain", counted)
    sharded = tmp_path / "sharded.sam"
    assert pipeline.run(parse_and_validate(cli_args(data_dir, sharded, extra)),
                        device=CPU) == 0
    assert indexes and all(isinstance(i, ShardedDeviceIndex)
                           for i in indexes)
    assert indexes[0].num_shards == int(extra[1])
    unsharded = tmp_path / "unsharded.sam"
    assert pipeline.run(parse_and_validate(cli_args(data_dir, unsharded)),
                        device=CPU) == 0
    assert sharded.read_bytes() == unsharded.read_bytes() == reference_sam


def test_sharded_cli_needs_a_device(tmp_path, data_dir, monkeypatch):
    """Without a Hopper GPU, a device passed or FLOXER_TPU_PLATFORM=cpu,
    --index-shards exits non-zero under every engine (no fallback), and
    with FLOXER_TPU_PLATFORM=cpu it runs on the CPU."""
    monkeypatch.setattr(pipeline, "accelerator_available", lambda: False)
    monkeypatch.delenv("FLOXER_TPU_PLATFORM", raising=False)
    for engine in ("batched", "reference", "device"):
        output = tmp_path / f"{engine}.sam"
        cli = parse_and_validate(cli_args(
            data_dir, output, ["--index-shards", "2", "--engine", engine]))
        assert pipeline.run(cli) != 0
        assert not output.exists()
    monkeypatch.setenv("FLOXER_TPU_PLATFORM", "cpu")
    output = tmp_path / "cpu.sam"
    cli = parse_and_validate(cli_args(data_dir, output,
                                      ["--index-shards", "2"]))
    assert pipeline.run(cli) == 0
    assert output.exists()


# --------------------------------------------------------------- wrappers


def test_cuda_wrappers_refuse_cpu_operands():
    """K13's and K13l's CUDA entries take CUDA operands only; the
    dispatching entries check shapes on either route."""
    rng = np.random.default_rng(2)
    host = FmIndex([rng.integers(1, 5, size=400).astype(np.uint8)])
    index = ShardedDeviceIndex.from_host(host, 2, CPU)
    positions = torch.arange(8, dtype=torch.int32)
    single = index.fwd
    args = (single.rank_rows, 0, single.shard_starts, single.shard_lengths)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_sharded.fm_sharded_rank_cuda(positions, *args)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_sharded.fm_sharded_locate_cuda(index, positions, 4)
    with pytest.raises(ValueError, match="shard_starts"):
        cuda_sharded.fm_sharded_rank(positions, single.rank_rows, 0,
                                     single.shard_starts[:1],
                                     single.shard_lengths)
    with pytest.raises(ValueError, match="int32"):
        cuda_sharded.fm_sharded_rank(positions.long(), *args)


def test_index_axis_must_be_one_device():
    """The shards are summed in one launch: an index axis of two distinct
    devices is refused."""
    mesh = port_si.make_index_mesh([CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="one device"):
        port_si.index_device(mesh)
