"""The port's device FM index (floxer_tpu_torch.index.device_index: K9,
K9x, K9l's plain versions on the CPU) against the reference's
(floxer_tpu.index.device_index, XLA on the CPU) and the host index.

Each package builds its own FmIndex from the same numpy sequences, made
from a seed; every comparison is integer equality (tolerance 0), in the
combined rank-row layout and in the per-direction planes layout. K9l's
per-row functions (csrc/fm_rank.cuh: the sampled-row plane's lookup and
the locate walk over it) are built with g++ here and held to the
reference's _sample_lookup and locate_batch on every row; so are the
interval rank and the extension that K10 and K11 run (one row when an
interval lies in one block) on cursors at every block edge.
emulate_k9_staged, emulate_k9_planes and emulate_k9x mirror K9's and
K9x's schedules (csrc/fm_index.cu: a warp's rows staged 8 lanes a row in
the combined layout, a group of 8 lanes a query in the planes layout)
lane by lane and are held to the reference's rank_rows_lookup,
_rank_all_planes and extend_*_all.
"""

import ctypes
import shutil
import subprocess
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floxer_tpu.index import device_index as ref
from floxer_tpu.index.fmindex import FmIndex as RefFmIndex
from floxer_tpu_torch.index import device_index as port
from floxer_tpu_torch.index.fmindex import FmIndex

CPU = torch.device("cpu")
LAYOUTS = ["combined", "planes"]
CSRC = Path(__file__).resolve().parent.parent / "floxer_tpu_torch" / "csrc"


def _sequences(seed):
    """tests/test_device_index.py's fixtures: two ACGT records (seed 5),
    and one 517-char record over all five symbols (seed 5 again)."""
    rng = np.random.default_rng(seed)
    if seed == 5:
        return [rng.integers(1, 5, size=257).astype(np.uint8),
                rng.integers(1, 5, size=101).astype(np.uint8)]
    return [rng.integers(1, 6, size=517).astype(np.uint8)]


@pytest.fixture(scope="module", params=[5, 6])
def indexes(request):
    sequences = _sequences(request.param)
    ref_host = RefFmIndex(sequences)
    host = FmIndex(sequences)
    return ref_host, ref.DeviceIndex.from_host(ref_host), host, sequences


def port_index(host, layout):
    index = port.DeviceIndex.from_host(host, CPU,
                                       force_planes=layout == "planes")
    assert (index.rank_rows is None) == (layout == "planes")
    return index


def _positions(rng, n):
    return np.unique(np.concatenate([
        rng.integers(0, n + 1, size=256), np.arange(0, n + 1, 128),
        np.array([0, 1, 31, 32, 33, 63, 64, 127, 128, 129, n]),
    ])).astype(np.int32)


def test_planes_and_rank_rows_equal_reference(indexes):
    """pack_bit_planes, the combined table (its int32 bits), its reverse
    offset, C and the SA samples equal the reference's arrays."""
    ref_host, ref_index, host, _ = indexes
    for direction in ("fwd", "rev"):
        assert np.array_equal(
            port.pack_bit_planes(getattr(host, direction).bwt),
            ref.pack_bit_planes(getattr(ref_host, direction).bwt),
        )
        assert np.array_equal(
            getattr(port_index(host, "combined"), direction).planes.numpy(),
            np.asarray(getattr(ref_index, direction).planes).view(np.int32),
        )
    index = port_index(host, "combined")
    assert np.array_equal(index.rank_rows.numpy(),
                          np.asarray(ref_index.rank_rows).view(np.int32))
    assert index.rev_block_offset == int(ref_index.rev_block_offset)
    for name in ("C", "sampled_rows", "sampled_values", "seq_starts"):
        assert np.array_equal(getattr(index, name).numpy(),
                              np.asarray(getattr(ref_index, name)))


def test_combined_table_int32_guard():
    """The combined table is used below 2^31 combined positions and the
    planes layout from there, as the reference decides."""
    def planes(blocks):
        return types.SimpleNamespace(shape=(blocks, 6, 4))

    below = 2**23 - 1  # (2 * below + 1) * 128 = 2^31 - 128
    assert not port.combined_overflows(planes(below), planes(below))
    assert port.combined_overflows(planes(below), planes(below + 1))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rank_all_matches_reference(indexes, layout):
    """rank_all of both directions at random positions, every block
    boundary and n, against the reference's rank_all and the host's
    occ_all; rank_rows_lookup against the reference's."""
    ref_host, ref_index, host, _ = indexes
    index = port_index(host, layout)
    positions = _positions(np.random.default_rng(0), host.n)
    for direction in ("fwd", "rev"):
        got = port.rank_all(getattr(index, direction),
                            torch.from_numpy(positions)).numpy()
        want = np.asarray(ref.rank_all(getattr(ref_index, direction),
                                       jnp.asarray(positions)))
        assert np.array_equal(got, want)
        for i in range(0, len(positions), 17):
            assert np.array_equal(
                got[i], getattr(host, direction).occ_all(int(positions[i]))
            )
    if layout == "combined":
        offset = index.rev_block_offset * 128
        combined = np.concatenate([positions, positions + offset])
        got = port.rank_rows_lookup(index.rank_rows,
                                    torch.from_numpy(combined)).numpy()
        want = np.asarray(ref.rank_rows_lookup_stacked(
            ref_index.rank_rows, jnp.asarray(combined)))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_extend_matches_reference_and_host(indexes, layout):
    """extend_left_all / extend_right_all on the reference test's cursor
    (a pattern of the text extended leftwards) equal the host index's
    children, and on a random batch of cursors the reference's."""
    ref_host, ref_index, host, sequences = indexes
    index = port_index(host, layout)
    cursor = host.root_cursor()
    pattern = sequences[0][40:52]
    for symbol in reversed(pattern[4:]):
        cursor = host.extend_left(cursor, int(symbol))
    one = [torch.tensor([v], dtype=torch.int32)
           for v in (cursor.lb, cursor.lb_rev, cursor.length)]
    for port_fn, host_fn in (
        (port.extend_left_all, host.extend_left_all),
        (port.extend_right_all, host.extend_right_all),
    ):
        new_lb, new_lb_rev, counts = port_fn(index, *one)
        for s, child in enumerate(host_fn(cursor)):
            assert int(counts[0, s]) == child.length
            if child.length > 0:
                assert int(new_lb[0, s]) == child.lb
                assert int(new_lb_rev[0, s]) == child.lb_rev

    rng = np.random.default_rng(3)
    n = host.n
    lb = rng.integers(0, n, size=300)
    lb_rev = rng.integers(0, n, size=300)
    length = np.minimum(rng.integers(0, 80, size=300),
                        n - np.maximum(lb, lb_rev))
    cursors = [a.astype(np.int32) for a in (lb, lb_rev, length)]
    for port_fn, ref_fn in ((port.extend_left_all, ref.extend_left_all),
                            (port.extend_right_all, ref.extend_right_all)):
        got = port_fn(index, *map(torch.from_numpy, cursors))
        want = ref_fn(ref_index, *map(jnp.asarray, cursors))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_locate_and_lf_match_reference_and_host(indexes, layout):
    """locate_batch equals the reference's and the host's locate;
    lf_step, bwt_at and rank_symbol equal the reference's."""
    ref_host, ref_index, host, _ = indexes
    index = port_index(host, layout)
    rows = np.random.default_rng(1).integers(0, host.n, size=128).astype(
        np.int32
    )
    seq_ids, positions = (t.numpy() for t in
                          port.locate_batch(index, torch.from_numpy(rows)))
    want_ids, want_positions = ref.locate_batch(ref_index, jnp.asarray(rows))
    assert np.array_equal(seq_ids, np.asarray(want_ids))
    assert np.array_equal(positions, np.asarray(want_positions))
    for i, row in enumerate(rows):
        assert (seq_ids[i], positions[i]) == host.locate(int(row))
    rows_t, rows_j = torch.from_numpy(rows), jnp.asarray(rows)
    assert np.array_equal(port.lf_step(index, rows_t).numpy(),
                          np.asarray(ref.lf_step(ref_index, rows_j)))
    symbols = port.bwt_at(index.fwd, rows_t)
    assert np.array_equal(symbols.numpy(),
                          np.asarray(ref.bwt_at(ref_index.fwd, rows_j)))
    assert np.array_equal(
        port.rank_symbol(index.rev, symbols, rows_t).numpy(),
        np.asarray(ref.rank_symbol(ref_index.rev, jnp.asarray(
            symbols.numpy()), rows_j)),
    )


# ------------------------------------ g++ build of K9l's per-row functions

EMULATION = r"""
#define __host__
#define __device__
#include "fm_rank.cuh"

static FmRankTable rank_table(const unsigned* rows, const int* occ,
                              const unsigned* planes, int row_offset) {
  FmRankTable t;
  t.rows = rows; t.occ = occ; t.planes = planes; t.row_offset = row_offset;
  return t;
}

static FmLocateTables tables(const unsigned* rows, const int* occ,
                             const unsigned* planes, const unsigned char* bwt,
                             const int* C, const unsigned* sample_plane,
                             const int* sampled_values, int n,
                             const int* seq_starts, int num_seqs,
                             int sampling_rate) {
  FmLocateTables t;
  t.fwd.rows = rows; t.fwd.occ = occ; t.fwd.planes = planes;
  t.fwd.row_offset = 0;
  t.bwt = bwt; t.C = C; t.sample_plane = sample_plane;
  t.sampled_values = sampled_values; t.n = n; t.seq_starts = seq_starts;
  t.num_seqs = num_seqs; t.sampling_rate = sampling_rate;
  return t;
}

extern "C" {

// the plane's lookup of each row: hit (0 / 1) and value
void emu_sample_lookup(const unsigned* sample_plane,
                       const int* sampled_values, int n, const int* rows,
                       int B, int* hits, int* values) {
  const FmLocateTables t = tables(nullptr, nullptr, nullptr, nullptr,
                                  nullptr, sample_plane, sampled_values, n,
                                  nullptr, 0, 0);
  for (int i = 0; i < B; ++i)
    hits[i] = fm_sample_lookup(t, rows[i], values + i) ? 1 : 0;
}

// the interval rank (fm_interval_rank, K10's) at each (base, length):
// lo [B, 6] and count [B, 6]
void emu_interval_rank(const unsigned* rows, const int* occ,
                       const unsigned* planes, int row_offset,
                       const int* base, const int* length, int B, int* lo,
                       int* count) {
  const FmRankTable t = rank_table(rows, occ, planes, row_offset);
  for (int i = 0; i < B; ++i)
    fm_interval_rank(t, base[i], length[i], lo + 6 * i, count + 6 * i);
}

// the extension K11 runs for an expanded state (fm_extend_all)
void emu_extend(const unsigned* rows, const int* occ, const unsigned* planes,
                int row_offset, const int* C, const int* lb,
                const int* lb_rev, const int* length, int B, int left,
                int* new_lb, int* new_lb_rev, int* counts) {
  const FmRankTable t = rank_table(rows, occ, planes, row_offset);
  for (int i = 0; i < B; ++i)
    fm_extend_all(t, C, lb[i], lb_rev[i], length[i], left != 0,
                  new_lb + 6 * i, new_lb_rev + 6 * i, counts + 6 * i);
}

// K9l's threads, one row after another
void emu_locate(const unsigned* rows, const int* occ, const unsigned* planes,
                const unsigned char* bwt, const int* C,
                const unsigned* sample_plane, const int* sampled_values,
                int n, const int* seq_starts, int num_seqs,
                int sampling_rate, const int* query_rows, int B,
                int* seq_ids, int* positions) {
  const FmLocateTables t =
      tables(rows, occ, planes, bwt, C, sample_plane, sampled_values, n,
             seq_starts, num_seqs, sampling_rate);
  for (int i = 0; i < B; ++i)
    fm_locate_row(t, query_rows[i], seq_ids + i, positions + i);
}

}
"""


@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    """The g++ build of csrc/fm_rank.cuh's locate, interval rank and
    extension functions (ctypes)."""
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.fail("g++ is needed to build the kernels' host emulation")
    build = tmp_path_factory.mktemp("locate_emulation")
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
    return ctypes.c_void_p(None if tensor is None else tensor.data_ptr())


def emulate_lookup(lib, index, rows):
    hits = torch.zeros(rows.shape[0], dtype=torch.int32)
    values = torch.zeros_like(hits)
    lib.emu_sample_lookup(_ptr(index.sample_plane),
                          _ptr(index.sampled_values), index.n, _ptr(rows),
                          rows.shape[0], _ptr(hits), _ptr(values))
    return hits.bool(), values


def emulate_locate(lib, index, rows):
    fwd = index.fwd
    seq_ids = torch.zeros(rows.shape[0], dtype=torch.int32)
    positions = torch.zeros_like(seq_ids)
    lib.emu_locate(
        _ptr(fwd.rank_rows), _ptr(fwd.occ), _ptr(fwd.planes), _ptr(fwd.bwt),
        _ptr(index.C), _ptr(index.sample_plane), _ptr(index.sampled_values),
        index.n, _ptr(index.seq_starts), index.seq_starts.shape[0],
        index.sampling_rate, _ptr(rows), rows.shape[0], _ptr(seq_ids),
        _ptr(positions),
    )
    return seq_ids, positions


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sample_plane_equals_searchsorted(indexes, layout):
    """The sampled-row plane, built in both rank layouts: for every row of
    the index, its bit says whether the row is in sampled_rows and its
    block's count plus the set bits below it is the row's searchsorted
    index there; words 5..7 are zero."""
    _, _, host, _ = indexes
    index = port_index(host, layout)
    plane = index.sample_plane.numpy().view(np.uint32).astype(np.int64)
    n = host.n
    assert plane.shape == (n // 128 + 1, 8)
    assert not plane[:, 5:].any()
    sampled = index.sampled_rows.numpy().astype(np.int64)
    rows = np.arange(n + 128 - n % 128, dtype=np.int64)
    block, r = rows // 128, rows % 128
    words = plane[block, 1 + r // 32]
    bits = (words >> (r % 32)) & 1
    at = np.searchsorted(sampled, rows)
    member = (at < sampled.shape[0]) & (
        sampled[np.minimum(at, sampled.shape[0] - 1)] == rows)
    assert np.array_equal(bits.astype(bool), member)
    below = plane[block, 0].copy()
    for w in range(4):
        keep = np.clip(r - 32 * w, 0, 32)
        mask = (np.int64(1) << keep) - 1
        masked = plane[block, 1 + w] & mask
        below += np.array([bin(int(v)).count("1") for v in masked])
    assert np.array_equal(below, at)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plane_locate_matches_reference(indexes, layout, emulation):
    """The g++ build of K9l's thread over FmLocateTables with the plane:
    its sample lookup equals the reference's _sample_lookup on every row
    from -1 to n (no hit at -1 and n, whose plane bits it never reads),
    and its locate walk the reference's locate_batch on every row
    0..n-1."""
    _, ref_index, host, _ = indexes
    index = port_index(host, layout)
    n = host.n
    rows = torch.arange(-1, n + 1, dtype=torch.int32)
    hit, value = emulate_lookup(emulation, index, rows)
    want_hit, want_value = ref._sample_lookup(ref_index,
                                              jnp.asarray(rows.numpy()))
    assert np.array_equal(hit.numpy(), np.asarray(want_hit))
    assert np.array_equal(value.numpy(), np.asarray(want_value))
    assert not hit[0] and not hit[-1]
    every = torch.arange(n, dtype=torch.int32)
    seq_ids, positions = emulate_locate(emulation, index, every)
    want_ids, want_positions = ref.locate_batch(ref_index,
                                                jnp.asarray(every.numpy()))
    assert np.array_equal(seq_ids.numpy(), np.asarray(want_ids))
    assert np.array_equal(positions.numpy(), np.asarray(want_positions))


# ------------------------------- one-block intervals: K9x, K10 and K11's rank


def _block_cursors(rng, n, left):
    """int32 cursors (lb, lb_rev, length) whose base (lb for a left
    extension, lb_rev for a right one) sits at offsets r = 0, 1, 31, 64
    and 127 of the first, second and last blocks, with lengths 0, 1, 127,
    127 - r (the block's last position), 128 - r (the next block's first)
    and 129 - r (one past it), those that run past n dropped; then every
    base + length = n up to 300 back, and n itself at length 0. The other
    start is seeded in [0, n - length]."""
    last = n // 128
    bases, lengths = [], []
    for block in sorted({0, 1, last}):
        for r in (0, 1, 31, 64, 127):
            base = 128 * block + r
            for length in (0, 1, 127, 127 - r, 128 - r, 129 - r):
                if base + length <= n:
                    bases.append(base)
                    lengths.append(length)
    for length in range(0, min(n, 300) + 1, 7):
        bases.append(n - length)
        lengths.append(length)
    bases.append(n)
    lengths.append(0)
    base = np.array(bases, dtype=np.int64)
    length = np.array(lengths, dtype=np.int64)
    other = (rng.random(base.shape[0]) * (n - length + 1)).astype(np.int64)
    lb, lb_rev = (base, other) if left else (other, base)
    return [a.astype(np.int32) for a in (lb, lb_rev, length)]


def test_block_cursors_cover_the_edges():
    """The cursors sit in one block, end on the next block's first
    position, cross a block by one, and end at n."""
    n = 517
    lb, _, length = _block_cursors(np.random.default_rng(0), n, True)
    end = lb.astype(np.int64) + length
    same = lb // 128 == end // 128
    assert same.any() and (~same).any()
    assert set(length.tolist()) >= {0, 1, 127}
    assert (end == n).sum() > 10 and (lb == n).any()
    assert ((end % 128 == 0) & (lb // 128 + 1 == end // 128)
            & (length > 0)).any()
    assert ((end % 128 == 1) & (lb // 128 + 1 == end // 128)).any()


def _ref_extend(ref_index, left, cursors):
    fn = ref.extend_left_all if left else ref.extend_right_all
    return [np.asarray(a) for a in fn(ref_index, *map(jnp.asarray, cursors))]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_extend_block_edges_match_reference(indexes, layout):
    """extend_left_all / extend_right_all (K9x's plain version on the CPU)
    on cursors at every block edge equal the reference's."""
    _, ref_index, host, _ = indexes
    index = port_index(host, layout)
    rng = np.random.default_rng(11)
    for left, port_fn in ((True, port.extend_left_all),
                          (False, port.extend_right_all)):
        cursors = _block_cursors(rng, host.n, left)
        got = port_fn(index, *map(torch.from_numpy, cursors))
        for g, w in zip(got, _ref_extend(ref_index, left, cursors)):
            assert np.array_equal(g.numpy(), w)


def _single_table(index, left):
    single = index.fwd if left else index.rev
    return single.rank_rows, single.occ, single.planes, single.block_offset


def emulate_interval(lib, index, left, base, length):
    rows, occ, planes, offset = _single_table(index, left)
    lo = torch.zeros((base.shape[0], 6), dtype=torch.int32)
    count = torch.zeros_like(lo)
    lib.emu_interval_rank(
        _ptr(rows), _ptr(occ), _ptr(planes), offset, _ptr(base),
        _ptr(length), base.shape[0], _ptr(lo), _ptr(count))
    return lo, count


def emulate_extend(lib, index, left, cursors):
    rows, occ, planes, offset = _single_table(index, left)
    outs = [torch.zeros((cursors[0].shape[0], 6), dtype=torch.int32)
            for _ in range(3)]
    lib.emu_extend(
        _ptr(rows), _ptr(occ), _ptr(planes), offset, _ptr(index.C),
        *(_ptr(c) for c in cursors), cursors[0].shape[0],
        1 if left else 0, *(_ptr(t) for t in outs))
    return outs


@pytest.mark.parametrize("layout", LAYOUTS)
def test_interval_rank_and_extension_match_reference(indexes, layout,
                                                     emulation):
    """The g++ build of fm_interval_rank (K10's rank, one row when the
    interval lies in one block) and of fm_extend_all (K11's extension
    over it): lo is the reference's rank_all at
    the base and count its rank at base + length less lo, and the
    extensions equal the reference's extend_*_all, on cursors at every
    block edge and on seeded ones, in both directions."""
    _, ref_index, host, _ = indexes
    index = port_index(host, layout)
    rng = np.random.default_rng(12)
    n = host.n
    for left in (True, False):
        edges = _block_cursors(rng, n, left)
        lb = rng.integers(0, n, size=200)
        lb_rev = rng.integers(0, n, size=200)
        length = np.minimum(rng.integers(0, 300, size=200),
                            n - np.maximum(lb, lb_rev))
        cursors = [np.concatenate([e, s.astype(np.int32)]) for e, s in
                   zip(edges, (lb, lb_rev, length))]
        tensors = [torch.from_numpy(c) for c in cursors]
        base = tensors[0] if left else tensors[1]
        single = ref_index.fwd if left else ref_index.rev
        want_lo = np.asarray(ref.rank_all(single, jnp.asarray(base.numpy())))
        want_hi = np.asarray(ref.rank_all(single, jnp.asarray(
            (base + tensors[2]).numpy())))
        lo, count = emulate_interval(emulation, index, left, base,
                                     tensors[2])
        assert np.array_equal(lo.numpy(), want_lo)
        assert np.array_equal(count.numpy(), want_hi - want_lo)
        got = emulate_extend(emulation, index, left, tensors)
        for g, w in zip(got, _ref_extend(ref_index, left, cursors)):
            assert np.array_equal(g.numpy(), w)


# ------------------------------ K9's and K9x's schedules (csrc/fm_index.cu)

WARP = 32
PIECES = 8
GROUP = 8
MASK32 = 0xFFFFFFFF


def stage_schedule():
    """stage_rows' loads in the combined layout: for load k and lane l,
    (the warp's query whose row it reads, the 16-byte piece, the slot it
    stores the piece at): 8 lanes a row, lane l % 8's piece of query
    4 k + l / 8, at slot 8 i + (p ^ (i & 7))."""
    return [[(4 * k + lane // 8, lane % 8,
              8 * (4 * k + lane // 8) + ((lane % 8) ^ ((4 * k + lane // 8)
                                                      % 8)))
             for lane in range(WARP)] for k in range(PIECES)]


def staged_row_slot(lane, p):
    """staged_row's read p of the lane's own row."""
    return 8 * lane + (p ^ (lane % 8))


def mask_below(r, w):
    """fm_word_mask: word w keeps its clamp(r - 32 w, 0, 32) lowest bits."""
    below = np.clip(r - 32 * w, 0, 32).astype(np.int64)
    return ((np.int64(1) << below) - 1) & MASK32


def rank_words(words, r):
    """fm_rank_words on [B, 32] staged words: symbol s's checkpoint plus its
    four plane words' popcounts under the masks of r."""
    counts = np.zeros((words.shape[0], 6), dtype=np.int64)
    for s in range(6):
        counts[:, s] = words[:, 5 * s] + sum(
            np.bitwise_count(words[:, 5 * s + 1 + w] & mask_below(r, w))
            .astype(np.int64) for w in range(4))
    return counts


def stage_rows(rows, blocks, need, stage):
    """One stage_rows over every warp at once: blocks and need [warps, 32]
    (a query's row, and whether it is read); stage [warps, 256, 4] slots,
    of which those of rows not needed keep what they held."""
    for load in stage_schedule():
        for lane, (i, p, slot) in enumerate(load):
            take = need[:, i]
            stage[take, slot] = rows[blocks[take, i], 4 * p:4 * p + 4]


def staged_rows(stage):
    """Each lane's own row read back from its slots: [warps, 32, 32]."""
    words = np.empty(stage.shape[:1] + (WARP, 32), dtype=np.int64)
    for lane in range(WARP):
        for p in range(PIECES):
            words[:, lane, 4 * p:4 * p + 4] = stage[:, staged_row_slot(lane,
                                                                       p)]
    return words


def warp_blocks(values, B):
    """[B] -> [warps, 32], the warp's lanes past B at 0 (as a lane past the
    batch ranks position 0)."""
    warps = -(-B // WARP)
    out = np.zeros(warps * WARP, dtype=np.int64)
    out[:B] = values
    return out.reshape(warps, WARP)


def store_staged(values, B):
    """store_staged's [warps, 32, 6] -> the batch's [B, 6]: the warp's
    stage holds lane i's six at [6 i, 6 i + 6), and vector v (4 ints) of
    the warp's 48 goes out by lane v % 32."""
    warps = values.shape[0]
    stage = values.reshape(warps, WARP * 6)
    out = np.full(warps * WARP * 6, -1, dtype=np.int64)
    for v in range(WARP * 6 // 4):
        out_view = out.reshape(warps, WARP * 6)
        out_view[:, 4 * v:4 * v + 4] = stage[:, 4 * v:4 * v + 4]
    return out.reshape(-1, 6)[:B]


def _combined(single):
    rows = single.rank_rows.numpy().view(np.uint32).astype(np.int64)
    return rows, single.block_offset * 128


def emulate_k9_staged(single, positions):
    """K9 in the combined layout, warp by warp: the rows staged 8 lanes a
    row, each lane's rank from its own staged row, the outputs through the
    stage."""
    rows, offset = _combined(single)
    B = positions.shape[0]
    p = warp_blocks(positions.astype(np.int64) + offset, B)
    blocks, r = p // 128, p % 128
    stage = np.full((p.shape[0], WARP * PIECES, 4), -1, dtype=np.int64)
    stage_rows(rows, blocks, np.ones_like(blocks, dtype=bool), stage)
    words = staged_rows(stage)
    counts = rank_words(words.reshape(-1, 32), r.reshape(-1))
    return store_staged(counts.reshape(-1, WARP, 6), B)


def group_plane_rank(occ, planes, block, r):
    """The planes layout's group: lane s < 6 loads symbol s's checkpoint
    and 16-byte plane row and ranks that symbol alone; [B, 6]."""
    counts = np.zeros((block.shape[0], 6), dtype=np.int64)
    for lane in range(6):
        counts[:, lane] = occ[block, lane] + sum(
            np.bitwise_count(planes[block, lane, w] & mask_below(r, w))
            .astype(np.int64) for w in range(4))
    return counts


def _planes(single):
    return (single.occ.numpy().astype(np.int64),
            single.planes.numpy().view(np.uint32).astype(np.int64))


def emulate_k9_planes(single, positions):
    """K9 in the planes layout: a group of 8 lanes a query, lane s's count
    stored by lane s."""
    occ, planes = _planes(single)
    p = positions.astype(np.int64)
    return group_plane_rank(occ, planes, p // 128, p % 128)


def group_exclusive_prefix(values):
    """The planes group's shuffle-up scan of its 8 lanes (lanes 6, 7
    zero): at d = 1, 2, 4 lane j >= d adds lane j - d's running sum."""
    lanes = [values[:, j] if j < 6 else np.zeros_like(values[:, 0])
             for j in range(GROUP)]
    running = list(lanes)
    for d in (1, 2, 4):
        running = [running[j] + running[j - d] if j >= d else running[j]
                   for j in range(GROUP)]
    return np.stack([running[j] - lanes[j] for j in range(6)], axis=1)


def emulate_k9x(index, lb, lb_rev, length, left):
    """K9x, lane by lane: in the combined layout the warp stages its base
    rows and, in a second region, the end rows of the cursors whose
    interval ends in another block (the other slots there hold -1, which
    a lane that read them would rank); a one-row cursor ranks its end on
    its base row. In the
    planes layout the group of 8 lanes, the end's row read only for a
    two-row cursor, and the shuffle scan. Returns the three outputs and
    the share of one-row cursors."""
    single = index.fwd if left else index.rev
    B = lb.shape[0]
    lb, lb_rev, length = (a.astype(np.int64) for a in (lb, lb_rev, length))
    base, secondary = (lb, lb_rev) if left else (lb_rev, lb)
    if single.rank_rows is not None:
        rows, offset = _combined(single)
        p_lo = warp_blocks(base + offset, B)
        p_hi = warp_blocks(base + length + offset, B)
        block_lo, block_hi = p_lo // 128, p_hi // 128
        two_rows = block_hi != block_lo
        stage_lo, stage_hi = (np.full((p_lo.shape[0], WARP * PIECES, 4), -1,
                                      dtype=np.int64) for _ in range(2))
        stage_rows(rows, block_lo, np.ones_like(two_rows), stage_lo)
        stage_rows(rows, block_hi, two_rows, stage_hi)
        words_lo, words_hi = staged_rows(stage_lo), staged_rows(stage_hi)
        lo = rank_words(words_lo.reshape(-1, 32), (p_lo % 128).reshape(-1))
        words = np.where(two_rows[:, :, None], words_hi, words_lo)
        hi = rank_words(words.reshape(-1, 32), (p_hi % 128).reshape(-1))
        lo, hi = lo[:B], hi[:B]
        two = two_rows.reshape(-1)[:B]
    else:
        occ, planes = _planes(single)
        p_lo, p_hi = base, base + length
        block_lo, block_hi = p_lo // 128, p_hi // 128
        two = block_hi != block_lo
        lo = group_plane_rank(occ, planes, block_lo, p_lo % 128)
        row_hi = np.where(two, block_hi, block_lo)
        hi = group_plane_rank(occ, planes, row_hi, p_hi - row_hi * 128)
    count = hi - lo
    if single.rank_rows is not None:
        prefix = np.cumsum(count, axis=1) - count
    else:
        prefix = group_exclusive_prefix(count)
    primary = index.C.numpy()[:6].astype(np.int64)[None, :] + lo
    other = secondary[:, None] + prefix
    new_lb, new_lb_rev = (primary, other) if left else (other, primary)
    outputs = [new_lb, new_lb_rev, count]
    if single.rank_rows is not None:
        warps = -(-B // WARP)
        outputs = [store_staged(np.concatenate(
            [o, np.zeros((warps * WARP - B, 6), dtype=np.int64)]).reshape(
                warps, WARP, 6), B) for o in outputs]
    return [o.astype(np.int32) for o in outputs], float(np.mean(~two))


def test_stage_schedule_reads_each_piece_once_without_bank_conflicts():
    """stage_rows: every (query, piece) of the warp's 32 rows is loaded
    once, each load by 4 groups of 8 lanes that read 4 whole rows; each
    row's 8 slots are its own; the 8 lanes that write (or later read back
    their own rows) in one 16-byte shared-memory wavefront hit 8
    different bank quads; store_staged's 48 vectors cover the warp's
    [32, 6] outputs once."""
    schedule = stage_schedule()
    loaded = sorted((i, p) for load in schedule for i, p, _ in load)
    assert loaded == [(i, p) for i in range(WARP) for p in range(PIECES)]
    for load in schedule:
        rows = [i for i, _, _ in load]
        assert all(len(set(rows[8 * g:8 * g + 8])) == 1 for g in range(4))
        assert len(set(rows)) == 4
        for g in range(4):
            quads = {slot % 8 for _, _, slot in load[8 * g:8 * g + 8]}
            assert len(quads) == 8
    slots = sorted(slot for load in schedule for _, _, slot in load)
    assert slots == list(range(WARP * PIECES))
    for i in range(WARP):
        assert {staged_row_slot(i, p) for p in range(PIECES)} == set(
            range(8 * i, 8 * i + 8))
    for p in range(PIECES):
        for g in range(4):
            quads = {staged_row_slot(lane, p) % 8
                     for lane in range(8 * g, 8 * g + 8)}
            assert len(quads) == 8
    values = np.arange(2 * WARP * 6).reshape(2, WARP, 6)
    assert np.array_equal(store_staged(values, 2 * WARP - 5),
                          values.reshape(-1, 6)[:2 * WARP - 5])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_k9_schedule_matches_reference(indexes, layout):
    """K9's mirror (emulate_k9_staged in the combined layout,
    emulate_k9_planes in the planes layout) equals the reference's
    rank_rows_lookup_stacked or _rank_all_planes at random positions,
    every block edge and n, in both directions, the batch's last warp a
    partial one."""
    _, ref_index, host, _ = indexes
    index = port_index(host, layout)
    positions = _positions(np.random.default_rng(4), host.n)
    if positions.shape[0] % WARP == 0:
        positions = positions[:-1]
    for direction in ("fwd", "rev"):
        single = getattr(index, direction)
        ref_single = getattr(ref_index, direction)
        if layout == "combined":
            got = emulate_k9_staged(single, positions)
            want = ref.rank_rows_lookup_stacked(
                ref_index.rank_rows,
                jnp.asarray(positions + single.block_offset * 128))
        else:
            got = emulate_k9_planes(single, positions)
            want = ref._rank_all_planes(ref_single.occ, ref_single.planes,
                                        jnp.asarray(positions))
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_k9x_schedule_matches_reference(indexes, layout):
    """K9x's mirror (emulate_k9x) equals the reference's extend_left_all
    and extend_right_all on the block-edge cursors (one row and two) and
    on seeded ones, in both layouts."""
    _, ref_index, host, _ = indexes
    index = port_index(host, layout)
    rng = np.random.default_rng(13)
    n = host.n
    for left in (True, False):
        edges = _block_cursors(rng, n, left)
        lb = rng.integers(0, n, size=300)
        lb_rev = rng.integers(0, n, size=300)
        length = np.minimum(rng.integers(0, 80, size=300),
                            n - np.maximum(lb, lb_rev))
        cursors = [np.concatenate([e, s.astype(np.int32)]) for e, s in
                   zip(edges, (lb, lb_rev, length))]
        got, one_row = emulate_k9x(index, *cursors, left)
        assert 0.0 < one_row < 1.0
        for g, w in zip(got, _ref_extend(ref_index, left, cursors)):
            assert np.array_equal(g, w)


def test_search_cursors_follow_host_extend_left(indexes):
    """tools/fm_bench.search_cursors (K9x's search cursors, built for all
    seeds at once) records the cursors FmIndex.extend_left walks through
    for each pattern, from the root until the interval empties or the
    pattern ends, each once; limit and seed pick a seeded subset."""
    from floxer_tpu_torch.tools.fm_bench import search_cursors

    _, _, host, sequences = indexes
    rng = np.random.default_rng(14)
    text = sequences[0]
    patterns = [text[s:s + k] for s, k in zip(rng.integers(0, 200, 12),
                                              rng.integers(1, 30, 12))]
    patterns += [rng.integers(1, 5, size=25).astype(np.uint8)
                 for _ in range(4)]
    want = []
    for pattern in patterns:
        cursor = host.root_cursor()
        for symbol in reversed(pattern.tolist()):
            if cursor.length <= 0:
                break
            want.append((cursor.lb, cursor.lb_rev, cursor.length))
            cursor = host.extend_left(cursor, int(symbol))
    got = search_cursors(host, patterns, limit=10**6, seed=3)
    assert got.dtype == np.int32 and got.shape == (3, len(want))
    assert sorted(map(tuple, got.T.tolist())) == sorted(want)
    subset = search_cursors(host, patterns, limit=7, seed=3)
    assert np.array_equal(subset, got[:, :7])
