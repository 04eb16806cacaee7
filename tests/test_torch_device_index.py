"""The port's device FM index (floxer_tpu_torch.index.device_index: K9,
K9x, K9l's plain versions on the CPU) against the reference's
(floxer_tpu.index.device_index, XLA on the CPU) and the host index.

Each package builds its own FmIndex from the same numpy sequences, made
from a seed; every comparison is integer equality (tolerance 0), in the
combined rank-row layout and in the per-direction planes layout. K9l's
per-row functions (csrc/fm_rank.cuh: the sampled-row plane's lookup and
the locate walk over it) are built with g++ here and held to the
reference's _sample_lookup and locate_batch on every row.
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
    """The g++ build of csrc/fm_rank.cuh's locate functions (ctypes)."""
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
