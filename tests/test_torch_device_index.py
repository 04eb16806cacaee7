"""The port's device FM index (floxer_tpu_torch.index.device_index: K9,
K9x, K9l's plain versions on the CPU) against the reference's
(floxer_tpu.index.device_index, XLA on the CPU) and the host index.

Each package builds its own FmIndex from the same numpy sequences, made
from a seed; every comparison is integer equality (tolerance 0), in the
combined rank-row layout and in the per-direction planes layout.
"""

import types

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
