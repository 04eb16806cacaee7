"""The vectorised read generator against floxer's simulation rules."""

import numpy as np
import pytest

from benchmark import simulate
from floxer_tpu_torch.tools import simulated_dataset


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Global edit distance, a row of the DP at a time."""
    row = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        diagonal = row[:-1] + (b != a[i - 1])
        new = np.empty_like(row)
        new[0] = i
        new[1:] = np.minimum(diagonal, row[1:] + 1)
        np.minimum.accumulate(new - np.arange(len(new)), out=new)
        row = new + np.arange(len(new))
    return int(row[-1])


def test_edit_distance_matches_a_plain_loop():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.integers(0, 4, rng.integers(0, 12))
        b = rng.integers(0, 4, rng.integers(0, 12))
        table = [[i + j if i * j == 0 else 0 for j in range(len(b) + 1)]
                 for i in range(len(a) + 1)]
        for i in range(1, len(a) + 1):
            for j in range(1, len(b) + 1):
                table[i][j] = min(table[i - 1][j] + 1, table[i][j - 1] + 1,
                                  table[i - 1][j - 1] + (a[i - 1] != b[j - 1]))
        assert edit_distance(a, b) == table[-1][-1]


def test_reads_are_deterministic_in_their_seed():
    genome = simulate.make_genome(5000, 2, 7)
    again = simulate.make_genome(5000, 2, 7)
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(genome, again))
    first = simulate.make_reads(genome, 5, 300, 0.07, 0.5,
                                simulate.seed_rng(2**31 + 5, 1, 0))
    second = simulate.make_reads(genome, 5, 300, 0.07, 0.5,
                                 simulate.seed_rng(2**31 + 5, 1, 0))
    other = simulate.make_reads(genome, 5, 300, 0.07, 0.5,
                                simulate.seed_rng(2**31 + 6, 1, 0))
    assert [r.name for r in first] == [r.name for r in second]
    assert [r.reverse for r in first] == [r.reverse for r in second]
    assert all(np.array_equal(a.ranks, b.ranks)
               for a, b in zip(first, second))
    assert [r.name for r in first] != [r.name for r in other]


def forward(read) -> np.ndarray:
    """The read on its origin's forward strand, by a plain loop."""
    if not read.reverse:
        return read.ranks
    return np.array([3 - int(rank) for rank in read.ranks[::-1]], np.uint8)


def test_every_read_is_within_its_mutations_of_its_origin():
    genome = simulate.make_genome(20000, 2, 3)
    reads = simulate.make_reads(genome, 30, 200, 0.07, 0.5,
                                simulate.seed_rng(11))
    assert 0 < sum(read.reverse for read in reads) < len(reads)
    for read in reads:
        origin = genome[read.chromosome][1][read.start:read.start + 200]
        on_origin = forward(read)
        assert read.num_errors == 14
        assert len(np.unique(read.offsets)) == read.num_errors
        assert edit_distance(on_origin, origin) <= read.num_errors
        assert len(read.ranks) == 200 + int((read.kinds == 1).sum()) - int(
            (read.kinds == 2).sum())
        # a mismatch always changes the base: origin offset o sits at
        # o + (insertions before o) - (deletions before o) in the read
        inserted = read.offsets[read.kinds == 1]
        deleted = read.offsets[read.kinds == 2]
        for offset in read.offsets[read.kinds == 0]:
            at = (offset + np.searchsorted(inserted, offset)
                  - np.searchsorted(deleted, offset))
            assert on_origin[at] != origin[offset]


@pytest.mark.parametrize("share, expect", [(0.0, (0, 0)), (1.0, (400, 400)),
                                           (0.5, (160, 240))])
def test_the_reverse_share_is_drawn_from_the_seed(share, expect):
    genome = simulate.make_genome(5000, 1, 4)
    reads = simulate.make_reads(genome, 400, 50, 0.0, share,
                                simulate.seed_rng(2**31 + 17))
    reverse = sum(read.reverse for read in reads)
    assert expect[0] <= reverse <= expect[1]
    for read in reads:
        origin = genome[0][1][read.start:read.start + 50]
        assert np.array_equal(forward(read), origin)


def test_truth_names_parse_as_the_tool_writes_them():
    genome = simulate.make_genome(5000, 3, 1)
    for read in simulate.make_reads(genome, 10, 100, 0.05, 0.5,
                                    simulate.seed_rng(1)):
        read_id, chromosome, start, errors = simulate.parse_truth(read.name)
        assert simulated_dataset.parse_query_id(read.name) == (
            chromosome, start, errors)
        assert (chromosome, start, errors) == (
            read.chromosome, read.start, read.num_errors)
        assert read.name.startswith(f"id_{read_id}_")


def test_files_hold_the_reads(tmp_path):
    from floxer_tpu_torch.io.sequence_io import read_references

    genome = simulate.make_genome(1001, 2, 9)
    simulate.write_fasta(tmp_path / "g.fasta", genome)
    records = read_references(str(tmp_path / "g.fasta")).records
    assert [r.id for r in records] == [name for name, _ in genome]
    for record, (_, ranks) in zip(records, genome):
        assert np.array_equal(record.rank_sequence, ranks + 1)
    reads = simulate.make_reads(genome, 3, 100, 0.07, 0.5,
                                simulate.seed_rng(4))
    simulate.write_fastq(tmp_path / "r.fastq", reads)
    lines = (tmp_path / "r.fastq").read_text().splitlines()
    assert lines[0] == "@" + reads[0].name
    assert lines[1] == simulate.CHARS[reads[0].ranks].tobytes().decode()
    assert lines[3] == "I" * len(reads[0].ranks)
