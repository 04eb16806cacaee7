"""The plain reference: its pieces against plain loops, and the control,
which has to come out not correct."""

import numpy as np
import pytest

from benchmark import reference, simulate
from benchmark.control import control_numbers
from benchmark.manifest import Cell


def plain_least_distance(pattern, text) -> int:
    """Semi-global edit distance by the full table."""
    previous = [0] * (len(text) + 1)
    for i, p in enumerate(pattern, 1):
        row = [i] + [0] * len(text)
        for j, t in enumerate(text, 1):
            row[j] = min(previous[j] + 1, row[j - 1] + 1,
                         previous[j - 1] + (p != t))
        previous = row
    return min(previous)


def test_least_edit_distance_matches_the_full_table():
    rng = np.random.default_rng(1)
    for _ in range(40):
        text = rng.integers(0, 4, int(rng.integers(1, 40))).astype(np.uint8)
        pattern = rng.integers(0, 4, int(rng.integers(1, 30))).astype(np.uint8)
        assert reference.least_edit_distance(pattern, text) == \
            plain_least_distance(pattern.tolist(), text.tolist())
    long = rng.integers(0, 4, 300).astype(np.uint8)
    assert reference.least_edit_distance(long[50:250], long) == 0


@pytest.mark.parametrize("cigar, pos, expect", [
    ("4=", 2, (0, 4)),
    ("2=1X1=", 2, (1, 4)),
    ("2=1I1=", 2, (1, 3)),
    ("2=1D2=", 2, (1, 5)),
    ("4=", 1, None),  # a match column that mismatches
    ("1X3=", 2, None),  # a mismatch column that matches
    ("3=", 2, None),  # does not consume the read
    ("4M", 2, None),  # only =, X, I and D
    ("4=", 7, None),  # runs off the reference
    ("2=x2=", 2, None),
])
def test_cigar_is_laid_over_read_and_reference(cigar, pos, expect):
    ref = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.uint8)
    read = {"2=1X1=": [2, 3, 1, 1], "2=1I1=": [2, 3, 2, 0],
            "2=1D2=": [2, 3, 1, 2]}.get(cigar, [2, 3, 0, 1])
    assert reference.cigar_edits(cigar, np.array(read, np.uint8), ref,
                                 pos) == expect


def test_error_budget_is_floxers_ceiling():
    assert reference.error_budget(100, 0.07) == 7
    assert reference.error_budget(500, 0.01) == 5
    assert reference.error_budget(20000, 0.08) == 1600
    assert reference.error_budget(20001, 0.08) == 1601


def tiny_cell(sample: int) -> Cell:
    return Cell(
        name="tiny", chips=1,
        config={"genome": {"chromosome_length": 200000,
                           "num_chromosomes": 2, "seed": 5}},
        traffic={"reads_per_job": 40, "read_length": 2000,
                 "error_rate": 0.07, "reverse_share": 0.5,
                 "argv": ["-p", "0.08"],
                 "optimum_sample": sample},
        end_to_end=[], per_layer=[],
    )


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 11])
def test_the_control_is_not_correct(tmp_path, seed):
    """The generator's own path in place of the least-edit alignment:
    valid records, every origin found on its strand, NM above the
    optimum."""
    out = control_numbers(tiny_cell(sample=20), seed, tmp_path)
    check = out["check"]
    assert out["correct"] is False
    assert check["nm_gap_max"]["value"] > check["nm_gap_max"]["limit"]
    assert check["missing_reads"]["value"] == 0
    assert check["origin_missed"]["value"] == 0
    assert check["record_faults"]["value"] == 0
    assert out["optimum_checked"] == 20


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_a_forward_only_control_is_not_correct(tmp_path, seed):
    """An aligner that searches only the forward strand: the reverse
    reads are unmapped, so their origins are missed."""
    out = control_numbers(tiny_cell(sample=20), seed, tmp_path,
                          "forward_only")
    check = out["check"]
    assert out["correct"] is False
    assert check["missing_reads"]["value"] == 0
    assert check["record_faults"]["value"] == 0
    assert 8 <= check["origin_missed"]["value"] <= 32


def test_records_that_break_the_rules_are_counted(tmp_path):
    genome = simulate.make_genome(50000, 1, 2)
    reads = simulate.make_reads(genome, 6, 500, 0.07, 0.5,
                                simulate.seed_rng(3))
    assert any(read.reverse for read in reads)
    reference.truth_sam(tmp_path / "t.sam", genome, reads)
    records = reference.read_sam(tmp_path / "t.sam")
    names = {read.name for read in reads}
    sound = reference.judge_job(genome, reads, records, 0.08, set())
    assert sound.numbers() == {"missing_reads": 0, "origin_missed": 0,
                               "record_faults": 0, "nm_gap_max": 0}
    records[0].nm += 1
    records[1].pos += 1
    records[2].seq = records[2].seq[::-1]
    del records[3]
    records[4].flag ^= reference.FLAG_REVERSE  # the other strand
    broken = reference.judge_job(genome, reads, records, 0.08, names)
    assert broken.missing_reads == 1
    assert broken.record_faults == 4
    assert broken.origin_missed == 4  # 0, 1, 4 fail, 3 is missing
    assert broken.optimum_checked == 2
