"""Genomes and simulated long reads, drawn from seeds.

A vectorised copy of floxer_tpu_torch/tools/simulated_dataset.py's
`create` (floxer's simulated_dataset.cpp): a uniform-random genome, and
reads cut from it at a uniform start with exactly floor(rate * length)
distinct positions mutated, each a mismatch, an insertion or a deletion
with equal chance. A mismatch always changes the base; an insertion keeps
the origin base and puts a random base after it; a deletion drops the
base. The truth is carried in the read's name,
`id_<i>_chromosome_<c>_position_<start>_max_errors_<n>`, as the tool
writes it. The draws are vectorised, so the random stream differs from
the tool's; the distribution and the names do not.

One departure: the tool reads every read off the forward strand, while a
sequencer reads both. Here a share of the reads (the traffic's
`reverse_share`), drawn from the seed, is the reverse complement of its
mutated origin, and `Read.reverse` records it; the name stays the tool's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CHARS = np.frombuffer(b"ACGT", dtype=np.uint8)
COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.uint8)
MISMATCH, INSERTION, DELETION = 0, 1, 2
FASTA_LINE = 80


def seed_rng(*keys: int) -> np.random.Generator:
    """A generator keyed by whole numbers of any sign and size."""
    return np.random.default_rng(
        np.random.SeedSequence([int(k) % (1 << 64) for k in keys])
    )


def make_genome(chromosome_length: int, num_chromosomes: int,
                seed: int) -> list[tuple[str, np.ndarray]]:
    """[(name, ranks uint8 in 0..3)], as simulated_dataset names them."""
    rng = seed_rng(seed)
    return [
        (f"chromosome_{i}",
         rng.integers(0, 4, size=chromosome_length, dtype=np.uint8))
        for i in range(num_chromosomes)
    ]


def write_fasta(path, genome) -> None:
    with open(path, "wb") as handle:
        for name, ranks in genome:
            handle.write(f">{name}\n".encode())
            chars = CHARS[ranks]
            full = len(chars) // FASTA_LINE * FASTA_LINE
            lines = np.empty((full // FASTA_LINE, FASTA_LINE + 1), np.uint8)
            lines[:, :FASTA_LINE] = chars[:full].reshape(-1, FASTA_LINE)
            lines[:, FASTA_LINE] = ord("\n")
            handle.write(lines.tobytes())
            if full < len(chars):
                handle.write(chars[full:].tobytes() + b"\n")


@dataclass
class Read:
    name: str
    ranks: np.ndarray  # uint8 in 0..3
    chromosome: int
    start: int
    num_errors: int
    # the generator's own path on the origin's forward strand: mutated
    # offsets into the origin and their kinds
    offsets: np.ndarray
    kinds: np.ndarray
    # the read is the reverse complement of its mutated origin
    reverse: bool = False


def mutate(origin: np.ndarray, num_errors: int, rng: np.random.Generator):
    """simulated_dataset.mutate_read on one origin segment; returns
    (read, sorted offsets, their kinds)."""
    length = len(origin)
    offsets = np.sort(rng.choice(length, size=num_errors, replace=False))
    kinds = rng.integers(0, 3, size=num_errors)
    read = origin.copy()
    mismatched = offsets[kinds == MISMATCH]
    read[mismatched] = (
        read[mismatched] + rng.integers(1, 4, size=len(mismatched))
    ) % 4
    counts = np.ones(length, dtype=np.int64)
    counts[offsets[kinds == DELETION]] = 0
    inserted = offsets[kinds == INSERTION]
    counts[inserted] = 2
    out = np.repeat(read, counts)
    out[np.cumsum(counts)[inserted] - 1] = rng.integers(
        0, 4, size=len(inserted), dtype=np.uint8
    )
    return out, offsets, kinds


def make_reads(genome, num_reads: int, read_length: int, error_rate: float,
               reverse_share: float, rng: np.random.Generator) -> list[Read]:
    num_errors = int(error_rate * read_length)
    reads = []
    for read_id in range(num_reads):
        chromosome = int(rng.integers(0, len(genome)))
        ranks = genome[chromosome][1]
        start = int(rng.integers(0, len(ranks) - read_length))
        out, offsets, kinds = mutate(
            ranks[start:start + read_length], num_errors, rng
        )
        reverse = bool(rng.random() < reverse_share)
        if reverse:
            out = COMPLEMENT[out[::-1]]
        name = (f"id_{read_id}_chromosome_{chromosome}"
                f"_position_{start}_max_errors_{num_errors}")
        reads.append(Read(name, out, chromosome, start, num_errors,
                          offsets, kinds, reverse))
    return reads


def write_fastq(path, reads: list[Read]) -> None:
    with open(path, "wb") as handle:
        for read in reads:
            handle.write(b"@" + read.name.encode() + b"\n")
            handle.write(CHARS[read.ranks].tobytes())
            handle.write(b"\n+\n" + b"I" * len(read.ranks) + b"\n")


def parse_truth(name: str) -> tuple[int, int, int, int]:
    """(read id, chromosome, start, max errors) from a truth name, as
    simulated_dataset.parse_query_id reads it."""
    parts = name.split("_")
    if (len(parts) != 9 or parts[0] != "id" or parts[2] != "chromosome"
            or parts[4] != "position" or parts[6:8] != ["max", "errors"]):
        raise ValueError(f"not a simulated read name: {name!r}")
    return int(parts[1]), int(parts[3]), int(parts[5]), int(parts[8])
