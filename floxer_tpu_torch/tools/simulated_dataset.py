# Copied from floxer_tpu/tools/simulated_dataset.py; relative imports resolve to this package's copies.
"""Simulate a genome + noisy long reads; verify an aligner's output.

Parity target: src/main/simulated_dataset.cpp. Two subcommands:

  create  — uniform-random genome (default 10 chromosomes x 50 Mb) and reads
            (default 8000 x 20 kb at 7% exact edit-distance mutations); the
            truth is encoded in read names
            id_X_chromosome_Y_position_Z_max_errors_W
            (simulated_dataset.cpp:207-213). Mutation semantics match the
            reference: exactly floor(rate*len) distinct read indices get a
            mutation, kind uniform over {mismatch, insertion, deletion};
            mismatches always change the base; insertions keep the origin
            base and append a random one (simulated_dataset.cpp:123-205).
  verify  — parse an aligner's SAM against those names and classify each
            read FoundOptimal / FoundSuboptimal(pos diffs) / NotFound as
            TOML (simulated_dataset.cpp:383-472).

This pair is the large-scale accuracy regression harness for the exactness
property (README.md:10).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

DNA4 = "ACGT"


def create_genome(chromosome_length, num_chromosomes, rng):
    return [
        (
            f"chromosome_{i}",
            rng.integers(0, 4, size=chromosome_length).astype(np.uint8),
        )
        for i in range(num_chromosomes)
    ]


def _ranks_to_str(ranks) -> str:
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return lut[ranks].tobytes().decode()


def mutate_read(chromosome, start, base_read_length, num_errors, rng):
    """Apply the reference's mutation scheme; returns the read rank array."""
    read_indices = np.arange(start, start + base_read_length)
    mutation_indices = rng.choice(
        read_indices, size=num_errors, replace=False
    )
    mutations = {}
    for index in mutation_indices:
        kind = int(rng.integers(0, 3))  # 0 mismatch, 1 insertion, 2 deletion
        origin_rank = int(chromosome[index])
        if kind == 0:
            generated = int(rng.integers(0, 3))
            new_rank = generated + 1 if generated >= origin_rank else generated
        elif kind == 1:
            new_rank = int(rng.integers(0, 4))
        else:
            new_rank = 0
        mutations[int(index)] = (kind, new_rank)

    out = []
    for index in range(start, start + base_read_length):
        origin = int(chromosome[index])
        if index not in mutations:
            out.append(origin)
            continue
        kind, new_rank = mutations[index]
        if kind == 0:
            out.append(new_rank)
        elif kind == 1:
            out.append(origin)
            out.append(new_rank)
        # deletion: skip
    return np.array(out, dtype=np.uint8)


def create_dataset(args) -> int:
    if args.chromosome_length <= args.read_length:
        print(
            f"Chromosome length {args.chromosome_length} must be larger than "
            f"read length {args.read_length}",
            file=sys.stderr,
        )
        return -1

    rng = np.random.default_rng(args.random_seed)
    genome = create_genome(args.chromosome_length, args.num_chromosomes, rng)

    with open(args.genomes, "w") as handle:
        for name, sequence in genome:
            handle.write(f">{name}\n")
            seq = _ranks_to_str(sequence)
            for i in range(0, len(seq), 80):
                handle.write(seq[i : i + 80] + "\n")

    num_errors = int(args.error_rate * args.read_length)
    with open(args.reads, "w") as handle:
        for read_id in range(args.num_reads):
            chromosome_index = int(rng.integers(0, len(genome)))
            chromosome = genome[chromosome_index][1]
            start = int(
                rng.integers(0, args.chromosome_length - args.read_length)
            )
            read = mutate_read(
                chromosome, start, args.read_length, num_errors, rng
            )
            name = (
                f"id_{read_id}_chromosome_{chromosome_index}"
                f"_position_{start}_max_errors_{num_errors}"
            )
            handle.write(f"@{name}\n{_ranks_to_str(read)}\n+\n")
            handle.write("I" * len(read) + "\n")
    return 0


def parse_query_id(query_id: str):
    parts = query_id.split("_")
    assert parts[0] == "id" and parts[2] == "chromosome"
    assert parts[4] == "position" and parts[6] == "max" and parts[7] == "errors"
    return int(parts[3]), int(parts[5]), int(parts[8])


def parse_chromosome_id(name: str) -> int:
    return int(name.split("_", 1)[1])


def verify_alignments(args) -> int:
    """Classify every aligned read against its simulated origin (TOML).
    Accepts SAM or BAM (the reference reads both via seqan3)."""
    from ..io.sam import read_alignment_records

    alignments_by_query: dict[str, list[tuple[int, int, int]]] = {}
    for record in read_alignment_records(args.alignments):
        if record["flag"] & 4:
            continue
        alignments_by_query.setdefault(record["qname"], []).append(
            (
                parse_chromosome_id(record["rname"]),
                record["pos"],
                int(record["tags"].get("NM", 0)),
            )
        )

    big = (1 << 32) - 1
    print("queries = [")
    for query_id, alignments in alignments_by_query.items():
        chromosome_id, position, max_num_errors = parse_query_id(query_id)
        pos_diff = big
        pos_diff_higher = big
        for chrom, pos, errors in alignments:
            if chrom != chromosome_id:
                continue
            diff = abs(position - pos)
            if errors > max_num_errors:
                pos_diff_higher = min(diff, pos_diff_higher)
            else:
                pos_diff = min(diff, pos_diff)
            if pos_diff == 0:
                break
        if pos_diff <= args.allowed_pos_diff:
            status = "FoundOptimal = {}"
        elif pos_diff == big and pos_diff_higher == big:
            status = "NotFound = {}"
        else:
            status = (
                "FoundSuboptimal = { "
                f"pos_diff_expected_num_errors = {pos_diff}, "
                f"pos_diff_higher_num_errors = {pos_diff_higher} }}"
            )
        print(f'    {{ id = "{query_id}", status = {{ {status} }} }},')
    print("]")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="simulated_dataset",
        description="Simulate a genome and long reads, then verify whether "
        "an aligner mapped the reads correctly.",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    create = sub.add_parser("create")
    create.add_argument("-g", "--genomes", required=True)
    create.add_argument("-r", "--reads", required=True)
    create.add_argument(
        "-c", "--chromosome-length", type=int, default=50_000_000
    )
    create.add_argument("-n", "--num-chromosomes", type=int, default=10)
    create.add_argument("-l", "--read-length", type=int, default=20_000)
    create.add_argument("-m", "--num-reads", type=int, default=8000)
    create.add_argument("-e", "--error-rate", type=float, default=0.07)
    create.add_argument("-s", "--random-seed", type=int, default=7267281)

    verify = sub.add_parser("verify")
    verify.add_argument("-a", "--alignments", required=True)
    verify.add_argument("-p", "--allowed-pos-diff", type=int, default=0)

    args = parser.parse_args(argv)
    if args.command == "create":
        return create_dataset(args)
    return verify_alignments(args)


if __name__ == "__main__":
    sys.exit(main())
