"""The control of the check: the reference put in the program's place with
one guarantee broken, judged as a run's jobs are.

    python3 -m benchmark.control --workload <name> --seed <n> [--seed <n> ...]

For each seed it draws the cell's first job of reads as a run does and
judges, with the same sample size as a run, the SAM of two aligners that
break a guarantee of the configuration: `suboptimal` reports each read's
own simulated path from its origin (valid alignments, every origin found,
but not the least edit distance: floxer's exactness broken);
`forward_only` does the same but searches only the forward strand, so a
reverse read is unmapped (every alignment is no longer reported). It
prints one JSON line a seed and control with the numbers compared;
`correct` has to come out false on each. It needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from . import manifest, reference, simulate
from .client import Reply
from .run import Job, RunFailed, judge, refuse_forbidden_modules

CONTROLS = ("suboptimal", "forward_only")


def control_numbers(cell: manifest.Cell, seed: int, workdir: Path,
                    control: str = "suboptimal") -> dict:
    spec = cell.config["genome"]
    traffic = cell.traffic
    genome = simulate.make_genome(spec["chromosome_length"],
                                  spec["num_chromosomes"], spec["seed"])
    reads = simulate.make_reads(
        genome, traffic["reads_per_job"], traffic["read_length"],
        traffic["error_rate"], traffic["reverse_share"],
        simulate.seed_rng(seed, 1, 0),
    )
    sam = workdir / f"control{seed}.sam"
    reference.truth_sam(sam, genome, reads,
                        forward_only=control == "forward_only")
    judgement = judge(genome, [(reads, None)],
                      [Job(len(reads), Reply(0), sam, 0)], traffic, seed)
    numbers = judgement.numbers()
    return {
        "seed": seed,
        "control": control,
        "correct": all(numbers[name] <= reference.LIMITS[name]
                       for name in numbers),
        "optimum_checked": judgement.optimum_checked,
        "check": {name: {"value": numbers[name],
                         "limit": reference.LIMITS[name]}
                  for name in numbers},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, action="append", required=True)
    args = parser.parse_args(argv)
    cell = manifest.load_cell(Path.cwd() / "BENCHMARK.json", args.workload)
    with tempfile.TemporaryDirectory(prefix="fxc") as workdir:
        lines = [json.dumps(control_numbers(cell, seed, Path(workdir), control))
                 for seed in args.seed for control in CONTROLS]
    try:
        refuse_forbidden_modules()
    except RunFailed as error:
        print(f"control: no result: {error}", file=sys.stderr)
        return 1
    for line in lines:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
