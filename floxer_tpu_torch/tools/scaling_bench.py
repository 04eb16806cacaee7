# Copied from floxer_tpu/tools/scaling_bench.py; spawns python -m floxer_tpu_torch instead of floxer_tpu.
"""Multi-host scaling harness: run N strided shards, merge, and report
align-phase scaling efficiency (BASELINE.md north star: >= 0.8).

Each shard is a separate aligner process with --num-hosts N --host-id i —
exactly the per-host invocation on a pod slice, here launched locally so
the efficiency of the sharding + merge path is measurable anywhere.

Two modes:
  sequential (default): shards run one after another, each getting the
    whole machine — the faithful single-machine proxy for N pod hosts
    that each own their cores/chip. The pod wall-clock estimate is the
    SLOWEST shard's align phase plus the merge; efficiency =
    (single_align / N) / (max(shard_align) + merge_seconds).
  concurrent: shards run simultaneously on this one machine — measures
    that nothing serializes in the sharding/merge path, but the N
    processes contend for the same cores, so the efficiency number
    reflects this machine's core count, not pod behavior.

Timing uses the align phase as reported by the aligner itself ("finished
aligning successfully in X seconds"), excluding per-process index
load/build — on a pod those are one-time per-host costs amortized over
production-size workloads (and the reference pays index load per run just
the same, floxer.cpp:62-107).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

_ALIGN_RE = re.compile(r"finished aligning successfully in ([0-9.]+) seconds")


def _spawn(base_args, output, num_hosts, host_id):
    # stderr goes to a tempfile, NOT a pipe: in concurrent mode a pipe
    # would fill at 64 KB while earlier shards are being awaited, stalling
    # the shard mid-align and corrupting its self-reported timing
    import tempfile

    log = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "floxer_tpu_torch",
            *base_args,
            "--output", output,
            "--num-hosts", str(num_hosts),
            "--host-id", str(host_id),
        ],
        stdout=subprocess.DEVNULL,
        stderr=log,
        text=True,
    )
    proc._shard_log = log  # type: ignore[attr-defined]
    return proc


def _finish(proc) -> float:
    """Wait for a shard; return its align-phase seconds."""
    proc.wait()
    log = proc._shard_log  # type: ignore[attr-defined]
    log.seek(0)
    stderr = log.read()
    log.close()
    if proc.returncode != 0:
        raise RuntimeError(
            f"shard failed with {proc.returncode}:\n{stderr[-2000:]}"
        )
    match = _ALIGN_RE.search(stderr)
    if not match:
        raise RuntimeError(f"no align timing in shard log:\n{stderr[-2000:]}")
    return float(match.group(1))


def run_shards(num_hosts, base_args, output_prefix, concurrent=False):
    """Returns (outputs, align_seconds_per_shard)."""
    outputs = [
        f"{output_prefix}.shard{host_id}.sam" for host_id in range(num_hosts)
    ]
    times: list[float] = []
    if concurrent:
        procs = [
            _spawn(base_args, outputs[i], num_hosts, i)
            for i in range(num_hosts)
        ]
        times = [_finish(proc) for proc in procs]
    else:
        for host_id in range(num_hosts):
            proc = _spawn(base_args, outputs[host_id], num_hosts, host_id)
            times.append(_finish(proc))
    return outputs, times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="scaling_bench")
    parser.add_argument("-r", "--reference", required=True)
    parser.add_argument("-q", "--queries", required=True)
    parser.add_argument("-o", "--output-prefix", required=True)
    parser.add_argument("-n", "--num-hosts", type=int, default=2)
    parser.add_argument("-p", "--error-probability", default="0.07")
    parser.add_argument("-i", "--index", default=None)
    parser.add_argument(
        "--mode", choices=("sequential", "concurrent"), default="sequential",
        help="sequential = faithful per-host proxy (each shard gets the "
        "whole machine); concurrent = all shards at once on this machine",
    )
    parser.add_argument(
        "--extra",
        default="--interval-optimization",
        help="extra aligner arguments as one space-separated string",
    )
    parser.add_argument(
        "--no-warmup", dest="warmup", action="store_false", default=True,
        help="skip the discarded warmup run that pre-fills the kernel "
        "compilation cache before the timed single-host baseline",
    )
    args = parser.parse_args(argv)

    base = [
        "--reference", args.reference,
        "--queries", args.queries,
        *(
            ["--error-probability", args.error_probability]
            if "--query-errors" not in args.extra
            else []
        ),
        *args.extra.split(),
    ]
    if args.index:
        base += ["--index", args.index]

    num_queries = sum(
        1 for line in open(args.queries) if line.startswith("@")
    )

    if args.warmup:
        # one discarded single run first: the native library and the CUDA
        # kernels build once into build/, so without this the FIRST timed
        # run (the single-host baseline) pays all builds while the later
        # shard runs find them built — inflating efficiency
        run_shards(1, base, args.output_prefix + ".warmup")

    _, single_times = run_shards(1, base, args.output_prefix + ".single")
    single_align = single_times[0]

    concurrent = args.mode == "concurrent"
    outputs, shard_times = run_shards(
        args.num_hosts, base, args.output_prefix, concurrent=concurrent
    )
    pod_wall = max(shard_times)

    from ..parallel.multihost import merge_sam_shards

    merge_started = time.monotonic()
    merge_sam_shards(outputs, f"{args.output_prefix}.merged.sam")
    merge_seconds = time.monotonic() - merge_started

    single_rps = num_queries / single_align
    sharded_rps = num_queries / (pod_wall + merge_seconds)
    efficiency = sharded_rps / (single_rps * args.num_hosts)

    print(
        json.dumps(
            {
                "mode": args.mode,
                "num_hosts": args.num_hosts,
                "num_queries": num_queries,
                "single_align_seconds": round(single_align, 3),
                "shard_align_seconds": [round(t, 3) for t in shard_times],
                "merge_seconds": round(merge_seconds, 3),
                "single_host_reads_per_s": round(single_rps, 3),
                "sharded_reads_per_s_per_host_ideal": round(
                    single_rps, 3
                ),
                "pod_reads_per_s_estimate": round(sharded_rps, 3),
                "scaling_efficiency": round(efficiency, 3),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
