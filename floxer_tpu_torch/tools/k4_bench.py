"""Time the batched device traceback (K4) on seeded root tasks.

    python -m floxer_tpu_torch.tools.k4_bench [--shapes root20k,mixed]
        [--repeats 3] [--seed 20261016]

For each shape it makes the tasks (`root_tasks`: windows of a seeded
random genome, each pattern a slice of its window with substitutions,
insertions and deletions at the shape's rate, end column and distance
from the native Myers engine, tasks over the shape's budget dropped),
calls ops.traceback_device.banded_cigar_traceback_device_batch on cuda:0
once to warm up, then `repeats` times, and prints one JSON line a shape:
the call's wall seconds (mean; each call ends with its results on the
host), its kernel launches, the card time of the traceback kernels in one
call (torch.profiler), the tasks' band widths, and whether every result
equals the native host traceback (dp_reference.banded_cigar_traceback).

It calls only that entry, the native engine and the host traceback, which
every version of the port has, so it times another checkout's K4 on the
same tasks when that checkout is first on the path:

    PYTHONPATH=<checkout> python floxer_tpu_torch/tools/k4_bench.py

Exits non-zero, printing nothing, without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20261016
GENOME_BP = 400_000
# shape: (tasks, pattern length, error rate, distance budget): the 20 kb
# reads' PEX roots at the aligner's -p 0.07 (chip_smoke.py's root batch),
# 30, 40 and 80 kb roots at -p 0.15 (bands of ~6900, ~10500 and ~21000
# cells: K4's 16- and 32-cell register layouts and its 64-cell shared-row
# one); "mixed" is root20k's batch with one root40k task in place of its
# last
SHAPES = {
    "root20k": (128, 20_600, 0.066, 1_442),
    "root30k": (8, 30_000, 0.12, 4_500),
    "root40k": (8, 40_000, 0.14, 6_000),
    "root80k": (4, 80_000, 0.14, 12_000),
}
MIXED = "mixed"


def mutate(rng, seq, rate):
    """Substitutions, insertions and deletions at `rate` per char."""
    out = []
    for ch in seq:
        r = rng.random()
        if r < rate / 3:
            out.append(1 + (int(ch) % 4))
        elif r < 2 * rate / 3:
            out.append(int(ch))
            out.append(int(rng.integers(1, 5)))
        elif r >= rate:
            out.append(int(ch))
    return np.asarray(out, dtype=np.uint8)


def root_tasks(rng, count, m, rate, budget, genome=None):
    """Up to `count` (window, pattern, end_col, distance) root tasks: a
    window of m + 2 budget + 1 chars and up to 1200 more, the pattern m
    chars of a mutated slice of it; the tasks whose distance is within
    the budget."""
    from floxer_tpu_torch.native import native_myers_distance_batch

    if genome is None:
        genome = rng.integers(1, 5, size=GENOME_BP).astype(np.uint8)
    windows, patterns = [], []
    for _ in range(count):
        n = m + 2 * budget + 1 + int(rng.integers(0, 1200))
        start = int(rng.integers(0, len(genome) - n))
        window = genome[start : start + n]
        offset = int(rng.integers(0, n - m - budget))
        patterns.append(mutate(rng, window[offset : offset + m], rate)[:m])
        windows.append(window)
    dist, end = native_myers_distance_batch(
        windows, patterns, num_threads=min(8, os.cpu_count() or 1)
    )
    return [(w, p, int(e), int(d))
            for w, p, e, d in zip(windows, patterns, end, dist)
            if d <= budget]


def shape_tasks(name, seed):
    rng = np.random.default_rng(seed)
    if name == MIXED:
        tasks = shape_tasks("root20k", seed)
        return tasks[:-1] + shape_tasks("root40k", seed)[:1]
    count, m, rate, budget = SHAPES[name]
    return root_tasks(rng, count, m, rate, budget)


def kernel_ms(fn) -> float | None:
    """Card milliseconds of the traceback kernels in one fn() call, from
    torch.profiler (None when the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for event in prof.key_averages():
        if "traceback" in event.key:
            total += (getattr(event, "self_device_time_total", None)
                      or getattr(event, "self_cuda_time_total", 0))
    return total / 1000 if total else None


def bench(name, seed, repeats, device) -> dict:
    import torch

    from floxer_tpu_torch.ops import dp_reference
    from floxer_tpu_torch.ops import traceback_device as td

    tasks = shape_tasks(name, seed)

    def call():
        return td.banded_cigar_traceback_device_batch(tasks, device)

    got = call()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        host = list(pool.map(
            lambda task: dp_reference.banded_cigar_traceback(*task), tasks
        ))
    seconds = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        td.LAUNCHES = 0
        started = time.monotonic()
        call()
        seconds.append(time.monotonic() - started)
    launches = td.LAUNCHES
    widths = [2 * max(task[3], 0) + 1 for task in tasks]
    return {
        "shape": name, "tasks": len(tasks),
        "m": sorted({len(task[1]) for task in tasks})[-1],
        "width_min": min(widths), "width_max": max(widths),
        "equal_to_host": got == host, "launches": launches,
        "call_s": sum(seconds) / len(seconds), "call_s_runs": seconds,
        "kernel_ms": kernel_ms(call),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes",
                        default="root20k,root30k,root40k,root80k,mixed")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--seed", type=int, default=SEED)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k4_bench: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    for name in args.shapes.split(","):
        print(json.dumps(bench(name, args.seed, args.repeats, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
