"""Time K1's one-warp register kernel on seeded 20 kb root tasks.

    python -m floxer_tpu_torch.tools.k1_bench [--bands 256,384]
        [--rounds 3] [--repeats 5] [--seed 20261016]

It makes 256 root tasks (a genome window of m + 2 k + 1 chars and up to
1200 more, the pattern m = 20600 chars of a slice of it mutated at 5%,
budget k = 1442: chip_smoke.py's root shape, with tools/k4_bench.py's
mutations), packs them with ops.cuda_myers_banded.banded_operands at each
band width and prints one JSON line a band: the register kernel's mean
milliseconds over `rounds` runs of `repeats` launches (CUDA events, after
a warm launch and a spin of the card so every launch is enqueued before
the first runs), us per text column, and a checksum of its distances and
end columns. A last line holds what ptxas -v reported in the aligner's
build for every myers_banded_reg_kernel<R> instance (registers, stack,
spills) and the instructions of its column loops (cuobjdump -sass).

It calls only entry points that every version of the port with the
register kernel has, so it times another checkout's K1 on the same tasks
when that checkout is first on the path (run it in turns for an A/B):

    PYTHONPATH=<checkout> python floxer_tpu_torch/tools/k1_bench.py

Exits non-zero, printing nothing, without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np

SEED = 20261016
TASKS, M, BUDGET = 256, 20_600, 1_442
GENOME_BP = 400_000
# SM clock cycles the card spins before a timed round (~10 ms)
ENQUEUE_CYCLES = 20_000_000


def root_tasks(seed):
    """(patterns, windows) of the TASKS root tasks."""
    from floxer_tpu_torch.tools.k4_bench import mutate

    rng = np.random.default_rng(seed)
    genome = rng.integers(1, 5, size=GENOME_BP).astype(np.uint8)
    patterns, windows = [], []
    for _ in range(TASKS):
        n = M + 2 * BUDGET + 1 + int(rng.integers(0, 1200))
        start = int(rng.integers(0, len(genome) - n))
        window = genome[start : start + n]
        offset = int(rng.integers(0, n - M - BUDGET))
        patterns.append(mutate(rng, window[offset : offset + M], 0.05)[:M])
        windows.append(window)
    return patterns, windows


def rounds_ms(fn, rounds, repeats) -> list[float]:
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(ENQUEUE_CYCLES)
        start.record()
        for _ in range(repeats):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / repeats)
    return out


def bench(patterns, windows, band_words, rounds, repeats, device) -> dict:
    import torch

    from floxer_tpu_torch.ops import cuda_myers_banded as k1

    padded = np.zeros((len(windows), max(map(len, windows))), dtype=np.uint8)
    for i, window in enumerate(windows):
        padded[i, : len(window)] = window
    lengths = np.asarray([len(w) for w in windows], dtype=np.int32)
    operands, num_text = k1.banded_operands(
        patterns, padded, lengths, np.full(len(patterns), BUDGET),
        band_words, device,
    )
    args = (*operands, band_words, num_text)
    dist, end = (t.cpu().numpy().astype(np.int64)
                 for t in k1.myers_banded_register(*args))
    times = rounds_ms(lambda: k1.myers_banded_register(*args), rounds,
                      repeats)
    ms = sum(times) / len(times)
    columns = int(lengths.max()) - 1
    return {
        "band_words": band_words, "tasks": len(patterns), "ms": ms,
        "rounds_ms": times, "us_per_col": ms * 1000 / columns,
        "columns": columns,
        "checksum": int((dist * 1_000_003 + end).sum()),
        "card": torch.cuda.get_device_name(0),
    }


def register_instances() -> dict:
    """ptxas -v and the column loops of each myers_banded_reg_kernel<R>."""
    from floxer_tpu_torch.ops import _build

    usage = _build.ALIGNER.ptxas_usage()
    loops = _build.sass_loops(_build.ALIGNER.sass())
    out = {}
    for name, found in usage.items():
        match = re.search(r"myers_banded_reg_kernelILi(\d+)E", name)
        if match:
            out[f"myers_banded_reg_kernel<{match.group(1)}>"] = {
                **found, "sass_loop_instructions": loops.get(name)}
    return dict(sorted(out.items(), key=lambda kv: int(kv[0][24:-1])))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bands", default="256,384")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--seed", type=int, default=SEED)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_bench: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    patterns, windows = root_tasks(args.seed)
    for band_words in map(int, args.bands.split(",")):
        print(json.dumps(bench(patterns, windows, band_words, args.rounds,
                               args.repeats, device)), flush=True)
    print(json.dumps({"instances": register_instances()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
