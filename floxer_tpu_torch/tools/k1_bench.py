"""Time K1's one-warp register kernel on seeded 20 kb root tasks.

    python -m floxer_tpu_torch.tools.k1_bench [--bands 256,384]
        [--rounds 3] [--repeats 5] [--seed 20261016] [--long] [--clusters]
        [--price] [--large-layouts] [--scripts]

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

With --long it also times K1's multi-warp kernel and the routed K3 at
the shapes of the long reads' pass (64 roots of 40 kb reads at k = 6000
on 1024 band words; 64 roots of 40 kb overhanging reads on 1280 pattern
words), one JSON line each, and prints their ptxas and innermost loops.
With --clusters it times, in turns, the layouts of the cluster kernels:
K1u (csrc/myers_banded_cluster.cu) on 16 of those long roots at 2048,
2560, 3200, 4096, 6528 and 8192 band words, and K3u
(csrc/myers_large_cluster.cu) on 16 overhanging roots of 30 kb windows
whose patterns fill 2048, 3200, 4096 and 8192 words; K1's multi-warp
kernel (2048 only) against clusters of 1, 2, 4 and 8 blocks, whichever
hold the width. With --price it prices K1's multi-warp column on those
long roots at 640, 1024 and 2048 band words: the routed kernel in turns
with the lockstep column (two block barriers a column, built from
tools/csrc/k1w_lockstep.cu into a library of its own) whole and with
each of its parts left out (either barrier, both, the exchange's stores;
those columns compute wrong results by design, and nothing else runs
them). With --large-layouts it times K3u on 1 block up to one past its
aim of blocks at 544, 768, 1280 and 2048 pattern words on 8, 64 and 264
overhanging roots, in turns.

With --scripts it times instead the research kernels K6 and K8
(floxer_tpu_torch.scripts) at the scripts' shape, 32 rows of 256 band
words, at 1280 and 23040 text columns: every variant in turns (each round
runs the variants forward, then backward), one JSON line a column count
with each variant's ms, us per column and a checksum of its output, the
outputs held to the plain versions at 1280 columns. A last line holds
each K6 and K8 instance's ptxas -v report and the instruction count of
each of its column loops (ops._build.sass_loops on the checkout's build).

Without --clusters, --price and --large-layouts it calls only entry
points that every version of the port with the multi-warp kernels has,
so it times another checkout's K1 and K3 (with --scripts its K6 and K8)
on the same tasks when that checkout is first on the path (run it in
turns for an A/B):

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
# the long reads' pass: K1's roots (tasks, m, k, window chars past m, band
# words) and K3's overhanging roots (tasks, m, chars of it from the
# window's end, window chars, pattern words)
LONG_ROOTS = (64, 40_000, 6_000, 7_800, 1024)
OVERHANG_ROOTS = (64, 40_000, 25_000, 30_000, 1280)
LONG_GENOME_BP = 2_000_000
# the cluster layouts' widths (K1u's band words, K3u's pattern words) and
# tasks
CLUSTER_WIDTHS = (2048, 2560, 3200, 4096, 6528, 8192)
CLUSTER_LARGE_WIDTHS = (2048, 3200, 4096, 8192)
CLUSTER_TASKS = 16
# --price: the band widths at which K1's multi-warp column is priced, and
# the lockstep column's variants (tools/csrc/k1w_lockstep.cu's Dropped
# bits: the block barrier after the (G, P) words, the one after the top
# bits, both, the exchange's shared-memory stores)
PRICE_WIDTHS = (640, 1024, 2048)
PRICE_VARIANTS = {"lockstep": 0, "no_barrier1": 1, "no_barrier2": 2,
                  "no_barriers": 3, "no_stores": 4}
# --large-layouts: K3's layouts at these pattern words and task counts
K3_LAYOUT_WORDS = (544, 768, 1280, 2048)
K3_LAYOUT_TASKS = (8, 64, 264)
# SM clock cycles the card spins before a timed round (~10 ms)
ENQUEUE_CYCLES = 20_000_000
# --scripts: the text columns at which K6 and K8 are timed, and the most
# at which their outputs are held to the plain versions (which loop over
# the columns in Python)
SCRIPT_COLUMNS = (1280, 23040)
SCRIPT_PLAIN_COLUMNS = 1280


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


def long_tasks(seed):
    """((patterns, windows) of LONG_ROOTS, (patterns, windows) of
    OVERHANG_ROOTS): reads at 12% error; an overhanging read is its
    window's last chars, mutated, then random chars up to m."""
    from floxer_tpu_torch.tools.k4_bench import mutate

    rng = np.random.default_rng(seed + 2)
    genome = rng.integers(1, 5, size=LONG_GENOME_BP).astype(np.uint8)
    T, m, _, extra, _ = LONG_ROOTS
    roots = ([], [])
    for _ in range(T):
        n = m + extra + int(rng.integers(0, 400))
        start = int(rng.integers(0, len(genome) - n))
        window = genome[start : start + n]
        offset = int(rng.integers(0, extra // 2))
        roots[0].append(mutate(rng, window[offset : offset + m], 0.12)[:m])
        roots[1].append(window)
    B, m3, inside, n3, _ = OVERHANG_ROOTS
    return roots, overhang_roots(rng, genome, B, m3, inside, n3)


def overhang_roots(rng, genome, count, m, inside, n):
    """(patterns, windows) of `count` reads of m chars that run off a
    window of n chars with `inside` of them on it (its last chars,
    mutated at 12%, then random chars up to m)."""
    from floxer_tpu_torch.tools.k4_bench import mutate

    patterns, windows = [], []
    for _ in range(count):
        start = int(rng.integers(0, len(genome) - n))
        window = genome[start : start + n]
        read = mutate(rng, window[n - inside :], 0.12)
        tail = rng.integers(1, 5, size=max(0, m - len(read)))
        patterns.append(np.concatenate([read, tail]).astype(np.uint8)[:m])
        windows.append(window)
    return patterns, windows


def padded(seqs, dtype=np.uint8):
    """[len(seqs), longest] zero padded, and the lengths."""
    out = np.zeros((len(seqs), max(map(len, seqs))), dtype=dtype)
    for i, seq in enumerate(seqs):
        out[i, : len(seq)] = seq
    return out, np.asarray([len(s) for s in seqs], dtype=np.int32)


def banded_args(patterns, windows, budget, band_words, device):
    from floxer_tpu_torch.ops import cuda_myers_banded as k1

    texts, lengths = padded(windows)
    operands, num_text = k1.banded_operands(
        patterns, texts, lengths, np.full(len(patterns), budget), band_words,
        device,
    )
    return (*operands, band_words, num_text)


def timed(name, fn, columns, rounds, repeats, **fields) -> dict:
    """One JSON line's fields: fn's mean ms, us per column, checksum."""
    import torch

    dist, end = (t.cpu().numpy().astype(np.int64) for t in fn())
    times = rounds_ms(fn, rounds, repeats)
    ms = sum(times) / len(times)
    return {"kernel": name, **fields, "ms": ms, "rounds_ms": times,
            "us_per_col": ms * 1000 / columns, "columns": columns,
            "checksum": int((dist * 1_000_003 + end).sum()),
            "card": torch.cuda.get_device_name(0)}


def full_args(patterns, windows, words, device):
    """K3's operands (peq padded to `words`, plen, texts, tlen)."""
    import torch

    from floxer_tpu_torch.ops.myers import build_peq_vectorized, u32_tensor

    pat, plen = padded(patterns)
    txt, tlen = padded(windows, np.int32)
    peq = build_peq_vectorized(pat, plen)
    wide = np.zeros(peq.shape[:2] + (words,), dtype=np.uint32)
    wide[:, :, : peq.shape[2]] = peq
    return (u32_tensor(wide, device), torch.from_numpy(plen).to(device),
            torch.from_numpy(txt).to(device),
            torch.from_numpy(tlen).to(device))


def long_benches(seed, rounds, repeats, device):
    """K1's multi-warp kernel at LONG_ROOTS (its own entry point) and K3 at
    OVERHANG_ROOTS (the routing entry: the multi-warp kernel before the
    cluster kernel took these widths, the cluster kernel since)."""
    from floxer_tpu_torch.ops import cuda_myers_banded as k1
    from floxer_tpu_torch.ops import cuda_myers_large as k3

    (patterns, windows), (patterns3, windows3) = long_tasks(seed)
    T, m, k, _, band_words = LONG_ROOTS
    args = banded_args(patterns, windows, k, band_words, device)
    yield timed("K1w", lambda: k1.myers_banded_wide(*args),
                max(map(len, windows)) - 1, rounds, repeats,
                shape=f"T={T} m={m} k={k} BW={band_words}")
    B, m3, _, n3, words = OVERHANG_ROOTS
    args3 = full_args(patterns3, windows3, words, device)
    tlen = args3[3].cpu().numpy()
    yield timed("K3", lambda: k3.myers_large(*args3),
                int(tlen.max()) - 1, rounds, repeats,
                shape=f"B={B} m={m3} n={n3} Wp={words}")


def cluster_layouts(seed, rounds, repeats, device):
    """K1u's layouts at CLUSTER_WIDTHS on CLUSTER_TASKS long roots and
    K3u's at CLUSTER_LARGE_WIDTHS on CLUSTER_TASKS overhanging roots, in
    turns (each round runs the layouts forward, then backward)."""
    from floxer_tpu_torch.ops import cuda_myers_banded as k1
    from floxer_tpu_torch.ops import cuda_myers_large as k3

    (patterns, windows), _ = long_tasks(seed)
    _, m, k, _, _ = LONG_ROOTS
    patterns = patterns[:CLUSTER_TASKS]
    windows = windows[:CLUSTER_TASKS]
    for band_words in CLUSTER_WIDTHS:
        args = banded_args(patterns, windows, k, band_words, device)
        layouts = {}
        if band_words <= k1.WIDE_MAX_WORDS:
            layouts["wide"] = lambda: k1.myers_banded_wide(*args)
        for blocks in (1, 2, 4, 8):
            if -(-(band_words // 128) // blocks) <= k1.CLUSTER_BLOCK_WARPS:
                layouts[f"cluster{blocks}"] = (
                    lambda b=blocks: k1.myers_banded_cluster(*args, blocks=b))
        yield {"kernel": "K1u", "band_words": band_words,
               "shape": f"m={m} k={k}",
               **in_turns(layouts, max(map(len, windows)) - 1, rounds,
                          repeats)}
    genome = np.random.default_rng(seed + 3).integers(
        1, 5, size=LONG_GENOME_BP).astype(np.uint8)
    for words in CLUSTER_LARGE_WIDTHS:
        patterns3, windows3 = overhang_roots(
            np.random.default_rng(seed + words), genome, CLUSTER_TASKS,
            32 * words - 100, 25_000, 30_000)
        args3 = full_args(patterns3, windows3, words, device)
        layouts = {}
        for blocks in (1, 2, 4, 8):
            if -(-(words // 128) // blocks) <= k3.CLUSTER_BLOCK_WARPS:
                layouts[f"cluster{blocks}"] = (
                    lambda b=blocks: k3.myers_large_cluster(*args3, blocks=b))
        yield {"kernel": "K3u", "words": words,
               "shape": f"m={32 * words - 100} n=30000",
               **in_turns(layouts, 29_999, rounds, repeats)}


def in_turns(layouts, columns, rounds, repeats, tasks=CLUSTER_TASKS,
             exact=None) -> dict:
    """The outputs of the layouts named in `exact` (all by default) held
    equal to the first's, and each layout's ms in turns (each round runs
    the layouts forward, then backward)."""
    import torch

    names = list(layouts) if exact is None else exact
    outputs = {name: [t.cpu() for t in layouts[name]()] for name in names}
    first = next(iter(outputs.values()))
    equal = all(all(bool((a == b).all()) for a, b in zip(out, first))
                for out in outputs.values())
    turns = {name: [] for name in layouts}
    for _ in range(rounds):
        for name in [*layouts, *reversed(layouts)]:
            turns[name] += rounds_ms(layouts[name], 1, repeats)
    return {"tasks": tasks, "columns": columns, "equal": equal,
            "card": torch.cuda.get_device_name(0), **{
                name: {"ms": sum(t) / len(t), "turns_ms": t,
                       "us_per_col": sum(t) / len(t) * 1000 / columns,
                       **({"blocks": int(name[7:])}
                          if name.startswith("cluster") else {})}
                for name, t in turns.items()}}


def lockstep(args, dropped):
    """The lockstep multi-warp K1 column (tools/csrc/k1w_lockstep.cu) on
    K1's CUDA operands, with the parts in `dropped` left out."""
    import torch

    from floxer_tpu_torch.ops import _build

    vp0, planes0, texts, stream, scalars, band_words, num_text = args
    T = vp0.shape[0]
    dist = torch.empty(T, dtype=torch.int32, device=vp0.device)
    end = torch.empty(T, dtype=torch.int32, device=vp0.device)
    _build.BENCH.launch(
        "floxer_wide_lockstep", vp0.data_ptr(), planes0.data_ptr(),
        texts.data_ptr(), stream.data_ptr(), scalars.data_ptr(), T,
        band_words, num_text // 8, dropped, dist.data_ptr(), end.data_ptr(),
        torch.cuda.current_stream(vp0.device).cuda_stream)
    return dist, end


def price_wide_column(seed, rounds, repeats, device):
    """K1's multi-warp column priced on LONG_ROOTS at PRICE_WIDTHS: the
    routed kernel (myers_banded_wide), the lockstep column whole and that
    column without each of its parts (PRICE_VARIANTS), in turns; the
    routed kernel's and the whole lockstep column's outputs equal."""
    from floxer_tpu_torch.ops import cuda_myers_banded as k1

    (patterns, windows), _ = long_tasks(seed)
    T, m, k, _, _ = LONG_ROOTS
    for band_words in PRICE_WIDTHS:
        args = banded_args(patterns, windows, k, band_words, device)
        layouts = {"routed": lambda: k1.myers_banded_wide(*args)}
        for name, dropped in PRICE_VARIANTS.items():
            layouts[name] = lambda d=dropped: lockstep(args, d)
        yield {"kernel": "K1w price", "band_words": band_words,
               "shape": f"T={T} m={m} k={k}",
               **in_turns(layouts, max(map(len, windows)) - 1, rounds,
                          repeats, tasks=T,
                          exact=["routed", "lockstep"])}


def large_layouts(seed, rounds, repeats, device):
    """K3u's layouts at K3_LAYOUT_WORDS on K3_LAYOUT_TASKS overhanging
    roots of 30 kb windows whose patterns fill the width: 1 block up to
    one past its aim of blocks, whichever hold the width, in turns, their
    outputs equal; beside them the pick for the tasks on this card."""
    import numpy as np

    from floxer_tpu_torch.ops import cuda_myers_large as k3

    genome = np.random.default_rng(seed + 4).integers(
        1, 5, size=LONG_GENOME_BP).astype(np.uint8)
    for words in K3_LAYOUT_WORDS:
        m = 32 * words - 100
        patterns, windows = overhang_roots(
            np.random.default_rng(seed + words), genome,
            max(K3_LAYOUT_TASKS), m, 25_000, 30_000)
        warps = -(-words // 128)
        for tasks in K3_LAYOUT_TASKS:
            args3 = full_args(patterns[:tasks], windows[:tasks], words,
                              device)
            layouts = {}
            for blocks in range(1, k3.cluster_blocks(words) + 2):
                if (blocks <= k3.CLUSTER_MAX_BLOCKS and -(-warps // blocks)
                        <= k3.CLUSTER_BLOCK_WARPS):
                    layouts[f"cluster{blocks}"] = (
                        lambda b=blocks, a=args3: k3.myers_large_cluster(
                            *a, blocks=b))
            yield {"kernel": "K3 layouts", "words": words,
                   "pick": k3.cluster_blocks(words, tasks,
                                             k3.card_sms(device)),
                   "shape": f"B={tasks} m={m} n=30000",
                   **in_turns(layouts, 29_999, rounds, repeats,
                              tasks=tasks)}


def script_runs(texts, jstar) -> tuple[dict, dict]:
    """({name: launch}, {name: plain version on CPU copies}) of every K6
    and K8 variant."""
    import functools

    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    P = functools.partial
    cpu_texts, cpu_jstar = texts.cpu(), jstar.cpu()
    runs, plains = {}, {}
    for v in k6.VARIANTS:
        runs[f"K6 {v}"] = P(k6.column_loop, texts, v)
        plains[f"K6 {v}"] = P(k6.column_loop_plain, cpu_texts, v)
    for b in k78.BCASTS:
        runs[f"K8 bcast={b}"] = P(k78.bcast, texts, jstar, b)
        plains[f"K8 bcast={b}"] = P(k78.bcast_plain, cpu_texts, cpu_jstar, b)
    return runs, plains


def scripts_bench(rounds, repeats, device):
    """One JSON line a count of SCRIPT_COLUMNS: script_runs' variants on
    the scripts' seeded texts and jstar, in turns."""
    import torch

    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    for num_text in SCRIPT_COLUMNS:
        texts = torch.from_numpy(k6.script_texts(num_text)).to(device)
        jstar = torch.from_numpy(k78.script_jstar(num_text)).to(device)
        runs, plains = script_runs(texts, jstar)
        outputs = {name: run().cpu() for name, run in runs.items()}
        line = {"kernel": "K6/K8", "num_text": num_text,
                "card": torch.cuda.get_device_name(0)}
        if num_text <= SCRIPT_PLAIN_COLUMNS:
            line["equal_to_plain"] = all(
                torch.equal(outputs[name], plains[name]()) for name in runs)
        turns = {name: [] for name in runs}
        for _ in range(rounds):
            for name in [*runs, *reversed(runs)]:
                turns[name] += rounds_ms(runs[name], 1, repeats)
        line["variants"] = {
            name: {"ms": sum(t) / len(t), "turns_ms": t,
                   "us_per_col": sum(t) / len(t) * 1000 / num_text,
                   "checksum": int(outputs[name].to(torch.int64).sum())}
            for name, t in turns.items()}
        yield line


def script_instances() -> dict:
    """ptxas -v and the column loops' instruction counts (sass_loops) of
    each K6 and K8 instance of the checkout's scripts build."""
    from floxer_tpu_torch.ops import _build

    _build.SCRIPTS.load()
    usage = _build.SCRIPTS.ptxas_usage()
    return {
        name: {**usage.get(name, {}), "column_loops": loops}
        for name, loops in _build.sass_loops(_build.SCRIPTS.sass()).items()
        if "column_loop" in name or "bcast" in name
    }


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


def register_instances(long=False) -> dict:
    """ptxas -v and the column loops of each myers_banded_reg_kernel<R>
    (and with `long` of each instance of the multi-warp K1 and of K3u)."""
    from floxer_tpu_torch.ops import _build

    usage = _build.ALIGNER.ptxas_usage()
    loops = _build.sass_loops(_build.ALIGNER.sass())
    out = {}
    for name, found in usage.items():
        match = re.search(r"myers_banded_reg_kernelILi(\d+)E", name)
        if match:
            out[f"myers_banded_reg_kernel<{match.group(1)}>"] = {
                **found, "sass_loop_instructions": loops.get(name)}
    out = dict(sorted(out.items(), key=lambda kv: int(kv[0][24:-1])))
    for kernel in ("myers_banded_wide_kernel", "myers_large_cluster_kernel"):
        for name, found in usage.items():
            if long and kernel in name:
                instance = re.search(rf"{kernel}ILi(\d+)E", name)
                key = f"{kernel}<{instance.group(1)}>" if instance else kernel
                out[key] = {**found,
                            "sass_loop_instructions": loops.get(name)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bands", default="256,384")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--long", action="store_true")
    parser.add_argument("--clusters", action="store_true")
    parser.add_argument("--price", action="store_true")
    parser.add_argument("--large-layouts", action="store_true")
    parser.add_argument("--scripts", action="store_true")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_bench: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if args.scripts:
        for line in scripts_bench(args.rounds, args.repeats, device):
            print(json.dumps(line), flush=True)
        print(json.dumps({"script_instances": script_instances()}),
              flush=True)
        return 0
    patterns, windows = root_tasks(args.seed)
    for band_words in map(int, args.bands.split(",")):
        print(json.dumps(bench(patterns, windows, band_words, args.rounds,
                               args.repeats, device)), flush=True)
    if args.long:
        for line in long_benches(args.seed, args.rounds, args.repeats,
                                 device):
            print(json.dumps(line), flush=True)
    if args.clusters:
        for line in cluster_layouts(args.seed, args.rounds, args.repeats,
                                    device):
            print(json.dumps(line), flush=True)
    if args.price:
        for line in price_wide_column(args.seed, args.rounds, args.repeats,
                                      device):
            print(json.dumps(line), flush=True)
    if args.large_layouts:
        for line in large_layouts(args.seed, args.rounds, args.repeats,
                                  device):
            print(json.dumps(line), flush=True)
    print(json.dumps({"instances": register_instances(args.long)}),
          flush=True)
    if args.price:
        from floxer_tpu_torch.ops import _build

        print(json.dumps({"bench_instances": {
            name: found for name, found in _build.BENCH.ptxas_usage().items()
            if "lockstep" in name}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
