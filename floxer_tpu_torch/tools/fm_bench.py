"""Time the FM index kernels K9, K9x, K9l, K10, K12, K13, K13l and K11 over
the index and over the shards (K11s) at chip_smoke.py's shapes, for an A/B
of two checkouts.

    python -m floxer_tpu_torch.tools.fm_bench --prepare DIR
    PYTHONPATH=<checkout> python floxer_tpu_torch/tools/fm_bench.py DIR

--prepare simulates chip_smoke.py's pass A workload (a 4.6 Mb genome and
200 reads of 20 kb at 7%, seed 20261016, with tools/simulated_dataset),
builds its FM index and writes into DIR the index (index.npz) and the
kernels' inputs (inputs.npz): 2^20 seeded positions and SA rows (the
sharded phase's), K9x's two cursor sets of 2^20 (random ones, as
chip_smoke.py draws them, and the search cursors: search_cursors of the
first chunk's seeds), K10's operands of the first chunk, the K12
operands of the first chunk (its K10 search on the card, the dedup and
cap replay, the host group order) and K11's two inputs (the legacy
loop's first 256-seed block and the first read's largest per-query
bucket).

Given DIR it times, on those inputs, the kernels of the checkout that is
first on the path, through entry points every version of the port since
the owner-resolved locate has (DeviceIndex.from_host,
ShardedDeviceIndex.from_host, device_index.rank_all, fm_extend_cuda,
cuda_search_queue.WorkqueueLaunch, fm_locate_cuda,
fm_sharded_locate_cuda, select_anchors_cuda, frontier_search_cuda), and
prints one JSON line: each kernel's milliseconds a launch, `rounds` means
of `repeats` launches back to back (CUDA events, after a warm launch and
a ~10 ms spin of the card): K9 and K9x in both rank layouts, K9x on both
cursor sets (with the share of cursors whose interval lies in one block),
K10's search whole (its generations, reading the spilled count between
batches as the runner does; `generations` its launches), K13 and K13l and
K11s at 2 and 4 shards, K13l between two K9l times, K11 over the index
beside K11s, and a checksum of each kernel's output (the same in every
checkout that computes the same function). Run it in turns from two
checkouts in one call (parent, change, change, parent) for an A/B.

Exits non-zero, printing nothing, without a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SEED = 20261016
# pass A's workload (chip_smoke.py's E2E defaults and argv)
GENOME_BP, READS, READ_LEN, READ_ERROR, QUERY_ERROR = (
    4_600_000, 200, 20_000, 0.07, 0.08)
BATCH_SIZE = 100
QUERIES = 1 << 20
SHARD_COUNTS = (2, 4)
# K9x's cursor sets (inputs.npz's `<set>_lb`, `_lb_rev`, `_length`)
CURSOR_SETS = ("random", "search")
# the CLI's select caps and K12's codes (count_first, round_robin, erase)
HARD_CAP, SOFT_CAP = 500, 50
# SM clock cycles the card spins before a timed round (~10 ms)
ENQUEUE_CYCLES = 20_000_000


def cli_argv(workdir: Path) -> list[str]:
    return [
        "--reference", str(workdir / "genome.fasta"),
        "--queries", str(workdir / "reads.fastq"),
        "--index", str(workdir / "index.npz"),
        "--output", str(workdir / "unused.sam"),
        "-p", str(QUERY_ERROR), "--interval-optimization",
        "--threads", "4", "--batch-size", str(BATCH_SIZE),
    ]


def first_chunk(workdir: Path):
    """Pass A's first chunk of seeds, as the searcher hands it to the
    work queue: (ChunkSeedArrays, its jobs (seeds, strand))."""
    from floxer_tpu_torch.cli import parse_and_validate
    from floxer_tpu_torch.io.sequence_io import Queries
    from floxer_tpu_torch.pipeline_host import prepare_query_tree
    from floxer_tpu_torch.search_host import assemble_chunk_seed_arrays

    cli = parse_and_validate(cli_argv(workdir))
    queries = Queries(cli.queries_path, cli.query_num_errors,
                      cli.query_error_probability, cli.pex_seed_num_errors)
    jobs = []
    for query in itertools.islice(queries, cli.batch_size):
        _, seeds = prepare_query_tree(query, cli)
        jobs.append((seeds, query.rank_sequence))
        jobs.append((seeds, query.reverse_complement_rank_sequence))
    return assemble_chunk_seed_arrays(jobs), jobs


def seed_patterns(jobs) -> list:
    """The chunk's seeds' patterns (rank symbols), in the chunk's order."""
    return [query[seed.query_position:seed.query_position + seed.length]
            for seeds, query in jobs for seed in seeds]


def search_cursors(host, patterns, limit=QUERIES, seed=SEED):
    """The cursors a search's left extensions meet: each pattern extended
    backwards from the root cursor on the host index, by
    FmIndex.extend_left's arithmetic (index/fmindex.py), for all patterns
    at once, the cursor (lb, lb_rev, length) recorded before each step
    until its interval empties or its pattern ends; up to `limit` of them
    in a seeded order: int32 [3, B]."""
    n = host.n
    bwt = host.fwd.bwt
    # occ(symbol, position) = occurrences of symbol in bwt[:position]
    occ = np.zeros((n + 1, 6), dtype=np.int32)
    for symbol in range(6):
        np.cumsum(bwt == symbol, out=occ[1:, symbol])
    C = np.asarray(host.C, dtype=np.int64)
    lengths = np.array([len(p) for p in patterns], dtype=np.int64)
    padded = np.zeros((len(patterns), max(lengths.max(initial=0), 1)),
                      dtype=np.int64)
    for i, p in enumerate(patterns):
        padded[i, :len(p)] = p
    lb = np.zeros(len(patterns), dtype=np.int64)
    lb_rev = np.zeros_like(lb)
    length = np.full_like(lb, n)
    recorded = []
    for step in range(padded.shape[1]):
        active = np.flatnonzero((step < lengths) & (length > 0))
        if active.size == 0:
            break
        a, a_rev, size = lb[active], lb_rev[active], length[active]
        recorded.append(np.stack([a, a_rev, size]))
        symbol = padded[active, lengths[active] - 1 - step]
        lo = occ[a].astype(np.int64)
        counts = occ[a + size].astype(np.int64) - lo
        pick = np.arange(active.size)
        below = np.cumsum(counts, axis=1) - counts
        lb[active] = C[symbol] + lo[pick, symbol]
        lb_rev[active] = a_rev + below[pick, symbol]
        length[active] = counts[pick, symbol]
    cursors = (np.concatenate(recorded, axis=1) if recorded
               else np.zeros((3, 0), dtype=np.int64))
    order = np.random.default_rng(seed).permutation(cursors.shape[1])
    return np.ascontiguousarray(cursors[:, order[:limit]], dtype=np.int32)


def random_cursors(n, rng, count=QUERIES):
    """chip_smoke.py's random cursors: int32 [3, count], lb and lb_rev in
    [0, n), lengths up to 4095 clipped to fit."""
    lb = rng.integers(0, n, size=count)
    lb_rev = rng.integers(0, n, size=count)
    length = np.minimum(rng.integers(0, 1 << 12, size=count),
                        n - np.maximum(lb, lb_rev))
    return np.stack([lb, lb_rev, length]).astype(np.int32)


def workqueue_operands(arrays) -> dict:
    """K10's operands on the first chunk (search_device.chunk_operands, as
    chip_smoke.py's first_chunk gives them)."""
    from floxer_tpu_torch import search_queue
    from floxer_tpu_torch.search_device import chunk_operands, report_capacity

    patterns, class_of, _, tables, max_errors = chunk_operands(arrays)
    return {
        "k10_patterns": patterns.astype(np.int32),
        "k10_classes": class_of.astype(np.int32),
        "k10_scheme": tables.fused(),
        "k10_scalars": np.array([
            tables.num_searches, tables.num_parts,
            report_capacity(patterns.shape[0]),
            search_queue.key_words_needed(patterns.shape[1], max_errors),
            search_queue.frames_needed(patterns.shape[1], max_errors)]),
    }


def frontier_inputs(arrays, jobs) -> dict:
    """K11's two inputs, as chip_smoke.py's frontier_inputs builds them:
    {name: arrays and scalars of frontier_search_cuda}."""
    from floxer_tpu_torch import search_device as sd
    from floxer_tpu_torch.schemes import expand_scheme

    seeds, query = jobs[0]
    buckets = {}
    for seed in seeds:
        if seed.length <= sd._MAX_DEVICE_PATTERN:
            buckets.setdefault((seed.length, seed.num_errors), []).append(
                query[seed.query_position:seed.query_position + seed.length])
    (length, errors), patterns = max(buckets.items(),
                                     key=lambda item: len(item[1]))
    padded, seed_class, tables, iterations = sd.frontier_operands(
        patterns, expand_scheme(errors, length), errors)
    blocks, block_classes, block_tables, block_iterations, _ = next(
        sd.legacy_blocks(arrays))
    out = {}
    for name, (p, c, t, capacity, reports, it) in {
        "query": (padded[None], seed_class[None], tables, 1 << 14, 1 << 12,
                  iterations),
        "block": (blocks[:1], block_classes[:1], block_tables,
                  sd._BLOCK_FRONTIER, sd._BLOCK_REPORTS, block_iterations),
    }.items():
        out.update({
            f"{name}_patterns": p, f"{name}_classes": c,
            f"{name}_scheme": t.fused(),
            f"{name}_scalars": np.array([t.num_searches, t.num_parts,
                                         capacity, reports, it]),
        })
    return out


def select_operands(index, arrays) -> dict:
    """K12's operands on the first chunk: its K10 search's reports after
    the dedup and cap replay, the long seeds left to the native redo,
    and the host group order (chip_smoke.py's select_kernel_checks)."""
    from floxer_tpu_torch import search_queue
    from floxer_tpu_torch.search_device import (
        _MAX_DEVICE_PATTERN,
        chunk_operands,
        replay_groups,
        report_capacity,
    )
    from floxer_tpu_torch.search_select_device import group_order

    patterns, class_of, gids, tables, max_errors = chunk_operands(arrays)
    rows, overflow = search_queue.workqueue_runner(
        index, patterns, class_of.astype(np.int32), tables,
        report_capacity(patterns.shape[0]), patterns.shape[1], max_errors)
    if overflow:
        raise RuntimeError("the first chunk's K10 search overflowed")
    rep = np.empty((rows.shape[0], 5), dtype=np.int64)
    rep[:, 0] = gids[rows[:, 4]]
    rep[:, 1:] = rows[:, :4]
    redo = arrays.length_g > _MAX_DEVICE_PATTERN
    groups, starts, totals, statuses = replay_groups(rep, redo, HARD_CAP + 1)
    perm = group_order(groups, starts, 0)
    gid = np.repeat(np.arange(totals.shape[0]), np.diff(starts))
    names = ("lb", "cnt", "err", "gid", "perm", "group_starts", "totals",
             "statuses")
    values = (groups[:, 0], groups[:, 2], groups[:, 3], gid, perm, starts,
              np.minimum(totals, 2**31 - 1), statuses)
    return {f"select_{name}": np.ascontiguousarray(value, dtype=np.int32)
            for name, value in zip(names, values)}


def prepare(workdir: Path) -> None:
    import torch

    from floxer_tpu_torch.index.device_index import DeviceIndex
    from floxer_tpu_torch.index.fmindex import FmIndex
    from floxer_tpu_torch.io.sequence_io import read_references
    from floxer_tpu_torch.tools.simulated_dataset import main as simulate

    workdir.mkdir(parents=True, exist_ok=True)
    if simulate([
        "create", "-g", str(workdir / "genome.fasta"),
        "-r", str(workdir / "reads.fastq"), "-c", str(GENOME_BP), "-n", "1",
        "-l", str(READ_LEN), "-m", str(READS), "-e", str(READ_ERROR),
        "-s", str(SEED),
    ]) != 0:
        raise RuntimeError("simulated_dataset create failed")
    references = read_references(workdir / "genome.fasta")
    host = FmIndex([r.rank_sequence for r in references.records])
    host.save(str(workdir / "index.npz"))
    n = host.n
    rng = np.random.default_rng(SEED + 13)
    inputs = {
        "positions": rng.integers(0, n + 1, size=QUERIES).astype(np.int32),
        "sa_rows": rng.integers(0, n, size=QUERIES).astype(np.int32),
    }
    arrays, jobs = first_chunk(workdir)
    for name, cursors in (
            ("random", random_cursors(n, np.random.default_rng(SEED + 17))),
            ("search", search_cursors(host, seed_patterns(jobs)))):
        for key, values in zip(("lb", "lb_rev", "length"), cursors):
            inputs[f"{name}_{key}"] = values
    inputs.update(workqueue_operands(arrays))
    inputs.update(frontier_inputs(arrays, jobs))
    index = DeviceIndex.from_host(host, torch.device("cuda", 0))
    inputs.update(select_operands(index, arrays))
    np.savez(workdir / "inputs.npz", **inputs)


def rounds_ms(fn, rounds: int, repeats: int) -> list[float]:
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


def checksum(result) -> int:
    """Sum of the int64 values of a tensor, a tuple of tensors or a
    FrontierBatch's tensors."""
    import torch

    if hasattr(result, "reports"):
        result = (result.reports, result.num_reports, result.iterations,
                  result.expanded)
    if isinstance(result, torch.Tensor):
        result = (result,)
    return int(sum(int(t.long().sum()) for t in result))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def time_kernels(workdir: Path, rounds: int) -> dict:
    import torch

    import floxer_tpu_torch
    from floxer_tpu_torch.index import device_index as di
    from floxer_tpu_torch.index.fmindex import FmIndex
    from floxer_tpu_torch.ops import cuda_fm_index as k9
    from floxer_tpu_torch.ops import cuda_frontier as k11
    from floxer_tpu_torch.ops import cuda_select as k12
    from floxer_tpu_torch.ops import cuda_sharded as k13

    device = torch.device("cuda", 0)
    host = FmIndex.load(str(workdir / "index.npz"))
    arrays = dict(np.load(workdir / "inputs.npz"))

    def on(name):
        return torch.from_numpy(arrays[name]).to(device)

    positions, sa_rows = on("positions"), on("sa_rows")
    select = [on(f"select_{name}") for name in (
        "lb", "cnt", "err", "gid", "perm", "group_starts", "totals",
        "statuses")]
    frontier = {
        name: ([on(f"{name}_patterns"), on(f"{name}_classes"),
                on(f"{name}_scheme")],
               [int(v) for v in arrays[f"{name}_scalars"]])
        for name in ("block", "query")}
    flat = di.DeviceIndex.from_host(host, device)
    out = {"package": str(Path(floxer_tpu_torch.__file__).parent),
           "card": card_line(), "queries": QUERIES}

    def timed(key, fn, repeats):
        out[key] = {"ms": rounds_ms(fn, rounds, repeats),
                    "checksum": checksum(fn())}

    planes = di.DeviceIndex.from_host(host, device, force_planes=True)
    cursors = {name: [on(f"{name}_{key}") for key in ("lb", "lb_rev",
                                                      "length")]
               for name in CURSOR_SETS}
    for layout, index in (("", flat), ("_planes", planes)):
        timed(f"K9{layout}", lambda i=index: di.rank_all(i.fwd, positions),
              20)
        for name in CURSOR_SETS:
            timed(f"K9x_{name}{layout}", lambda i=index, c=cursors[name]:
                  k9.fm_extend_cuda(i, *c, left=True), 20)
    for name in CURSOR_SETS:
        out[f"K9x_{name}"]["same_block_share"] = same_block_share(
            *cursors[name])
    out["K10"] = workqueue_times(flat, arrays, device, rounds)

    def k9l():
        return k9.fm_locate_cuda(flat, sa_rows, flat.sampling_rate)

    timed("K9l", k9l, 20)
    timed("K12", lambda: k12.select_anchors_cuda(
        flat, *select, HARD_CAP, SOFT_CAP, 0, 0, True), 5)
    for name, repeats in (("block", 5), ("query", 20)):
        operands, scalars = frontier[name]
        timed(f"K11_{name}", lambda o=operands, s=scalars:
              k11.frontier_search_cuda(flat, *o, *s), repeats)
    for S in SHARD_COUNTS:
        index = di.ShardedDeviceIndex.from_host(host, S, device)
        timed(f"K13_S{S}", lambda i=index: di.rank_all(i.fwd, positions), 20)
        turns = []
        for key in ("K9l", "K13l", "K9l"):
            fn = k9l if key == "K9l" else (
                lambda i=index: k13.fm_sharded_locate_cuda(
                    i, sa_rows, i.sampling_rate))
            turns.append(rounds_ms(fn, rounds, 20))
        out[f"K13l_S{S}"] = {
            "ms": turns[1], "k9l_ms": turns[0] + turns[2],
            "checksum": checksum(k13.fm_sharded_locate_cuda(
                index, sa_rows, index.sampling_rate))}
        for name, repeats in (("block", 5), ("query", 20)):
            operands, scalars = frontier[name]
            timed(f"K11s_{name}_S{S}", lambda i=index, o=operands,
                  s=scalars: k11.frontier_search_cuda(i, *o, *s), repeats)
    return out


def same_block_share(lb, lb_rev, length, left=True) -> float:
    """The share of cursors whose interval's ends share a 128-row block
    (K9x reads one row for those)."""
    base = (lb if left else lb_rev).long()
    end = base + length.long()
    return float((base // 128 == end // 128).double().mean())


def workqueue_times(index, arrays, device, rounds) -> dict:
    """K10's search whole on the first chunk (WorkqueueLaunch.launch: its
    generations, reading the last one's spilled count between batches, on
    buffers allocated once): ms, its generations, nodes and a checksum of
    its reports (their sum, which the report order does not change)."""
    import torch

    from floxer_tpu_torch.ops import cuda_search_queue as k10

    operands = [torch.from_numpy(arrays[f"k10_{name}"]).to(device)
                for name in ("patterns", "classes", "scheme")]
    num_searches, num_parts, report_cap, kw, frames = (
        int(v) for v in arrays["k10_scalars"])
    prepared = k10.WorkqueueLaunch(index, *operands, num_searches,
                                   num_parts, report_cap, kw, frames)
    ms = rounds_ms(prepared.launch, rounds, 5)
    prepared.launch()
    run = prepared.result()
    return {"ms": ms, "generations": prepared.launches, "nodes": run.nodes,
            "reports": run.num_reports, "overflow": run.overflow,
            "checksum": checksum(run.reports[:run.num_reports])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workdir", type=Path)
    parser.add_argument("--prepare", action="store_true")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fm_bench: no CUDA device", file=sys.stderr)
        return 1
    if args.prepare:
        prepare(args.workdir)
        return 0
    print(json.dumps(time_kernels(args.workdir, args.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
