"""One run of one cell: set-up, a measured window, the check, one line.

    python3 -m benchmark --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up starts floxer_tpu_torch's warm server (`server.serve`) on a thread
of this process, makes the configuration's genome from its own seed,
loads the FM index from the checkout's cache (building it through the
server on a checkout's first run), draws the reads of the cell's traffic
from --seed and runs one warm-up job. The window is a closed loop of one
client: jobs back to back through the server's socket, each a read file of
the traffic, until --seconds have passed; the last job started runs to
its end. The program's SAM files are then judged by the plain reference
(reference.py), and one JSON line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

from . import client, logs, manifest, reference, simulate
from .trace import WINDOW, Profiler, Trace, idle_gaps, top_ops

FORBIDDEN_MODULES = {"jax", "jaxlib", "flax", "floxer_tpu"}
HOPPER = (9, 0)


class RunFailed(RuntimeError):
    """The run cannot give a result; it prints none and exits non-zero."""


def forbidden_modules(names) -> list[str]:
    """The modules among `names` whose top-level name is JAX's, its
    libraries' or the JAX package's; compared whole, so the port
    (floxer_tpu_torch) is not one."""
    return sorted({name.split(".", 1)[0] for name in names}
                  & FORBIDDEN_MODULES)


def refuse_forbidden_modules() -> None:
    """RunFailed where this process has loaded JAX or the JAX package; a
    result is printed only after this, when every reader and the check
    have run."""
    found = forbidden_modules(list(sys.modules))
    if found:
        raise RunFailed(f"modules loaded in this process: {', '.join(found)}")


@dataclass
class Job:
    reads: int
    reply: client.Reply
    sam: Path
    pool_index: int
    align_s: float | None = None
    stages: dict | None = None


@dataclass
class RunData:
    """What a metric's reader reads."""

    jobs: list[Job]
    trace: Trace | None
    config: dict
    traffic: dict
    setup_s: float
    memory_peak_bytes: int

    @property
    def ok_jobs(self) -> list[Job]:
        return [job for job in self.jobs if job.reply.exit == 0]

    @property
    def kreads(self) -> float:
        return sum(job.reads for job in self.ok_jobs) / 1000.0

    @property
    def window_s(self) -> float:
        """The first job's start to the last job's end."""
        if not self.jobs:
            return 0.0
        return self.jobs[-1].reply.ended - self.jobs[0].reply.started

    def stage_per_kread(self, stage: str) -> float | None:
        stages = [job.stages for job in self.ok_jobs]
        if not stages or any(s is None for s in stages) or not self.kreads:
            return None
        return sum(s[stage] for s in stages) / self.kreads


def require_gpu(chips: int):
    """The Hopper cards the cell asks for, or RunFailed."""
    import torch

    if not torch.cuda.is_available():
        raise RunFailed("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise RunFailed(f"{torch.cuda.device_count()} CUDA devices, the "
                        f"cell asks for {chips}")
    if torch.cuda.get_device_capability(0) < HOPPER:
        raise RunFailed(f"{torch.cuda.get_device_name(0)} is not a Hopper "
                        "card (compute capability 9.0)")
    return torch.device("cuda", 0)


def _log(text: str) -> None:
    print(f"benchmark: {text}", file=sys.stderr, flush=True)


def index_dir(root: Path) -> Path:
    """The fixed directory inside the checkout where a cell's first run
    saves the FM index; the program's kernels and native library go to
    build/ by its own rule."""
    return root / "build" / "benchmark" / "index"


def index_path(root: Path, genome: dict) -> Path:
    return index_dir(root) / (
        f"genome_{genome['chromosome_length']}x{genome['num_chromosomes']}"
        f"_seed{genome['seed']}.fxi"
    )


def job_argv(cell: manifest.Cell, fasta: Path, fastq: Path, sam: Path,
             index: Path) -> list[str]:
    return ["-r", str(fasta), "-q", str(fastq), "-o", str(sam),
            "-i", str(index), *cell.traffic["argv"], *cell.config["argv"]]


def _checked(reply: client.Reply, what: str) -> client.Reply:
    if reply.exit != 0:
        tail = "\n".join(reply.logs[-20:])
        raise RunFailed(f"{what} exited {reply.exit}:\n{tail}")
    return reply


@contextlib.contextmanager
def _stage(parts: dict, name: str):
    """Time one part of the set-up into parts[name] and print it."""
    started = time.monotonic()
    yield
    parts[name] = time.monotonic() - started
    _log(f"setup {name} {parts[name]:.3f} s")


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             root: Path, started: float, device=None) -> dict:
    """Set-up, window and check of one run; returns the result line's
    object. `device` is the card (None: the program picks, as on a host
    without one in the CPU tests)."""
    index_dir(root).mkdir(parents=True, exist_ok=True)
    os.environ.update(cell.config.get("env", {}))
    workdir = Path(tempfile.mkdtemp(prefix="fxb", dir=os.environ.get("TMPDIR")))
    socket_path = str(workdir / "s")
    if len(socket_path) > 100:
        raise RunFailed(f"socket path too long for AF_UNIX: {socket_path}")
    try:
        return _run_cell(cell, seed, seconds, trace, root, started, device,
                         workdir, socket_path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run_cell(cell, seed, seconds, trace, root, started, device, workdir,
              socket_path) -> dict:
    from floxer_tpu_torch import server

    genome_spec = cell.config["genome"]
    traffic = cell.traffic
    parts: dict[str, float] = {}
    serving = threading.Thread(target=server.serve, args=(socket_path,),
                               name="floxer-server", daemon=True)
    serving.start()
    try:
        client.wait_ready(socket_path)
        parts["server"] = time.monotonic() - started
        _log(f"setup server {parts['server']:.3f} s (from process start)")
        with _stage(parts, "genome"):
            genome = simulate.make_genome(
                genome_spec["chromosome_length"],
                genome_spec["num_chromosomes"], genome_spec["seed"],
            )
            fasta = workdir / "genome.fasta"
            simulate.write_fasta(fasta, genome)
        index = index_path(root, genome_spec)
        with _stage(parts, "index"):
            # one read through the server loads the index (or builds and
            # saves it on the checkout's first run) and waits for the
            # program's kernel build; the index is written under another
            # name and renamed, so a cut run leaves no partial index
            probe = workdir / "probe.fastq"
            simulate.write_fastq(probe, simulate.make_reads(
                genome, 1, traffic["read_length"], traffic["error_rate"],
                traffic["reverse_share"], simulate.seed_rng(seed, 0, 1),
            ))
            target = index
            if not index.exists():
                target = index.with_suffix(".partial")
                target.unlink(missing_ok=True)
            _checked(client.run_job(socket_path, job_argv(
                cell, fasta, probe, workdir / "probe.sam", target)),
                "the index job")
            if target != index:
                target.rename(index)
        with _stage(parts, "reads"):
            pool = []
            for number in range(traffic["distinct_jobs"]):
                reads = simulate.make_reads(
                    genome, traffic["reads_per_job"], traffic["read_length"],
                    traffic["error_rate"], traffic["reverse_share"],
                    simulate.seed_rng(seed, 1, number),
                )
                path = workdir / f"reads{number}.fastq"
                simulate.write_fastq(path, reads)
                pool.append((reads, path))
            warm_path = workdir / "warmup.fastq"
            simulate.write_fastq(warm_path, simulate.make_reads(
                genome, traffic["warmup_reads"], traffic["read_length"],
                traffic["error_rate"], traffic["reverse_share"],
                simulate.seed_rng(seed, 0, 0),
            ))
        with _stage(parts, "warmup"):
            _checked(client.run_job(socket_path, job_argv(
                cell, fasta, warm_path, workdir / "warmup.sam", index)),
                "the warm-up job")
        setup_s = time.monotonic() - started
        _log(f"setup total {setup_s:.3f} s")

        profiler = Profiler() if trace else None
        if profiler is not None:
            profiler.start()
        jobs = []
        with (_annotate(WINDOW) if trace else contextlib.nullcontext()):
            window_start = time.monotonic()
            while time.monotonic() - window_start < seconds:
                number = len(jobs)
                reads, fastq = pool[number % len(pool)]
                sam = workdir / f"job{number}.sam"
                with (_annotate(f"job {number}") if trace
                      else contextlib.nullcontext()):
                    reply = client.run_job(socket_path, job_argv(
                        cell, fasta, fastq, sam, index))
                jobs.append(Job(len(reads), reply, sam, number % len(pool),
                                logs.align_seconds(reply.logs),
                                logs.stage_split(reply.logs)))
                _log(f"job {number} exit {reply.exit} wall {reply.wall:.3f} s "
                     f"align {jobs[-1].align_s} s stages {jobs[-1].stages}")
        if profiler is not None:
            profiler.stop()
        memory_peak = _memory_peak(device)
    finally:
        with contextlib.suppress(OSError):
            client.shutdown(socket_path)
        serving.join(timeout=120)
    if serving.is_alive():
        raise RunFailed("the server thread did not stop")
    window_trace = None
    if profiler is not None:
        reading = time.monotonic()
        window_trace = profiler.trace()
        _log(f"trace {len(window_trace.device_ops)} device ops, "
             f"{len(window_trace.host_ops)} host ops, read in "
             f"{time.monotonic() - reading:.1f} s")
    _free_device(device)

    for job in jobs:
        if job.reply.exit != 0:
            _log(f"job failed, exit {job.reply.exit}: "
                 + " | ".join(job.reply.logs[-5:]))
    run = RunData(jobs, window_trace, cell.config, traffic, setup_s,
                  memory_peak)
    metrics = {}
    for metric in cell.per_layer if trace else cell.end_to_end:
        value = manifest.metric_reader(metric["name"], cell.root)(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}

    checking = time.monotonic()
    judgement = judge(genome, pool, jobs, traffic, seed)
    _log(f"check took {time.monotonic() - checking:.1f} s")
    numbers = judgement.numbers()
    correct = bool(jobs) and len(run.ok_jobs) == len(jobs) and all(
        numbers[name] <= reference.LIMITS[name] for name in numbers
    )
    attempted = sum(job.reads for job in jobs)
    # a failed job's reads count as missing (judge)
    failed = judgement.missing_reads
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": _device_info(device, memory_peak, window_trace),
    }
    if window_trace is not None:
        result["breakdown"] = {"device_ops": top_ops(window_trace),
                               "idle_gaps": idle_gaps(window_trace)}
    result["check"] = {
        name: {"value": numbers[name], "limit": reference.LIMITS[name]}
        for name in numbers
    }
    for fault in judgement.faults:
        _log(f"fault {fault}")
    _log(f"window {len(jobs)} jobs, {attempted} reads, {run.window_s:.3f} s; "
         f"optimum checked on {judgement.optimum_checked} reads")
    for name in numbers:
        print(f"check {name} {numbers[name]} limit {reference.LIMITS[name]}",
              file=sys.stderr)
    sys.stderr.flush()
    return result


def judge(genome, pool, jobs: list[Job], traffic: dict,
          seed: int) -> reference.Judgement:
    """The reference's judgement of every window job's SAM file; the
    optimum check on a sample of (job, read) drawn from the seed."""
    total = reference.Judgement()
    sample = simulate.seed_rng(seed, 2).permutation(
        sum(job.reads for job in jobs)
    )[: traffic["optimum_sample"]]
    offset = 0
    probability = float(traffic["argv"][traffic["argv"].index("-p") + 1])
    for job in jobs:
        reads = pool[job.pool_index][0]
        chosen = {reads[i - offset].name for i in sample
                  if offset <= i < offset + len(reads)}
        offset += len(reads)
        if job.reply.exit != 0 or not job.sam.exists():
            total.add(reference.Judgement(reads=len(reads),
                                          missing_reads=len(reads),
                                          origin_missed=len(reads)))
            continue
        total.add(reference.judge_job(genome, reads,
                                      reference.read_sam(job.sam),
                                      probability, chosen))
    return total


@contextlib.contextmanager
def _annotate(name: str):
    from torch.profiler import record_function

    with record_function(name):
        yield


def _memory_peak(device) -> int:
    if device is None:
        return 0
    import torch

    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def _free_device(device) -> None:
    if device is None:
        return
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _device_info(device, memory_peak: int, window_trace) -> dict:
    if device is None:
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        import torch

        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": memory_peak}
    if window_trace is not None:
        info["busy_s"] = window_trace.busy_s()
        info["window_s"] = window_trace.window_s
    return info


def parse_args(argv):
    parser = argparse.ArgumentParser(prog="python3 -m benchmark")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None, started: float | None = None) -> int:
    started = time.monotonic() if started is None else started
    args = parse_args(argv)
    root = Path.cwd()
    try:
        cell = manifest.load_cell(root / "BENCHMARK.json", args.workload)
        device = require_gpu(cell.chips)
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          root, started, device)
        refuse_forbidden_modules()
    except (RunFailed, ImportError, OSError, ValueError) as error:
        _log(f"no result: {error}")
        return 1
    print(json.dumps(result), flush=True)
    return 0
