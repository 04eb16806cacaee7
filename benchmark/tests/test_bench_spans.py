"""The readers of the program's `trace spans:` line (spans.py and the
seven metrics that read it), on synthetic jobs with known spans, device
ops and gaps; a job without the line; and a whole traced run on the
CPU."""

import json
import shutil
import time
from pathlib import Path

import pytest

from benchmark import client, manifest, spans
from benchmark.run import Job, RunData
from benchmark.trace import Trace

MS = 1_000_000
T0 = 1_700_000_000_000_000_000  # unix-epoch ns
HERE = Path(__file__).resolve().parents[1]
NEW_METRICS = ("job_overhead_s", "search_wait_s", "finalize_wait_s",
               "verify_host_engine_s", "verify_self_s", "device_cell_share",
               "idle_unattributed_share")


def line(rows, counters=None, job=1):
    """A `trace spans:` line as the program writes it: rows of (id,
    parent, name, thread, start ms, end ms) from T0."""
    threads = []
    out = []
    for sid, parent, name, thread, start, end in rows:
        if thread not in threads:
            threads.append(thread)
        out.append([sid, parent, name, threads.index(thread),
                    T0 + start * MS, T0 + end * MS, 0, None])
    return spans.PREFIX + json.dumps({
        "job": job, "clock": "unix_ns",
        "fields": ["id", "parent", "name", "thread", "start_ns", "end_ns",
                   "cpu_ns", "attrs"],
        "threads": threads, "spans": out, "counters": counters or {},
        "launches": {"K1": 3},
    })


# one job of 500 reads, 100 ms long, on the handler thread "h"; the
# search worker "s" and the finalize thread "f" beside it
JOB = [
    (1, None, "job", "h", 0, 100),
    (2, 1, "job.reference", "h", 2, 12),
    (3, 1, "align", "h", 15, 95),
    (4, 3, "search.chunk", "s", 15, 40),
    (5, 3, "pipeline.wait_search", "h", 16, 40),
    (6, 3, "verify.chunk", "h", 40, 80),
    (7, 6, "verify.build", "h", 42, 46),
    (8, 6, "verify.wave", "h", 50, 70),
    (9, 8, "verify.host_engine", "h", 52, 60),
    (10, 8, "verify.device_dispatch", "h", 61, 62),
    (11, 8, "verify.device_wait", "h", 64, 68),
    (12, 6, "verify.scan", "h", 72, 78),
    (13, 12, "traceback.root", "t", 74, 90),
    (14, 3, "finalize.chunk", "f", 80, 92),
    (15, 3, "pipeline.wait_finalize", "h", 82, 92),
]
COUNTERS = {"verify.cells_host": 300, "verify.cells_device": 100,
            "verify.waves": 1}


def run_of(lines_of_jobs, device_ops=(), window=(0, 100), reads=500):
    jobs = [Job(reads, client.Reply(0, logs, 0.0, 1.0), Path("x.sam"), 0)
            for logs in lines_of_jobs]
    trace = Trace(
        device_ops=[(name, T0 + a * MS, T0 + b * MS)
                    for name, a, b in device_ops],
        window=(T0 + window[0] * MS, T0 + window[1] * MS),
    )
    return RunData(jobs, trace, {}, {}, 1.0, 0)


def read(name, run):
    return manifest.metric_reader(name, HERE)(run)


def test_the_line_parses_and_sums_outermost_spans():
    job = spans.parse(["other", line(JOB, COUNTERS)])
    assert job.job == 1 and len(job.spans) == len(JOB)
    assert job.launches == {"K1": 3}
    assert job.thread_of("align") == "h"
    assert job.seconds("verify.wave") == pytest.approx(0.020)
    nested = spans.parse([line([
        (1, None, "verify.host_engine", "h", 0, 10),
        (2, 1, "verify.host_engine", "h", 2, 4),  # inside the first
        (3, None, "verify.host_engine", "h", 20, 25),
    ])])
    assert nested.seconds("verify.host_engine") == pytest.approx(0.015)
    assert spans.parse(["stage split: search=1.00s"]) is None


def test_metrics_read_the_spans_and_counters():
    run = run_of([[line(JOB, COUNTERS)]])
    # 500 reads: per 1000 reads is twice the job's seconds
    assert read("job_overhead_s", run) == pytest.approx(0.100 - 0.080)
    assert read("search_wait_s", run) == pytest.approx(2 * 0.024)
    assert read("finalize_wait_s", run) == pytest.approx(2 * 0.010)
    assert read("verify_host_engine_s", run) == pytest.approx(2 * 0.008)
    assert read("device_cell_share", run) == pytest.approx(25.0)
    # verify.chunk 40 less build 4, wave 20, scan 6 and nothing else =
    # 10; build 4; wave 20 less 8 + 1 + 4 = 7; scan 6 (its traceback runs
    # on another thread); the host engine, dispatch and wait left out
    assert read("verify_self_s", run) == pytest.approx(
        2 * (0.010 + 0.004 + 0.007 + 0.006))


def test_self_time_with_overlapping_children():
    rows = [
        spans.Span(1, None, "verify.chunk", "h", 0, 100),
        spans.Span(2, 1, "verify.wave", "h", 10, 50),
        spans.Span(3, 1, "verify.wave", "h", 40, 70),  # overlaps the first
        spans.Span(4, 1, "pipeline.wait_search", "h", 0, 5),
        spans.Span(5, 1, "traceback.root", "t", 0, 100),  # another thread
        spans.Span(6, 2, "other.child", "h", 20, 30),
    ]
    # chunk: 100 less [0, 5) + [10, 70) = 35; the first wave 40 less 10 =
    # 30; the second 30; wait_search and the other children are not verify.*
    assert spans.self_seconds(rows, "verify.chunk", "verify.") == (
        pytest.approx((35 + 30 + 30) / 1e9))
    assert spans.self_seconds(rows, "verify.chunk", "verify.",
                              ("verify.wave",)) == pytest.approx(35 / 1e9)


def test_innermost_pieces_of_nested_spans():
    rows = [
        spans.Span(1, None, "job", "h", 0, 100),
        spans.Span(2, 1, "align", "h", 10, 90),
        spans.Span(3, 2, "verify.chunk", "h", 20, 60),
        spans.Span(4, 3, "verify.wave", "h", 30, 40),
    ]
    assert spans.innermost(rows) == [
        (0, 10, "job"), (10, 20, "align"), (20, 30, "verify.chunk"),
        (30, 40, "verify.wave"), (40, 60, "verify.chunk"),
        (60, 90, "align"), (90, 100, "job"),
    ]


def test_idle_time_goes_to_the_innermost_align_thread_span():
    # device busy [44, 49) and [63, 66); the window [0, 120): 112 ms idle,
    # 20 of them after the job and none of them on another thread's span
    run = run_of([[line(JOB, COUNTERS)]],
                 device_ops=[("k", 44, 49), ("k", 63, 66)], window=(0, 120))
    seconds = spans.idle_by_span(run.trace, [spans.parse(run.jobs[0]
                                                         .reply.logs)])
    assert sum(seconds.values()) == pytest.approx(0.112)
    assert seconds[None] == pytest.approx(0.020)  # [100, 120)
    assert seconds["job"] == pytest.approx(0.002 + 0.003 + 0.005)
    assert seconds["align"] == pytest.approx(0.006)  # [15, 16), [80, 82), [92, 95)
    assert seconds["pipeline.wait_search"] == pytest.approx(0.024)
    assert seconds["verify.build"] == pytest.approx(0.002)  # [42, 44)
    assert seconds["verify.host_engine"] == pytest.approx(0.008)
    assert seconds["verify.device_wait"] == pytest.approx(0.002)  # [66, 68)
    assert "search.chunk" not in seconds  # the search worker's thread
    unnamed = 0.020 + 0.010 + 0.006
    assert read("idle_unattributed_share", run) == pytest.approx(
        100 * unnamed / 0.112)


def test_two_jobs_on_two_handler_threads():
    second = [(sid + 100, None if parent is None else parent + 100, name,
               "h2" if thread == "h" else thread, start + 100, end + 100)
              for sid, parent, name, thread, start, end in JOB]
    run = run_of([[line(JOB, COUNTERS)], [line(second, COUNTERS, job=2)]],
                 window=(0, 200))
    seconds = spans.idle_by_span(
        run.trace, [spans.parse(job.reply.logs) for job in run.jobs])
    assert seconds[None] == pytest.approx(0.0)
    assert seconds["verify.host_engine"] == pytest.approx(0.016)
    assert read("device_cell_share", run) == pytest.approx(25.0)
    assert read("job_overhead_s", run) == pytest.approx(0.020)


def test_a_job_without_the_line_reads_none():
    run = run_of([["finished aligning successfully in 1.00 seconds"]])
    for name in NEW_METRICS:
        assert read(name, run) is None, name
    untraced = run_of([[line(JOB, COUNTERS)]])
    untraced.trace = None
    assert read("idle_unattributed_share", untraced) is None
    assert read("verify_host_engine_s", untraced) is not None


def test_the_programs_export_parses():
    """The tracer's own line (floxer_tpu_torch/tracing.py) reads back
    with its spans' parents, threads and counters."""
    from floxer_tpu_torch import tracing

    with tracing.job(on=True) as job:
        with tracing.span("align"):
            with tracing.span("verify.wave", walks=3) as wave:
                wave.set(route="host")
                tracing.count("verify.cells_host", 7)
    parsed = spans.parse([job.line()])
    names = {span.name: span for span in parsed.spans}
    assert set(names) == {"job", "align", "verify.wave"}
    assert names["verify.wave"].parent == names["align"].id
    assert names["align"].parent == names["job"].id
    assert names["verify.wave"].attrs == {"walks": 3, "route": "host"}
    assert parsed.counters == {"verify.cells_host": 7}
    assert abs(names["job"].start - time.time_ns()) < 60 * 10**9


def test_a_traced_cpu_run_reads_every_new_metric(tmp_path, monkeypatch):
    """A whole run on the CPU with --trace 1, on a tiny cell of the chr21
    settings: every new metric reads a number."""
    from benchmark.run import run_cell

    monkeypatch.setenv("FLOXER_TPU_PLATFORM", "cpu")
    root = tmp_path / "benchmark"
    for sub in ("configs", "traffic"):
        (root / sub).mkdir(parents=True)
    shutil.copytree(HERE / "metrics", root / "metrics")
    config = json.loads((HERE / "configs/chr21_ont.json").read_text())
    config["genome"] = {"chromosome_length": 200000, "num_chromosomes": 2,
                        "seed": 3}
    (root / "configs/tiny.json").write_text(json.dumps(config))
    (root / "traffic/tiny_mix.json").write_text(json.dumps({
        "reads_per_job": 16, "read_length": 2000, "error_rate": 0.07,
        "reverse_share": 0.5, "argv": ["-p", "0.08"], "distinct_jobs": 2,
        "warmup_reads": 4, "optimum_sample": 6}))
    data = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    data["configs"] = [{"name": "tiny", "source": "a test",
                        "file": "benchmark/configs/tiny.json",
                        "reduced": [], "why": "a test"}]
    data["workloads"] = [{"name": "tiny_cell", "config": "tiny",
                          "traffic": "tiny_mix", "chips": 1, "why": "a test"}]
    for metric in data["per_layer"]:
        metric.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    cell = manifest.load_cell(tmp_path / "BENCHMARK.json", "tiny_cell", root)
    result = run_cell(cell, 2**31 + 5, 0.5, True, tmp_path,
                      time.monotonic(), None)
    assert result["correct"] is True, result["check"]
    for name in NEW_METRICS:
        assert name in result["metrics"], name
    assert 0.0 <= result["metrics"]["idle_unattributed_share"]["value"] <= 100
    assert result["metrics"]["device_cell_share"]["value"] == 0.0
