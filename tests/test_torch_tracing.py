"""The port's tracer (floxer_tpu_torch/tracing.py): spans and counters of
one job, their parents across the search worker, the finalize thread
and the traceback pool, the per-job counters, off mode, the `stage
split:` line built from the span sums, and the `trace spans:` line a job
exports while a torch.profiler runs, on the profiler's clock."""

import json
import logging
import re
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import logs as bench_logs
from benchmark import spans as bench_spans
from floxer_tpu_torch import pipeline, server, tracing
from floxer_tpu_torch.cli import parse_and_validate

CPU = torch.device("cpu")
MS = 1_000_000


def cli_args(data_dir, output, extra=()):
    return [
        "--reference", str(data_dir / "reference.fasta"),
        "--queries", str(data_dir / "queries.fastq"),
        "--output", str(output),
        "--query-errors", "2", "--seed-errors", "1",
        "--extra-verification-ratio", "2", "--interval-optimization",
        "--batch-size", "2", *extra,
    ]


def server_job(data_dir, output, extra=()):
    """One job through the server's job entry on this thread: (exit code,
    the log messages the client received)."""
    lines = []
    code = server._execute_job(
        {"argv": cli_args(data_dir, output, extra)}, lines.append
    )
    return code, [line["log"]["message"] for line in lines if "log" in line]


def trace_line(messages) -> str | None:
    found = [m for m in messages if m.startswith(tracing.LINE_PREFIX)]
    assert len(found) <= 1
    return found[0] if found else None


def test_spans_nest_and_follow_the_job_across_the_pools(tmp_path, data_dir):
    """A CLI run with tracing on: every span is the one job's, the search
    worker's and the finalize thread's chunks are children of `align`,
    each traceback on the pool a child of the `verify.scan` that submitted
    it, and a span on its parent's thread lies inside it."""
    with tracing.job(on=True) as job:
        cli = parse_and_validate(cli_args(data_dir, tmp_path / "out.sam"))
        assert pipeline.run(cli, device=CPU) == 0
    assert tracing.last_job() is job
    record = bench_spans.parse([job.line()])
    assert record.job == job.id
    by_id = {span.id: span for span in record.spans}
    names = {span.name for span in record.spans}
    assert {"job", "job.reference", "job.index", "job.searcher", "align",
            "pipeline.read_queries", "pipeline.wait_search", "search.chunk",
            "search.prepare", "search.host", "verify.chunk", "verify.build",
            "verify.sim", "verify.wave", "verify.host_engine", "verify.scan",
            "traceback.root", "finalize.chunk", "finalize.tracebacks",
            "finalize.write", "pipeline.wait_finalize",
            "job.close"} <= names
    (root,) = [span for span in record.spans if span.parent is None]
    assert root.name == "job"
    (align,) = record.named("align")
    threads = {}
    for span in record.spans:
        if span is root:
            continue
        parent = by_id[span.parent]  # every parent is in the same record
        threads.setdefault(span.name, set()).add(span.thread)
        if span.thread == parent.thread:
            assert parent.start <= span.start <= span.end <= parent.end
    for chunk in record.named("search.chunk") + record.named(
            "finalize.chunk"):
        assert chunk.parent == align.id
        assert chunk.thread != align.thread
    for task in record.named("traceback.root"):
        assert by_id[task.parent].name == "verify.scan"
    assert threads["search.chunk"] <= {"search_0"}
    assert threads["finalize.chunk"] <= {"finalize_0"}
    assert all(t.startswith("traceback_") for t in threads["traceback.root"])
    assert len(record.named("search.chunk")) == 3  # 6 reads, chunks of 2
    assert record.counters["verify.waves"] >= 1
    assert record.counters["verify.cells_host"] > 0
    assert record.launches["K1"] == 0


def test_counters_are_per_job(tmp_path, data_dir):
    """Two server jobs on the same reads count the same: each job starts
    its counters and sums at zero."""
    seen = []
    for number in range(2):
        code, _ = server_job(data_dir, tmp_path / f"job{number}.sam")
        assert code == 0
        seen.append(tracing.last_job())
    first, second = seen
    assert first is not second and first.id != second.id
    assert first.counters == second.counters
    assert first.counters["verify.waves"] >= 1
    assert first.counters["verify.cells_host"] > 0
    assert set(first.sums) == set(second.sums)
    assert tracing.current() is None


def test_off_mode_keeps_no_record(tmp_path, data_dir):
    """Without a profiler a job keeps its sums and counters but no span
    list, and its client gets no `trace spans:` line; outside a job a
    span and a counter do nothing."""
    code, messages = server_job(data_dir, tmp_path / "out.sam")
    assert code == 0
    job = tracing.last_job()
    assert job.spans is None and not job.on
    assert job.seconds("job") > job.seconds("align") > 0
    assert trace_line(messages) is None
    with tracing.span("outside") as span:
        tracing.count("outside")
    assert not span.on and tracing.last_job() is job
    assert "outside" not in job.sums and "outside" not in job.counters


def test_stage_split_is_the_jobs_span_sums(tmp_path, data_dir):
    """The `stage split:` line parses with the benchmark's parser, and its
    search=, verify=, finalize= and device_kernel= are the job's sums of
    search.chunk, verify.chunk, finalize.chunk and verify.device_wait."""
    code, messages = server_job(data_dir, tmp_path / "out.sam")
    assert code == 0
    job = tracing.last_job()
    split = bench_logs.stage_split(messages)
    assert split is not None
    for stage, span in (("search", "search.chunk"),
                        ("verify", "verify.chunk"),
                        ("finalize", "finalize.chunk")):
        assert f"{split[stage]:.2f}" == f"{job.seconds(span):.2f}"
    (line,) = [m for m in messages if m.startswith("stage split:")]
    kernel = re.search(r"device_kernel=([0-9.]+)s", line).group(1)
    assert kernel == f"{job.seconds('verify.device_wait'):.2f}"
    fused = re.search(r"fused_dispatches=(\d+)", line).group(1)
    assert int(fused) == job.counter("verify.fused_dispatches")
    assert split["launches"] == job.launches


def _kineto_events(prof) -> dict:
    events = {}
    for event in prof.profiler.kineto_results.events():
        events.setdefault(event.name(), []).append(
            (event.start_ns(), event.start_ns() + event.duration_ns()))
    return events


def test_a_job_under_a_profiler_exports_its_spans(tmp_path, data_dir):
    """With a CPU torch.profiler running, a server job sends its client
    one `trace spans:` line that parses; the spans of this thread are the
    profiler's record_function events, within 1 ms of their exported
    bounds, and the SAM is the one an untraced job writes."""
    code, _ = server_job(data_dir, tmp_path / "off.sam")
    assert code == 0
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        code, messages = server_job(data_dir, tmp_path / "on.sam")
    finally:
        prof.stop()
    assert code == 0
    assert (tmp_path / "on.sam").read_bytes() == (
        tmp_path / "off.sam").read_bytes()
    line = trace_line(messages)
    assert line is not None
    assert json.loads(line[len(tracing.LINE_PREFIX):])["clock"] == "unix_ns"
    record = bench_spans.parse(messages)
    assert record is not None and tracing.last_job().on
    events = _kineto_events(prof)
    for name in ("job.reference", "align", "verify.chunk", "job"):
        span = record.named(name)[0]
        start, end = min(events[name], key=lambda e: abs(e[1] - span.end))
        assert abs(end - span.end) < MS, name
        if name == "job":
            # the job span starts at the request's parse, before its
            # record_function is entered
            assert span.start <= start
        else:
            assert abs(start - span.start) < MS, name


def test_a_record_function_inside_a_span_is_inside_its_bounds():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with tracing.job() as job:
            with tracing.span("outer"):
                with record_function("inner"):
                    time.sleep(0.005)
    finally:
        prof.stop()
    assert job.on
    outer = bench_spans.parse([job.line()]).named("outer")[0]
    ((start, end),) = _kineto_events(prof)["inner"]
    assert outer.start - MS < start < end < outer.end + MS
    assert end - start >= 4 * MS


def test_profile_records_every_threads_spans(tmp_path, data_dir, caplog):
    """--profile turns tracing on, logs the `trace spans:` line, and its
    Chrome trace holds the spans of the worker threads too."""
    trace_dir = tmp_path / "trace"
    cli = parse_and_validate(cli_args(data_dir, tmp_path / "out.sam",
                                      ["--profile", str(trace_dir)]))
    with caplog.at_level(logging.INFO, logger="floxer-tpu"):
        assert pipeline.run(cli, device=CPU) == 0
    assert any(r.getMessage().startswith(tracing.LINE_PREFIX)
               for r in caplog.records)
    (path,) = trace_dir.glob("*.json")
    names = {event.get("name")
             for event in json.loads(path.read_text())["traceEvents"]}
    assert {"align", "verify.chunk"} <= names
    try:
        from torch._C._profiler import _ExperimentalConfig

        _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pytest.skip("this torch profiles the calling thread only")
    assert {"search.chunk", "finalize.chunk"} <= names


def test_submit_keeps_the_job_and_parent():
    from concurrent.futures import ThreadPoolExecutor

    def child():
        with tracing.span("child"):
            tracing.count("tasks")
        return tracing.current()

    with ThreadPoolExecutor(max_workers=2) as pool:
        with tracing.job(on=True) as job:
            with tracing.span("parent"):
                bare = pool.submit(child).result()
                carried = tracing.submit(pool, child).result()
    assert bare is None and carried is job
    record = bench_spans.parse([job.line()])
    (parent,) = record.named("parent")
    (child_span,) = record.named("child")
    assert child_span.parent == parent.id
    assert child_span.thread != parent.thread
    assert job.counter("tasks") == 1


def test_the_span_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "SPAN_CAP", 3)
    with tracing.job(on=True) as job:
        for _ in range(5):
            with tracing.span("tiny"):
                pass
    assert len(job.spans) == 3  # the job span itself is dropped too
    assert job.counter("trace.dropped_spans") == 3
    assert job.seconds("tiny") > 0
