"""The program's own spans and counters of each window job, read back.

With a torch.profiler running (`--trace 1`), floxer_tpu_torch's tracer
exports each job's spans and counters as one log line of the job,
`trace spans: <json>` (floxer_tpu_torch/tracing.py), which the client
keeps among the job's logs. Span times are unix-epoch nanoseconds, the
clock of the profiler's events, so they line up with trace.py's device
ops. A program without the tracer writes no such line, and every reader
here then returns None. The readers take plain lists, so they run on
synthetic jobs too.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from .trace import merged

PREFIX = "trace spans: "
# spans that stand for the whole job or its align phase: an instant whose
# innermost span on the align thread is one of these has no name
UNNAMED = ("job", "align")


@dataclass(frozen=True)
class Span:
    id: int
    parent: int | None
    name: str
    thread: str
    start: int  # unix-epoch ns
    end: int
    cpu_ns: int = 0  # the thread's CPU time inside the span
    attrs: dict | None = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


@dataclass
class JobSpans:
    """One job's exported record."""

    job: int
    spans: list[Span]
    counters: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)

    def named(self, name: str) -> list[Span]:
        return [span for span in self.spans if span.name == name]

    def seconds(self, name: str) -> float:
        """Summed seconds of the spans `name` that have no ancestor of
        the same name (so a nested repeat is not counted twice)."""
        by_id = {span.id: span for span in self.spans}
        total = 0
        for span in self.named(name):
            parent = by_id.get(span.parent)
            while parent is not None and parent.name != name:
                parent = by_id.get(parent.parent)
            if parent is None:
                total += span.end - span.start
        return total / 1e9

    def thread_of(self, name: str) -> str | None:
        """The thread of the first span `name`, None without one."""
        found = self.named(name)
        return found[0].thread if found else None


def parse(lines) -> JobSpans | None:
    """The job's record from its log lines; None without a `trace spans:`
    line."""
    for line in lines:
        if line.startswith(PREFIX):
            data = json.loads(line[len(PREFIX):])
            fields = data["fields"]
            threads = data["threads"]
            spans = []
            for row in data["spans"]:
                item = dict(zip(fields, row))
                spans.append(Span(
                    item["id"], item["parent"], item["name"],
                    threads[item["thread"]], item["start_ns"],
                    item["end_ns"], item["cpu_ns"], item["attrs"],
                ))
            return JobSpans(data["job"], spans, data.get("counters", {}),
                            data.get("launches", {}))
    return None


def traced_jobs(run) -> list:
    """[(job, JobSpans)] of the window's successful jobs that carry the
    line (parsed once a job)."""
    out = []
    for job in run.ok_jobs:
        if not hasattr(job, "_trace_spans"):
            job._trace_spans = parse(job.reply.logs)
        if job._trace_spans is not None:
            out.append((job, job._trace_spans))
    return out


def per_kread(run, value) -> float | None:
    """Sum of value(JobSpans) over the traced jobs, per 1000 of their
    reads; None without a traced job."""
    jobs = traced_jobs(run)
    reads = sum(job.reads for job, _ in jobs)
    if not jobs or not reads:
        return None
    return sum(value(spans) for _, spans in jobs) * 1000.0 / reads


def counter_sum(run, name: str) -> int | None:
    jobs = traced_jobs(run)
    if not jobs:
        return None
    return sum(spans.counters.get(name, 0) for _, spans in jobs)


def _covered(intervals, lo: int, hi: int) -> int:
    return sum(end - start for start, end in
               merged([(None, a, b) for a, b in intervals], lo, hi))


def self_seconds(spans: list[Span], root: str, prefix: str,
                 leave_out=()) -> float:
    """Self time of every span `root` and of its descendants whose name
    starts with `prefix`, those named in `leave_out` left out: each one's
    duration less what its children on its own thread cover (a child on
    another thread runs beside it)."""
    children: dict[int, list[Span]] = {}
    for span in spans:
        children.setdefault(span.parent, []).append(span)
    total = 0
    todo = [span for span in spans if span.name == root]
    while todo:
        span = todo.pop()
        kids = children.get(span.id, [])
        todo.extend(kids)
        if span.name == root or (span.name.startswith(prefix)
                                 and span.name not in leave_out):
            same = [(kid.start, kid.end) for kid in kids
                    if kid.thread == span.thread]
            total += (span.end - span.start) - _covered(
                same, span.start, span.end)
    return total / 1e9


def innermost(spans: list[Span]) -> list[tuple[int, int, str]]:
    """Spans of one thread (nested, as context managers leave them) as
    consecutive (start, end, name) pieces, each named by the innermost
    span open over it; no piece where no span is open."""
    pieces = []
    stack: list[Span] = []
    cursor = 0

    def close_until(time: int) -> None:
        nonlocal cursor
        while stack and stack[-1].end <= time:
            top = stack.pop()
            if top.end > cursor:
                pieces.append((cursor, top.end, top.name))
            cursor = max(cursor, top.end)

    for span in sorted(spans, key=lambda s: (s.start, -s.end)):
        close_until(span.start)
        if stack and span.start > cursor:
            pieces.append((cursor, span.start, stack[-1].name))
        stack.append(span)
        cursor = max(cursor, span.start)
    close_until(float("inf"))
    return pieces


def idle_intervals(device_ops, lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi) with no device op running."""
    edges = [lo]
    for start, end in merged(device_ops, lo, hi):
        edges.extend((start, end))
    edges.append(hi)
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def align_thread_pieces(jobs) -> list[tuple[int, int, str]]:
    """The innermost-span pieces of each job's align thread (the thread
    its `align` span ran on), over all jobs, in time order."""
    pieces = []
    for spans in jobs:
        thread = spans.thread_of("align")
        if thread is None:
            continue
        pieces.extend(innermost(
            [span for span in spans.spans if span.thread == thread]))
    return sorted(pieces)


def idle_by_span(trace, jobs) -> dict:
    """Seconds of the window's device-idle time by the innermost span open
    on the align thread then; None collects the instants with no span."""
    lo, hi = trace.window
    idle = idle_intervals(trace.device_ops, lo, hi)
    pieces = align_thread_pieces(jobs)
    out: dict = {}
    total = sum(end - start for start, end in idle)
    named = 0
    p = 0
    for start, end in idle:
        while p < len(pieces) and pieces[p][1] <= start:
            p += 1
        q = p
        while q < len(pieces) and pieces[q][0] < end:
            a, b, name = pieces[q]
            overlap = min(b, end) - max(a, start)
            if overlap > 0:
                out[name] = out.get(name, 0) + overlap
                named += overlap
            q += 1
    out[None] = max(total - named, 0)
    return {name: ns / 1e9 for name, ns in out.items()}


def unattributed_share(trace, jobs) -> float | None:
    """Percent of the window's device-idle time during which the align
    thread had no span open below `job` or `align`, or none at all."""
    seconds = idle_by_span(trace, jobs)
    total = sum(seconds.values())
    if total <= 0:
        return None
    unnamed = sum(seconds.get(name, 0.0) for name in (None, *UNNAMED))
    return 100.0 * unnamed / total
