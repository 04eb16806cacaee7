"""Spans and counters of one alignment job, on the device trace's clock.

One job (a server request, or a CLI run) is the unit: every span and
counter belongs to the job that is current where it is opened, and the
job follows work handed to a pool through `submit`, so a span
opened on the search worker, the finalize thread or the traceback pool
has the job's id and the submitting span as its parent.

    with tracing.span("verify.wave", walks=n) as wave:
        ...
        wave.set(route="split")
    tracing.count("verify.cells_host", cells)

Off (the default) a span reads the clock twice and adds its duration to
the job's per-name sums; it keeps no record. The `stage split:` line and
chip_smoke.py read those sums (`Job.seconds`). On, each span is also kept
(id, parent, thread, start and end, the thread's CPU time inside it, its
attrs; at most SPAN_CAP a job) and entered as a torch.profiler
`record_function`, so a profiler that records the thread shows it. A job
is on when a torch.profiler is running anywhere in the process as it
starts (the benchmark's `--trace 1` window), or when the run asks for
`--profile`; its owner then logs one `trace spans: <json>` line at its
end (`Job.line`).

Durations come from time.perf_counter_ns(); a job records the offset to
time.time_ns() as it starts, and the export adds it, so exported times
are unix-epoch nanoseconds, the clock of torch.profiler's events.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time

SPAN_CAP = 50_000
LINE_PREFIX = "trace spans: "
SPAN_FIELDS = ("id", "parent", "name", "thread", "start_ns", "end_ns",
               "cpu_ns", "attrs")

# (job, id of the innermost open span or None) where a job is current
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "floxer_tpu_torch_trace", default=None
)
_SPAN_IDS = itertools.count(1)
_JOB_IDS = itertools.count(1)
_LAST_JOB = None
# torch.autograd.profiler.record_function, imported by the first job with
# tracing on
_record_function = None


def now() -> int:
    """The tracer's clock: time.perf_counter_ns()."""
    return time.perf_counter_ns()


def profiler_running() -> bool:
    """True while a torch.profiler runs anywhere in the process
    (`_is_profiler_enabled` is process-wide; the C++ flag is per thread).
    False where this torch has no such flag."""
    try:
        from torch.autograd import profiler
    except ImportError:
        return False
    return bool(getattr(profiler, "_is_profiler_enabled", False))


class Job:
    """One job's per-name span sums and counters; with tracing on, its
    span records too."""

    def __init__(self, on: bool):
        global _record_function
        if on and _record_function is None:
            from torch.autograd.profiler import record_function

            _record_function = record_function
        self.id = next(_JOB_IDS)
        self.on = on
        self.spans: list | None = [] if on else None
        self.sums: dict[str, int] = {}
        self.counters: dict[str, int] = {}
        self.launches: dict[str, int] = {}
        self._lock = threading.Lock()
        unix = time.time_ns()
        self.offset_ns = unix - time.perf_counter_ns()

    def _add(self, name: str, ns: int) -> None:
        with self._lock:
            self.sums[name] = self.sums.get(name, 0) + ns

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def seconds(self, name: str) -> float:
        """Summed seconds of every span `name` of this job so far."""
        return self.sums.get(name, 0) / 1e9

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)

    def _record(self, record: tuple) -> None:
        if len(self.spans) < SPAN_CAP:
            self.spans.append(record)
        else:
            self.count("trace.dropped_spans")

    def export(self) -> dict:
        """The job's spans (unix-epoch ns), counters and kernel launches."""
        threads: dict[str, int] = {}
        spans = []
        for sid, parent, name, thread, start, end, cpu, attrs in (
            self.spans or ()
        ):
            spans.append([
                sid, parent, name, threads.setdefault(thread, len(threads)),
                start + self.offset_ns, end + self.offset_ns, cpu, attrs,
            ])
        return {
            "job": self.id, "clock": "unix_ns", "fields": list(SPAN_FIELDS),
            "threads": list(threads), "spans": spans,
            "counters": dict(self.counters), "launches": dict(self.launches),
        }

    def line(self) -> str:
        """The `trace spans:` log line: compact JSON of export()."""
        return LINE_PREFIX + json.dumps(self.export(), separators=(",", ":"))


class Span:
    """A span of the current job (see span()); outside a job it costs one
    context-variable read."""

    __slots__ = ("name", "attrs", "_job", "_start", "_id", "_parent",
                 "_token", "_cpu", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "Span":
        state = _CURRENT.get()
        if state is None:
            self._job = None
            return self
        job, parent = state
        self._job = job
        if job.spans is not None:
            self._id = next(_SPAN_IDS)
            self._parent = parent
            self._token = _CURRENT.set((job, self._id))
            self._rf = _record_function(self.name)
            self._rf.__enter__()
            self._cpu = time.thread_time_ns()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        job = self._job
        if job is None:
            return False
        job._add(self.name, end - self._start)
        if job.spans is not None:
            cpu = time.thread_time_ns() - self._cpu
            self._rf.__exit__(None, None, None)
            _CURRENT.reset(self._token)
            job._record((self._id, self._parent, self.name,
                         threading.current_thread().name, self._start, end,
                         cpu, self.attrs or None))
        return False

    @property
    def on(self) -> bool:
        """True when this span is being recorded."""
        return self._job is not None and self._job.spans is not None

    def set(self, **attrs) -> None:
        """Add attrs to a recorded span (nothing when off)."""
        if self.on:
            self.attrs.update(attrs)


def span(name: str, **attrs) -> Span:
    """A context manager timing `name` in the current job."""
    return Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add n to the current job's counter `name`."""
    state = _CURRENT.get()
    if state is not None:
        state[0].count(name, n)


def current() -> Job | None:
    """The current job, or None outside one."""
    state = _CURRENT.get()
    return None if state is None else state[0]


def last_job() -> Job | None:
    """The job that ended last in this process."""
    return _LAST_JOB


def submit(pool, fn, *args, **kwargs):
    """pool.submit(fn, *args, **kwargs) in a copy of the caller's
    context: on the pool's thread, fn's spans belong to the caller's job
    and have the caller's open span as parent."""
    return pool.submit(contextvars.copy_context().run, fn, *args, **kwargs)


class job:
    """The scope of one job and its `job` span. Inside a job already it
    is that job and does nothing more, so the server's job and the
    pipeline's run are one. `on`: True turns tracing on; else it is on
    while a profiler runs. `started_ns`: where the `job` span starts (a
    now() taken earlier), else on entry. `emit`: called with the `trace
    spans:` line at the end of a job with tracing on."""

    def __init__(self, on: bool = False, started_ns: int | None = None,
                 emit=None):
        self._on = on
        self._started = started_ns
        self._emit = emit
        self._owner = False

    def __enter__(self) -> Job:
        state = _CURRENT.get()
        if state is not None:
            return state[0]
        self._owner = True
        self.job = Job(self._on or profiler_running())
        self._token = _CURRENT.set((self.job, None))
        self._span = Span("job", {})
        self._span.__enter__()
        if self._started is not None:
            self._span._start = self._started
        return self.job

    def __exit__(self, *exc) -> bool:
        global _LAST_JOB
        if not self._owner:
            return False
        self._span.__exit__(*exc)
        _CURRENT.reset(self._token)
        _LAST_JOB = self.job
        if self.job.on and self._emit is not None:
            self._emit(self.job.line())
        return False
