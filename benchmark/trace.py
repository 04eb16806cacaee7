"""The device trace of a window: torch.profiler, read back.

The window runs under torch.profiler (CPU and CUDA activity) in the
process that hosts the server, so every kernel, copy and fill that the
program's jobs put on the card is in it, with the host's torch ops and the
benchmark's own annotations (`benchmark_window`, `job <n>`). The readers
here take plain lists of (name, start_ns, end_ns), so they run on
synthetic traces too.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

WINDOW = "benchmark_window"


@dataclass
class Trace:
    device_ops: list[tuple[str, int, int]] = field(default_factory=list)
    host_ops: list[tuple[str, int, int]] = field(default_factory=list)
    window: tuple[int, int] = (0, 0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return union_seconds(self.device_ops, *self.window)

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time of the ops whose name matches `pattern`,
        inside the window."""
        regex = re.compile(pattern)
        lo, hi = self.window
        return sum(
            max(0, min(end, hi) - max(start, lo))
            for name, start, end in self.device_ops
            if regex.search(name)
        ) / 1e9


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    name = name.strip()
    return name[5:] if name.startswith("void ") else name


def merged(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of [start, end) intervals clipped to [lo, hi), in order."""
    spans = sorted(
        (max(start, lo), min(end, hi)) for _, start, end in intervals
        if end > lo and start < hi
    )
    out: list[list[int]] = []
    for start, end in spans:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(start, end) for start, end in out]


def union_seconds(intervals, lo: int, hi: int) -> float:
    return sum(end - start for start, end in merged(intervals, lo, hi)) / 1e9


def top_ops(trace: Trace, count: int = 10) -> list[list]:
    """The device ops that took most time in the window, by short name."""
    totals: dict[str, int] = {}
    lo, hi = trace.window
    for name, start, end in trace.device_ops:
        overlap = min(end, hi) - max(start, lo)
        if overlap > 0:
            key = short_name(name)
            totals[key] = totals.get(key, 0) + overlap
    ranked = sorted(totals.items(), key=lambda item: -item[1])[:count]
    return [[name, total / 1e9] for name, total in ranked]


def idle_gaps(trace: Trace, count: int = 10) -> list[list]:
    """The longest stretches of the window with nothing on the device,
    each named by the innermost host op running at its middle (a torch op
    before the `job <n>` span around it; "no host op" where none ran)."""
    lo, hi = trace.window
    busy = merged(trace.device_ops, lo, hi)
    edges = [lo] + [edge for span in busy for edge in span] + [hi]
    gaps = sorted(
        ((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
         if edges[i + 1] > edges[i]),
        key=lambda gap: gap[0] - gap[1],
    )[:count]
    hosts = [op for op in trace.host_ops if op[0] != WINDOW]
    starts = np.array([op[1] for op in hosts], dtype=np.int64)
    ends = np.array([op[2] for op in hosts], dtype=np.int64)
    out = []
    for start, end in gaps:
        middle = (start + end) // 2
        across = np.flatnonzero((starts <= middle) & (ends > middle))
        label = "no host op"
        if len(across):
            label = hosts[across[np.argmin((ends - starts)[across])]][0]
        out.append([label, (end - start) / 1e9])
    return out


class Profiler:
    """torch.profiler around a window; `trace()` after `stop()`."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._profile = profile(activities=activities)

    def start(self) -> None:
        self._profile.start()

    def stop(self) -> None:
        self._profile.stop()

    def trace(self) -> Trace:
        from torch.autograd import DeviceType

        out = Trace()
        window = None
        for event in self._profile.profiler.kineto_results.events():
            start = _start_ns(event)
            item = (event.name(), start, start + _duration_ns(event))
            if event.device_type() == DeviceType.CUDA:
                out.device_ops.append(item)
            else:
                out.host_ops.append(item)
                if item[0] == WINDOW:
                    window = item[1:]
        if window is None:
            raise RuntimeError("the trace holds no benchmark_window span")
        out.window = window
        return out


def _start_ns(event) -> int:
    if hasattr(event, "start_ns"):
        return int(event.start_ns())
    return int(event.start_us() * 1000)


def _duration_ns(event) -> int:
    if hasattr(event, "duration_ns"):
        return int(event.duration_ns())
    return int(event.duration_us() * 1000)
