"""The profiler reader on a synthetic trace."""

import pytest

from benchmark.trace import (
    WINDOW, Trace, idle_gaps, merged, short_name, top_ops, union_seconds,
)

MS = 1_000_000


def synthetic() -> Trace:
    return Trace(
        device_ops=[
            ("void (anonymous namespace)::myers_banded_reg_kernel<12>"
             "(unsigned char const*, int)", 10 * MS, 30 * MS),
            ("void myers_banded_reg_kernel<12>(unsigned char const*, int)",
             25 * MS, 40 * MS),  # overlaps the first: counted once
            ("(anonymous namespace)::workqueue_kernel(FmRankTable)",
             60 * MS, 65 * MS),
            ("Memcpy HtoD (Pageable -> Device)", 90 * MS, 120 * MS),
        ],
        host_ops=[
            (WINDOW, 0, 100 * MS),
            ("job 0", 0, 100 * MS),
            ("aten::index_select", 42 * MS, 58 * MS),
        ],
        window=(0, 100 * MS),
    )


def test_busy_union_clips_to_the_window():
    trace = synthetic()
    # [10, 40) + [60, 65) + [90, 100) of the 100 ms window
    assert trace.busy_s() == pytest.approx(0.045)
    assert trace.window_s == pytest.approx(0.1)
    assert merged([("a", 5, 7), ("b", 6, 9), ("c", 12, 13)], 0, 100) == [
        (5, 9), (12, 13)]
    assert union_seconds([("a", 0, 10**9)], 0, 5 * 10**8) == 0.5


def test_kernel_time_by_name():
    trace = synthetic()
    assert trace.kernel_seconds(r"\bmyers_\w*kernel\b") == pytest.approx(0.035)
    assert trace.kernel_seconds(r"\bworkqueue_kernel\b") == pytest.approx(0.005)
    assert trace.kernel_seconds(r"\bselect_kernel\b") == 0.0
    assert short_name(trace.device_ops[0][0]) == "myers_banded_reg_kernel<12>"
    assert top_ops(trace) == [
        ["myers_banded_reg_kernel<12>", pytest.approx(0.035)],
        ["Memcpy HtoD", pytest.approx(0.010)],
        ["workqueue_kernel", pytest.approx(0.005)],
    ]


def test_idle_gaps_are_named_by_the_host_op_across_them():
    assert idle_gaps(synthetic()) == [
        ["job 0", pytest.approx(0.025)],  # [65, 90): no torch op there
        ["aten::index_select", pytest.approx(0.020)],  # [40, 60)
        ["job 0", pytest.approx(0.010)],  # [0, 10)
    ]
    assert idle_gaps(Trace(window=(0, MS))) == [["no host op", 0.001]]
    assert len(idle_gaps(synthetic(), count=1)) == 1
