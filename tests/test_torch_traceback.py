"""The port's device traceback (floxer_tpu_torch/ops/traceback_device.py)
against floxer_tpu.ops.traceback_device and the host traceback.

On the CPU the K4 wrapper runs its plain PyTorch version. The same seeded
tasks go through the reference's XLA program _banded_directions_and_walk:
walk ops, op counts and begin columns must be identical. The batched entry
must equal dp_reference.banded_cigar_traceback (the host pool's traceback,
native/traceback.cpp) for every task, whatever the batch, and the port's
BatchVerifier with FLOXER_TPU_DEVICE_TRACEBACK=1 on a CPU device must
write the host pool's alignments."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floxer_tpu.ops import dp_reference
from floxer_tpu.ops import traceback_device as jax_tb
from floxer_tpu_torch.ops import traceback_device as port_tb
from test_traceback_device import _random_task

CPU = torch.device("cpu")


def fuzz_tasks(seed, count=12):
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(count):
        ref_len = int(rng.integers(40, 200))
        pat_len = int(rng.integers(8, min(ref_len, 90)))
        tasks.append(
            _random_task(rng, ref_len, pat_len, int(rng.integers(0, 6)))
        )
    return tasks


def tie_heavy_tasks():
    """Homopolymers and tandem repeats: many DP ties."""
    rng = np.random.default_rng(99)
    tasks = []
    for unit_len in (1, 2, 3):
        unit = rng.integers(1, 5, size=unit_len).astype(np.uint8)
        window = np.tile(unit, 40 // unit_len + 1)[:40]
        pattern = np.tile(unit, 20 // unit_len + 1)[:20].copy()
        pattern[7] = 1 + (pattern[7] % 4)
        tasks.append(task_for(window, pattern))
    return tasks


def task_for(window, pattern):
    dp = dp_reference.semi_global_dp_matrix(window, pattern)
    end_col = dp_reference._rightmost_argmin(dp[-1])
    return window, pattern, end_col, int(dp[-1, end_col])


def edge_tasks():
    """Distance 0, a band clipped at column 0, a pattern longer than the
    window section (forced I runs)."""
    window = np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2], dtype=np.uint8)
    pattern0 = window[:4].copy()
    pattern0[1] = 1 + (pattern0[1] % 4)
    exact = window[2:7].copy()
    tasks = [task_for(window, exact)]
    tasks[0] = tasks[0][:3] + (0,)
    tasks.append(task_for(window, pattern0))
    tasks.append(
        task_for(window, np.concatenate([window[1:8], np.ones(2, np.uint8)]))
    )
    return tasks


CASES = {
    "fuzz1": (lambda: fuzz_tasks(1), 32, 16),
    "fuzz2": (lambda: fuzz_tasks(2), 32, 16),
    "fuzz3": (lambda: fuzz_tasks(3), 32, 16),
    "ties": (tie_heavy_tasks, 32, 16),
    "edges": (edge_tasks, 8, 8),
}


def padded_inputs(tasks, m_pad, w_pad, n_pad):
    T = len(tasks)
    windows = np.zeros((T, n_pad), dtype=np.int32)
    patterns = np.zeros((T, m_pad), dtype=np.int32)
    scalars = np.zeros((4, T), dtype=np.int32)
    for s, (window, pattern, end_col, distance) in enumerate(tasks):
        windows[s, : len(window)] = window
        patterns[s, : len(pattern)] = pattern
        scalars[:, s] = (len(window), len(pattern), end_col, distance)
    return windows, patterns, scalars


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_walk_matches_reference_program(case):
    make, m_quantum, w_quantum = CASES[case]
    tasks = make()
    m_pad = max(port_tb._pad_quantum(len(t[1]), m_quantum) for t in tasks)
    n_pad = max(port_tb._pad_quantum(len(t[0]), m_quantum) for t in tasks)
    w_pad = max(
        port_tb._pad_quantum(2 * max(t[3], 0) + 1, w_quantum) for t in tasks
    )
    windows, patterns, scalars = padded_inputs(tasks, m_pad, w_pad, n_pad)
    want = jax_tb._banded_directions_and_walk(
        jnp.asarray(windows), jnp.asarray(patterns),
        *(jnp.asarray(s) for s in scalars),
        m_pad=m_pad, w_pad=w_pad, n_pad=n_pad,
    )
    got = port_tb.banded_directions_and_walk(
        torch.from_numpy(windows), torch.from_numpy(patterns),
        *(torch.from_numpy(np.ascontiguousarray(s)) for s in scalars),
        m_pad=m_pad, w_pad=w_pad, n_pad=n_pad,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("budget_bytes", [1, 1 << 30])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_matches_host_traceback(case, budget_bytes):
    """Byte-identical (begin, CIGAR) to the host traceback, one task per
    launch or all of a bucket in one."""
    make, m_quantum, w_quantum = CASES[case]
    tasks = make()
    got = port_tb.banded_cigar_traceback_device_batch(
        tasks, CPU, m_quantum=m_quantum, w_quantum=w_quantum,
        budget_bytes=budget_bytes,
    )
    for t, (window, pattern, end_col, distance) in enumerate(tasks):
        want = dp_reference.banded_cigar_traceback(
            window, pattern, end_col, distance
        )
        assert got[t] == want, f"task {t}: {got[t]} != {want}"


def test_rle_matches_reference():
    codes = np.array([1, 1, 0, 2, 2, 2, 3, 1], dtype=np.int8)
    assert port_tb._rle_from_reversed_ops(codes) == (
        jax_tb._rle_from_reversed_ops(codes)
    )
    assert port_tb._rle_from_reversed_ops(codes[:0]) == []


def test_wrapper_checks_operands():
    ints = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="windows"):
        port_tb.banded_directions_and_walk(
            torch.zeros((2, 8), dtype=torch.int64),
            torch.zeros((2, 8), dtype=torch.int32),
            ints, ints, ints, ints, m_pad=8, w_pad=4, n_pad=8,
        )


def test_batch_verifier_device_traceback_end_to_end(monkeypatch):
    """The port's BatchVerifier with FLOXER_TPU_DEVICE_TRACEBACK=1 on a CPU
    device emits the host pool's alignments (begin + CIGAR), and without a
    device it refuses instead of running the tracebacks elsewhere."""
    from floxer_tpu_torch.verify import VerificationKind
    from floxer_tpu_torch.verify_batch import BatchVerifier
    from test_torch_fused import assert_same_alignments, port_workload

    references, items = port_workload(seed=11)

    def run(device):
        verifier = BatchVerifier(
            references,
            kind=VerificationKind.HIERARCHICAL,
            extra_verification_ratio=0.3,
            without_cigar=False,
            use_interval_optimization=True,
            use_device=False,
            device=device,
        )
        out = verifier.process(items)
        assert not verifier._device_tb_tasks
        return out

    monkeypatch.setenv("FLOXER_TPU_DEVICE_TRACEBACK", "0")
    want = run(None)

    calls = {"n": 0, "tasks": 0}
    original = port_tb.banded_cigar_traceback_device_batch

    def counting(tasks, device, **kwargs):
        assert device == CPU
        calls["n"] += 1
        calls["tasks"] += len(tasks)
        return original(tasks, device, **kwargs)

    monkeypatch.setattr(port_tb, "banded_cigar_traceback_device_batch", counting)
    monkeypatch.setenv("FLOXER_TPU_DEVICE_TRACEBACK", "1")
    got = run(CPU)
    assert calls["tasks"] > 0, "device traceback path was never exercised"
    assert_same_alignments(want, got)
    with pytest.raises(ValueError, match="device"):
        run(None)
