"""The port's bucketed device batcher and legacy object path against the
reference (floxer_tpu_torch/verify_batch.py, ops/resident.py).

The resident host entries must equal floxer_tpu's (Pallas in interpret
mode) on banks passed across with ResidentBank.from_words; the port's
_TaskBatcher with use_device=True on the CPU must equal the reference
_TaskBatcher on resident and host-slice buckets; and the legacy object
path (FLOXER_TPU_LEGACY_VERIFY=1, or no native library) must write the
sequential verifier's alignments."""

import numpy as np
import pytest
import torch

import floxer_tpu.verify_batch as jax_vb
import floxer_tpu.warm_shapes as warm_shapes
import floxer_tpu_torch.native as native
from floxer_tpu.ops import resident as jres
from floxer_tpu.ops.pallas_myers_banded import EFFECTIVE_GROUP
from floxer_tpu_torch import tracing
from floxer_tpu_torch import verify_batch as vb
from floxer_tpu_torch.ops import resident as tres
from floxer_tpu_torch.verify import VerificationKind
from test_torch_fused import (
    assert_same_alignments,
    port_workload,
    reference_alignments,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_warm_shape_store(monkeypatch):
    """The reference records dispatched bucket shapes in a file; the tests
    leave no such file behind."""
    monkeypatch.setattr(warm_shapes, "record_shape", lambda desc: None)


def mutated(rng, seq, count):
    out = seq.copy()
    for pos in rng.integers(0, len(out), size=count):
        out[pos] = 1 + (out[pos] % 4)
    return out


def make_banks(seed, ref_len=12_000, read_len=5000):
    """Two references, three reads sampled from them with substitutions;
    the reference's banks and the port's over the same packed words."""
    rng = np.random.default_rng(seed)
    refs = [
        rng.integers(1, 5, size=ref_len).astype(np.uint8) for _ in range(2)
    ]
    origins = []
    reads = []
    for r in range(3):
        ref = r % 2
        start = int(rng.integers(500, ref_len - read_len - 500))
        origins.append((ref, start))
        reads.append(mutated(rng, refs[ref][start : start + read_len], 40))
    jax_banks = (jres.ResidentBank(refs), jres.ResidentBank(reads))
    port_banks = tuple(
        tres.ResidentBank.from_words(np.asarray(b.flat), b.base_chars, CPU)
        for b in jax_banks
    )
    return rng, refs, reads, origins, jax_banks, port_banks


def task(rng, refs, reads, origins, jax_banks, read, offset, m, budget):
    """(pattern, window, budget, pat_addr, win_addr): the pattern is
    reads[read][offset:offset+m], the window its origin widened by
    the budget plus some slack."""
    ref, start = origins[read]
    win_start = start + offset - budget - int(rng.integers(0, 10))
    win_len = m + 2 * budget + 1 + int(rng.integers(0, 30))
    return (
        reads[read][offset : offset + m],
        refs[ref][win_start : win_start + win_len],
        budget,
        jax_banks[1].base(read) + offset,
        jax_banks[0].base(ref) + win_start,
    )


def test_banded_resident_matches_reference():
    rng, refs, reads, origins, jax_banks, port_banks = make_banks(1)
    tasks = [
        task(rng, refs, reads, origins, jax_banks, r, 100 * r, m, m // 10)
        for r, m in ((0, 300), (1, 900), (2, 1500), (0, 2000))
    ]
    win_starts = np.asarray([t[4] for t in tasks], np.int64)
    win_lens = np.asarray([len(t[1]) for t in tasks], np.int64)
    pat_starts = np.asarray([t[3] for t in tasks], np.int64)
    pat_lens = np.asarray([len(t[0]) for t in tasks], np.int64)
    budgets = np.asarray([t[2] for t in tasks], np.int64)
    # the reference's caller pads the batch to the kernel's task group
    pad = EFFECTIVE_GROUP - len(tasks)

    def padded(values, fill):
        return np.concatenate([values, np.full(pad, fill, np.int64)])

    want = jres.myers_banded_resident(
        *jax_banks,
        padded(win_starts, 0), padded(win_lens, 1), padded(pat_starts, 0),
        padded(pat_lens, 2), padded(budgets, 1),
        band_words=128, num_text=2400, interpret=True,
    )
    got = tres.myers_banded_resident(
        *port_banks, win_starts, win_lens, pat_starts, pat_lens, budgets,
        band_words=128, num_text=2400,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w)[: len(tasks)])
    lazy = tres.myers_banded_resident(
        *port_banks, win_starts, win_lens, pat_starts, pat_lens, budgets,
        band_words=128, num_text=2400, sync=False,
    )
    assert all(isinstance(t, torch.Tensor) for t in lazy)
    np.testing.assert_array_equal(lazy[0].numpy(), got[0])


@pytest.mark.parametrize("m_bucket,group", [(256, 128), (1536, 8)])
def test_full_resident_matches_reference(m_bucket, group):
    """K2 (<= 8 words) and K3 buckets on resident banks."""
    rng, refs, reads, origins, jax_banks, port_banks = make_banks(2)
    tasks = [
        task(
            rng, refs, reads, origins, jax_banks, i % 3, 37 * i,
            int(rng.integers(m_bucket // 2, m_bucket)), m_bucket // 20,
        )
        for i in range(6)
    ]
    num_text = max(len(t[1]) for t in tasks)
    num_text = -(-num_text // 8) * 8
    cols = [
        np.asarray([t[4] for t in tasks], np.int64),
        np.asarray([len(t[1]) for t in tasks], np.int64),
        np.asarray([t[3] for t in tasks], np.int64),
        np.asarray([len(t[0]) for t in tasks], np.int64),
    ]
    pad = group - len(tasks)
    want = jres.myers_full_resident(
        *jax_banks,
        *(np.concatenate([c, np.full(pad, f, np.int64)])
          for c, f in zip(cols, (0, 1, 0, 1))),
        m_bucket=m_bucket, num_text=num_text, interpret=True,
    )
    got = tres.myers_full_resident(
        *port_banks, *cols, m_bucket=m_bucket, num_text=num_text
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w)[: len(tasks)])


@pytest.mark.parametrize("resident", [True, False])
def test_task_batcher_matches_reference(monkeypatch, resident):
    """Banded (m > 4096, band narrower than the full state), small and
    large full buckets, all routed to the device (the port's use_device=True
    sends every bucket; the reference's needs MIN_DEVICE_CELLS 0 for its
    full buckets): the port's batcher equals the reference's."""
    monkeypatch.setattr(vb, "MIN_DEVICE_CELLS", 10**12)
    monkeypatch.setattr(jax_vb, "MIN_DEVICE_CELLS", 0)
    rng, refs, reads, origins, jax_banks, port_banks = make_banks(3)
    tasks = [task(rng, refs, reads, origins, jax_banks, 0, 200, 4200, 120)]
    tasks.append(task(rng, refs, reads, origins, jax_banks, 1, 10, 4100, 100))
    for i in range(8):
        m = int(rng.integers(40, 250))
        tasks.append(
            task(rng, refs, reads, origins, jax_banks, i % 3, 50 * i, m, m // 8)
        )
    for i in range(4):
        m = int(rng.integers(300, 1200))
        tasks.append(
            task(rng, refs, reads, origins, jax_banks, i % 3, 90 * i, m, m // 9)
        )
    # a pattern against an unrelated window: a distance past its budget
    tasks.append(task(rng, refs, reads, origins, jax_banks, 2, 0, 500, 50))
    tasks[-1] = tasks[-1][:1] + (refs[0][:600],) + tasks[-1][2:4] + (
        jax_banks[0].base(0),
    )

    def fill(batcher):
        for key, (pattern, window, budget, pat_addr, win_addr) in enumerate(
            tasks
        ):
            batcher.add(
                key, pattern, window, key, budget=budget,
                pat_addr=pat_addr, win_addr=win_addr,
            )
        batcher.add(0, *tasks[0][:2], 99, budget=tasks[0][2])  # a duplicate
        return batcher

    want = fill(
        jax_vb._TaskBatcher(True, resident=jax_banks if resident else None)
    ).run()
    port = fill(
        vb._TaskBatcher(
            True, resident=port_banks if resident else None, device=CPU
        )
    )
    with tracing.job() as job:
        got = port.run()
    # banded and full buckets
    assert job.counter("verify.device_calls") >= 2
    assert port.owners[0] == [0, 99]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the native host engine agrees wherever the pipeline reads a result
    # (within budget; past it the banded host engine only bounds it)
    host = fill(jax_vb._TaskBatcher(False)).run()
    budgets = np.asarray([t[2] for t in tasks])
    accepted = got[0] <= budgets
    assert accepted.sum() >= 10
    np.testing.assert_array_equal(accepted, host[0] <= budgets)
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g[accepted], h[accepted])


def test_task_batcher_device_needs_a_device():
    batcher = vb._TaskBatcher(True)
    batcher.add(0, np.ones(20, np.uint8), np.ones(30, np.uint8), 0, budget=2)
    with pytest.raises(ValueError, match="needs a device"):
        batcher.run()


@pytest.mark.parametrize("interval_opt", [False, True])
@pytest.mark.parametrize("without_cigar", [False, True])
@pytest.mark.parametrize("use_device", [False, True])
@pytest.mark.parametrize("mode", ["legacy_env", "no_native"])
def test_legacy_path_matches_sequential(
    monkeypatch, mode, use_device, without_cigar, interval_opt
):
    """The legacy object path, selected by FLOXER_TPU_LEGACY_VERIFY or by a
    missing native library; with use_device its buckets run on the CPU
    device (resident banks for the forward tasks, host slices for the
    reversed without-CIGAR batch)."""
    want = reference_alignments(
        42, VerificationKind.HIERARCHICAL, 0.3, without_cigar, interval_opt
    )
    references, items = port_workload(seed=42)
    if mode == "legacy_env":
        monkeypatch.setenv("FLOXER_TPU_LEGACY_VERIFY", "1")
    else:
        monkeypatch.setattr(native, "get_library", lambda: None)
    verifier = vb.BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.3,
        without_cigar=without_cigar,
        use_interval_optimization=interval_opt,
        use_device=use_device,
        resident_ref=(
            tres.ResidentBank([r.rank_sequence for r in references], CPU)
            if use_device
            else None
        ),
    )
    with tracing.job() as job:
        got = verifier.process(items)
    assert not verifier._soa_active
    assert (job.counter("verify.device_calls") > 0) == use_device
    assert_same_alignments(want, got)
