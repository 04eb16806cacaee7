"""The port's fused wave (floxer_tpu_torch/ops/fused_verify.py) and
verifier (floxer_tpu_torch/verify_batch.py) against the reference.

FusedBatch: per-task (distance, end) equal to floxer_tpu's FusedBatch with
interpret-mode Pallas kernels on random multi-stage waves. BatchVerifier:
byte-identical alignments to the sequential verifier on the workloads of
tests/test_verify_batch.py, with every wave fused (on the CPU through the
kernels' plain versions).

Each side's inputs come from its own package: the reference runs on
test_verify_batch's workload, the port on the same workload built from
its own copies of the host modules (`port_workload`), and alignments are
compared by value (`values`)."""

import numpy as np
import pytest
import torch

import floxer_tpu.ops.fused_verify as jax_fused
from floxer_tpu.ops.resident import ResidentBank as JaxBank
from floxer_tpu.verify import VerificationKind as RefKind
from floxer_tpu_torch import tracing
from floxer_tpu_torch import verify_batch as vb
from floxer_tpu_torch.alphabet import reverse_complement
from floxer_tpu_torch.index.fmindex import FmIndex
from floxer_tpu_torch.io.sequence_io import QueryRecord
from floxer_tpu_torch.ops.fused_verify import FusedBatch
from floxer_tpu_torch.ops.resident import ResidentBank
from floxer_tpu_torch.pex import BuildStrategy, build_pex_tree
from floxer_tpu_torch.search_host import (
    AnchorChoiceStrategy,
    AnchorGroupOrder,
    SearchConfig,
    Searcher,
)
from floxer_tpu_torch.verify import ReferenceRecord, VerificationKind
from floxer_tpu_torch.verify_batch import BatchVerifier, _QueryItem
from test_verify_batch import _make_workload, _run_sequential

CPU = torch.device("cpu")


def port_workload(seed, num_queries=6, read_len=60, k=4, seed_errors=1):
    """test_verify_batch._make_workload's workload (same seed, same reads,
    same search) built from the port's own modules: (references, items)."""
    rng = np.random.default_rng(seed)
    references = [
        ReferenceRecord("ref0", rng.integers(1, 5, size=800).astype(np.uint8), 0),
        ReferenceRecord("ref1", rng.integers(1, 5, size=400).astype(np.uint8), 1),
    ]
    index = FmIndex([r.rank_sequence for r in references])
    searcher = Searcher(
        index,
        len(references),
        SearchConfig(
            max_num_anchors_hard=500,
            max_num_anchors_soft=50,
            anchor_group_order=AnchorGroupOrder.COUNT_FIRST,
            anchor_choice_strategy=AnchorChoiceStrategy.ROUND_ROBIN,
            erase_useless_anchors=True,
        ),
    )
    items = []
    for qi in range(num_queries):
        ref = references[qi % 2]
        start = int(rng.integers(0, len(ref.rank_sequence) - read_len))
        read = ref.rank_sequence[start : start + read_len].copy()
        for _ in range(int(rng.integers(0, k))):
            pos = int(rng.integers(0, read_len))
            read[pos] = 1 + (read[pos] % 4)
        record = QueryRecord(
            id=f"q{qi}",
            rank_sequence=read,
            reverse_complement_rank_sequence=reverse_complement(read),
            quality="I" * read_len,
            internal_id=qi,
        )
        tree = build_pex_tree(read_len, k, seed_errors, BuildStrategy.RECURSIVE)
        seeds = tree.generate_seeds(1)
        fwd = searcher.search_seeds(seeds, record.rank_sequence)
        rc = searcher.search_seeds(
            seeds, record.reverse_complement_rank_sequence
        )
        items.append(_QueryItem(record, tree, fwd, rc))
    return references, items


def reference_alignments(seed, kind, ratio, without_cigar, interval_opt,
                         **workload):
    """The reference's sequential verifier on its own workload; `kind` is
    the port's VerificationKind, mapped to the reference's by value."""
    references, items = _make_workload(seed=seed, **workload)
    return _run_sequential(
        references, items, RefKind(kind.value), ratio, without_cigar,
        interval_opt,
    )


def values(alignments):
    """A QueryAlignments of either package as plain values: per reference,
    (start, errors, orientation name, CIGAR tuples) per alignment."""
    return [
        [
            (a.start_in_reference, a.num_errors, a.orientation.value,
             tuple(a.cigar))
            for a in per_ref
        ]
        for per_ref in alignments.per_reference
    ]


def assert_same_alignments(want, got):
    assert len(want) == len(got)
    for qi, (w, g) in enumerate(zip(want, got)):
        assert values(w) == values(g), f"query {qi}"
        assert w.best_num_errors == g.best_num_errors


def stage_wave(seed, jax_batch_for, port_batch_for):
    """Walks of 3 chained levels (prefixes of a read) against random
    windows, so most walks die early and aliveness masking matters."""
    rng = np.random.default_rng(seed)
    refs = [
        rng.integers(1, 5, size=int(rng.integers(600, 1200))).astype(np.uint8)
        for _ in range(2)
    ]
    reads = []
    for _ in range(12):
        ref = refs[int(rng.integers(0, 2))]
        length = int(rng.integers(40, 300))
        start = int(rng.integers(0, len(ref) - length))
        read = ref[start : start + length].copy()
        for _ in range(int(rng.integers(0, 6))):
            pos = int(rng.integers(0, length))
            read[pos] = 1 + (read[pos] % 4)
        reads.append(read)
    jax_ref, jax_reads = JaxBank(refs), JaxBank(reads)
    jax_batch = jax_batch_for(jax_ref, jax_reads)
    port_batch = port_batch_for(
        ResidentBank.from_words(np.asarray(jax_ref.flat), jax_ref.base_chars, CPU),
        ResidentBank.from_words(
            np.asarray(jax_reads.flat), jax_reads.base_chars, CPU
        ),
    )
    refs_out = []
    for walk, read in enumerate(reads):
        length = len(read)
        for end in (length // 3, 2 * length // 3, length):
            budget = max(1, end // 10)
            ref_id = int(rng.integers(0, 2))
            win_start = int(
                rng.integers(0, len(refs[ref_id]) - end - 2 * budget - 1)
            )
            win_len = min(
                end + 2 * budget + 1 + int(rng.integers(0, 20)),
                len(refs[ref_id]) - win_start,
            )
            args = (
                walk, jax_ref.base(ref_id) + win_start, win_len,
                jax_reads.base(walk), end, budget,
            )
            refs_out.append((jax_batch.add_task(*args), port_batch.add_task(*args)))
    return jax_batch, port_batch, refs_out


@pytest.mark.parametrize("seed,force_banded", [(0, False), (1, True)])
def test_fused_batch_matches_reference(monkeypatch, seed, force_banded):
    monkeypatch.setattr(jax_fused, "_FORCE_BANDED", force_banded)
    jax_batch, port_batch, refs = stage_wave(
        seed,
        jax_fused.FusedBatch,
        lambda ref, reads: FusedBatch(ref, reads, force_banded=force_banded),
    )
    kinds = {kind for stage in port_batch.stages for kind in stage}
    assert kinds == ({"banded"} if force_banded else {"small", "large"})
    want = jax_batch.run(interpret=True)
    got = port_batch.run()
    for jax_ref, port_ref in refs:
        assert got[port_ref] == want[jax_ref], port_ref
    # aliveness chains across stages: some walks die, their later levels
    # return the sentinel (distance = pattern length, end 0)
    assert any(got[r][0] > 0 and got[r][1] == 0 for _, r in refs)


def test_fused_batch_empty_wave():
    bank = ResidentBank([np.ones(10, dtype=np.uint8)], CPU)
    batch = FusedBatch(bank, bank)
    assert batch.run() == {}
    assert batch.padded_cells() == 0


@pytest.mark.parametrize("interval_opt", [False, True])
@pytest.mark.parametrize("without_cigar", [False, True])
@pytest.mark.parametrize(
    "kind", [VerificationKind.HIERARCHICAL, VerificationKind.DIRECT_FULL]
)
def test_fused_verifier_matches_sequential(interval_opt, without_cigar, kind):
    want = reference_alignments(42, kind, 0.3, without_cigar, interval_opt)
    references, items = port_workload(seed=42)
    verifier = BatchVerifier(
        references,
        kind=kind,
        extra_verification_ratio=0.3,
        without_cigar=without_cigar,
        use_interval_optimization=interval_opt,
        use_device=True,
        resident_ref=ResidentBank([r.rank_sequence for r in references], CPU),
    )
    got = verifier.process(items)
    assert verifier._fused_dispatches > 0, "fused path never dispatched"
    assert_same_alignments(want, got)


@pytest.mark.parametrize("seed", [1, 7, 13])
def test_fused_verifier_matches_sequential_more_seeds(seed):
    want = reference_alignments(
        seed, VerificationKind.HIERARCHICAL, 0.05, False, True,
        num_queries=4, k=6,
    )
    references, items = port_workload(seed=seed, num_queries=4, k=6)
    verifier = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=True,
        resident_ref=ResidentBank([r.rank_sequence for r in references], CPU),
    )
    got = verifier.process(items)
    assert verifier._fused_dispatches > 0
    assert_same_alignments(want, got)


def test_split_wave_matches_sequential(monkeypatch):
    """Cost-model SPLIT routing: part of a wave runs fused while the host
    engine computes the rest; both shares exercised, output identical."""
    monkeypatch.setattr(vb, "_fused_call_overhead", lambda device: 0.0)
    monkeypatch.setattr(vb, "_PROBE_MIN_HOST_S", 0.0)
    monkeypatch.setattr(vb, "_FUSED_MIN_DEVICE_CELLS", 0.0)
    monkeypatch.setitem(vb._BAND_RATES, "host", 1e9)
    monkeypatch.setitem(vb._BAND_RATES, "device", 1.5e9)
    monkeypatch.setitem(vb._BAND_RATES, "host_pinned", True)
    monkeypatch.setitem(vb._BAND_RATES, "device_pinned", True)
    host_waves = []
    real_flat = BatchVerifier._compute_walks_flat

    def spy(self, walks, items, subset, max_depth=None):
        host_waves.append(len(subset))
        return real_flat(self, walks, items, subset, max_depth=max_depth)

    monkeypatch.setattr(BatchVerifier, "_compute_walks_flat", spy)
    want = reference_alignments(
        5, VerificationKind.HIERARCHICAL, 0.05, False, True,
        num_queries=6, k=6,
    )
    references, items = port_workload(seed=5, num_queries=6, k=6)
    verifier = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=lambda: True,
        resident_ref=ResidentBank([r.rank_sequence for r in references], CPU),
    )
    got = verifier.process(items)
    assert verifier._fused_dispatches > 0 and host_waves
    assert_same_alignments(want, got)


def test_host_only_verifier_matches_sequential():
    want = reference_alignments(
        7, VerificationKind.HIERARCHICAL, 0.05, False, True,
        num_queries=4, k=6,
    )
    references, items = port_workload(seed=7, num_queries=4, k=6)
    verifier = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=False,
    )
    got = verifier.process(items)
    assert verifier._fused_dispatches == 0
    assert_same_alignments(want, got)


def test_bucketed_device_batcher_runs_host_slices(monkeypatch):
    """The bucketed device batcher is ported: without resident banks a
    device-routed bucket runs as a host-slice kernel call on the
    verifier's device (the plain versions on the CPU), and the alignments
    equal the sequential verifier's. use_device=True sends every bucket to
    the device, whatever its size."""
    monkeypatch.setattr(vb, "MIN_DEVICE_CELLS", 10**12)
    want = reference_alignments(
        7, VerificationKind.HIERARCHICAL, 0.05, False, True,
        num_queries=4, k=6,
    )
    references, items = port_workload(seed=7, num_queries=4, k=6)
    verifier = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=True,
        device=CPU,
    )
    with tracing.job() as job:
        got = verifier.process(items)
    assert job.counter("verify.device_calls") > 0, (
        "no bucket ran on the device")
    assert job.counter("verify.cells_device") > 0
    assert verifier._fused_dispatches == 0
    assert_same_alignments(want, got)
