"""Entry points of the port: the one-device step check and the
multi-device dry run (the counterparts of the repository root's
__graft_entry__.py, which stays the JAX package's).

entry() returns the flagship device step (parallel/mesh.pipeline_step:
the batched FM-index locate on K9l, Myers verification on K2 and the
acceptance count) with example arguments on a device.

dryrun_multichip(n) runs ONE step over an n-device mesh (the devices may
repeat: n times the card on a one-card machine, n times the CPU in the
tests), every per-read array split along the "reads" axis and the index
on every device, then the cross-device statistics sum; for an even n also
the 2-D (reads x index) step with the sharded rank (K13), the search and
locate over an n-shard index (K11 over the shards, K13l), and the CLI
with --index-shards n, whose SAM must equal the unsharded run's.

The entry points run on the card unless the caller passes a device (the
tests pass the CPU, which runs the kernels' plain versions) or sets
FLOXER_TPU_PLATFORM=cpu.
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.mesh import default_devices


def _device(device) -> torch.device:
    return default_devices()[0] if device is None else torch.device(device)


def _build_example(batch: int = 16, pattern_len: int = 24,
                   window_len: int = 128, device=None):
    """The reference's example, drawn from the same seed: a 768-char
    two-record index, planted exact matches and random SA rows."""
    from .index.device_index import DeviceIndex
    from .index.fmindex import FmIndex
    from .ops.myers import build_peq_vectorized, u32_tensor

    device = _device(device)
    rng = np.random.default_rng(0)
    sequences = [
        rng.integers(1, 5, size=512).astype(np.uint8),
        rng.integers(1, 5, size=256).astype(np.uint8),
    ]
    host_index = FmIndex(sequences)
    device_index = DeviceIndex.from_host(host_index, device)

    patterns = np.zeros((batch, pattern_len), dtype=np.uint8)
    pattern_lengths = np.full(batch, pattern_len, dtype=np.int32)
    windows = np.zeros((batch, window_len), dtype=np.uint8)
    window_lengths = np.full(batch, window_len, dtype=np.int32)
    for b in range(batch):
        start = int(rng.integers(0, 512 - window_len))
        window = sequences[0][start : start + window_len]
        windows[b, : len(window)] = window
        offset = int(rng.integers(0, window_len - pattern_len))
        patterns[b] = window[offset : offset + pattern_len]

    peq = build_peq_vectorized(patterns, pattern_lengths)
    budgets = np.full(batch, 2, dtype=np.int32)
    probe_rows = rng.integers(0, host_index.n, size=batch).astype(np.int32)

    args = (
        device_index,
        u32_tensor(peq, device),
        torch.from_numpy(pattern_lengths).to(device),
        torch.from_numpy(windows).to(device),
        torch.from_numpy(window_lengths).to(device),
        torch.from_numpy(budgets).to(device),
        torch.from_numpy(probe_rows).to(device),
    )
    return args, peq.shape[2]


def entry(device=None):
    """(fn, example_args) for the one-device step check."""
    from functools import partial

    from .parallel.mesh import pipeline_step

    args, num_words = _build_example(device=device)
    return partial(pipeline_step, num_words=num_words), args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run ONE sharded pipeline step on an n_devices mesh of `device`
    repeated, then the statistics sum; for an even n the 2-D, sharded
    search and sharded CLI checks."""
    from .parallel.mesh import (
        make_mesh,
        psum_statistics,
        sharded_pipeline_step,
    )

    device = _device(device)
    mesh = make_mesh([device] * n_devices)

    batch = max(16, 2 * n_devices)
    batch = -(-batch // n_devices) * n_devices  # divisible by the mesh axis
    args, num_words = _build_example(batch=batch, device=device)

    step = sharded_pipeline_step(mesh, num_words)
    out = step(*args)
    accepted = out["accepted"]
    assert bool(accepted.all()), (
        "planted exact matches must verify on every shard"
    )

    total = psum_statistics(mesh, accepted.to(torch.int32))
    assert int(total[0]) == batch, (total, batch)
    print(
        f"dryrun_multichip: {n_devices} devices, batch {batch}, "
        f"accepted {int(total[0])} — OK"
    )

    if n_devices % 2 == 0:
        _dryrun_2d(n_devices, batch, device)


def _dryrun_2d(n_devices: int, batch: int, device: torch.device) -> None:
    """2-D (reads x index) mesh: the sharded-index rank (K13) beside
    reads-split verification — the hg38 sharding layout."""
    from .index.device_index import DeviceIndex, rank_all
    from .index.fmindex import FmIndex
    from .ops.myers import build_peq_vectorized, u32_tensor
    from .parallel.sharded_index import (
        make_2d_mesh,
        make_2d_pipeline_step,
        shard_single_index,
        upload_shards,
    )

    index_axis = 2
    mesh = make_2d_mesh([device] * n_devices, index_axis_size=index_axis)
    reads_axis_size = n_devices // index_axis
    batch = -(-batch // reads_axis_size) * reads_axis_size

    rng = np.random.default_rng(1)
    sequences = [rng.integers(1, 5, size=1024).astype(np.uint8)]
    host_index = FmIndex(sequences)
    sharded = shard_single_index(host_index.fwd.bwt, index_axis)

    pattern_len, window_len = 24, 128
    patterns = np.zeros((batch, pattern_len), dtype=np.uint8)
    windows = np.zeros((batch, window_len), dtype=np.uint8)
    for b in range(batch):
        start = int(rng.integers(0, 1024 - window_len))
        window = sequences[0][start : start + window_len]
        windows[b] = window
        offset = int(rng.integers(0, window_len - pattern_len))
        patterns[b] = window[offset : offset + pattern_len]
    peq = build_peq_vectorized(patterns, np.full(batch, pattern_len))
    positions = rng.integers(0, host_index.n + 1, size=batch).astype(np.int32)

    def on(array):
        return torch.from_numpy(array).to(device)

    step = make_2d_pipeline_step(mesh, num_words=peq.shape[2])
    ranks, accepted, num_accepted = step(
        upload_shards(sharded, device),
        on(positions),
        u32_tensor(peq, device),
        on(np.full(batch, pattern_len, dtype=np.int32)),
        on(windows),
        on(np.full(batch, window_len, dtype=np.int32)),
        on(np.zeros(batch, dtype=np.int32)),
    )

    # every rank equals the unsharded index's (K9 on the card), and a
    # sample of them the host index's
    flat = rank_all(DeviceIndex.from_host(host_index, device).fwd,
                    on(positions))
    assert torch.equal(ranks, flat), "sharded ranks differ from K9's"
    ranks = ranks.cpu().numpy()
    for i in range(0, batch, max(1, batch // 8)):
        want = host_index.fwd.occ_all(int(positions[i]))
        assert np.array_equal(ranks[i], want), f"rank mismatch at {i}"
    assert int(num_accepted[0]) == batch
    print(
        f"dryrun_multichip 2D: mesh {reads_axis_size}x{index_axis} "
        f"(reads x index), sharded rank + verify — OK"
    )

    _dryrun_sharded_search(n_devices, device)


def _dryrun_sharded_search(n_devices: int, device: torch.device) -> None:
    """Full sharded-index SEARCH + LOCATE: the frontier seed search and
    the batched SA locate with BWT rows, rank tables and SA samples
    row-sharded n ways (the hg38 configuration)."""
    from .index.device_index import DeviceIndex, locate_batch
    from .index.fmindex import FmIndex
    from .parallel.sharded_index import (
        make_index_mesh,
        shard_full_index,
        sharded_frontier_search,
        sharded_locate,
    )
    from .schemes import expand_scheme
    from .search_device import SchemeTables

    rng = np.random.default_rng(7)
    sequences = [rng.integers(1, 5, size=800).astype(np.uint8)]
    host = FmIndex(sequences)
    mesh = make_index_mesh([device] * n_devices)
    sh = shard_full_index(host, n_devices)

    seed_len, errors = 12, 1
    padded = np.zeros((8, seed_len), dtype=np.int32)
    for i in range(4):
        start = int(rng.integers(0, 800 - seed_len))
        padded[i] = sequences[0][start : start + seed_len]
    tables = SchemeTables.from_searches(expand_scheme(errors, seed_len))
    seed_class = np.full(8, tables.dead_class, dtype=np.int32)
    seed_class[:4] = 0
    max_iter = seed_len + errors + 2 * tables.num_parts + 2
    _, num_reports, _ = sharded_frontier_search(
        mesh, sh, padded, seed_class, tables, 1 << 12, 1 << 10, max_iter
    )
    assert int(num_reports) > 0

    rows = rng.integers(0, host.n, size=16).astype(np.int32)
    got_ids, got_pos = sharded_locate(mesh, sh, rows)
    want_ids, want_pos = locate_batch(
        DeviceIndex.from_host(host, device),
        torch.from_numpy(rows).to(device), sampling_rate=host.sampling_rate,
    )
    assert torch.equal(got_ids, want_ids)
    assert torch.equal(got_pos, want_pos)
    print(
        f"dryrun_multichip sharded search: {n_devices}-shard index, "
        f"{int(num_reports)} reports, locate parity — OK"
    )

    _dryrun_sharded_cli(n_devices, device)


def _dryrun_sharded_cli(n_devices: int, device: torch.device) -> None:
    """The whole sharded pipeline through the CLI on tests/data: a run
    with --index-shards n writes the unsharded run's SAM (both in this
    process, on `device`)."""
    import tempfile
    from pathlib import Path

    from . import pipeline
    from .cli import parse_and_validate

    data = Path(__file__).resolve().parent.parent / "tests" / "data"
    if not (data / "reference.fasta").exists():
        # the reference prints SKIPPED here; the port fails, so that a
        # dry run that passes has run the sharded CLI
        raise FileNotFoundError(
            f"dryrun_multichip sharded CLI: no test data at {data}")

    with tempfile.TemporaryDirectory() as tmp:
        def run(out_name, extra):
            out = Path(tmp) / out_name
            cli = parse_and_validate([
                "--reference", str(data / "reference.fasta"),
                "--queries", str(data / "queries.fastq"),
                "--output", str(out),
                "--query-errors", "2",
                "--seed-errors", "1",
                "--extra-verification-ratio", "2",
                "--interval-optimization",
                *extra,
            ])
            assert pipeline.run(cli, device=device) == 0
            return out.read_text()

        sharded = run("sharded.sam", ["--index-shards", str(n_devices)])
        unsharded = run("unsharded.sam", [])
        assert sharded == unsharded, "sharded CLI SAM differs from unsharded"
    print(
        f"dryrun_multichip sharded CLI: --index-shards {n_devices} "
        f"byte-identical SAM — OK"
    )


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry step:", {k: tuple(v.shape) for k, v in out.items()})
    dryrun_multichip(torch.cuda.device_count() or 1)
