"""The port's mesh dry run (floxer_tpu_torch.graft_entry, parallel/mesh.py
and the 2-D step of parallel/sharded_index.py) on the CPU, after
tests/test_multichip.py: the entry step, the dry run over 8 and 2
devices (the CPU repeated, as the card is on a one-card machine), and the
steps' outputs equal to the reference's pipeline_step and
make_2d_pipeline_step on its 8 virtual CPU devices (exact: locate rows,
distances, end columns, ranks, acceptance and counts)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from floxer_tpu.index.fmindex import FmIndex as RefFmIndex
from floxer_tpu.ops.myers import build_peq_vectorized as ref_peq
from floxer_tpu.parallel import sharded_index as ref_si
from floxer_tpu_torch import graft_entry
from floxer_tpu_torch.index.fmindex import FmIndex
from floxer_tpu_torch.ops.myers import build_peq_vectorized, u32_tensor
from floxer_tpu_torch.parallel import mesh as port_mesh
from floxer_tpu_torch.parallel import sharded_index as port_si

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def reference_entry():
    sys.path.insert(0, str(ROOT))
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    return {k: np.asarray(v) for k, v in jax.jit(fn)(*args).items()}


def test_entry_compiles_and_runs(reference_entry):
    """entry()'s step accepts every planted match and gives the
    reference's outputs on the same example."""
    fn, args = graft_entry.entry(CPU)
    out = fn(*args)
    assert bool(out["accepted"].all())
    assert sorted(out) == sorted(reference_entry)
    for key, want in reference_entry.items():
        assert np.array_equal(out[key].numpy(), want), key


@pytest.mark.parametrize("n_devices", [8, 2])
def test_dryrun_multichip(n_devices, capsys):
    """dryrun_multichip(n): the reads-split step, the statistics sum, and
    for an even n the 2-D step, the sharded search and locate and the
    sharded CLI all accept."""
    graft_entry.dryrun_multichip(n_devices, CPU)
    out = capsys.readouterr().out
    assert f"dryrun_multichip: {n_devices} devices" in out
    assert "2D: mesh" in out
    assert (f"sharded CLI: --index-shards {n_devices} byte-identical SAM — OK"
            in out)


def test_sharded_pipeline_step_equals_the_one_device_step():
    """The reads-split step over 4 devices gives the one-device step's
    outputs, and psum_statistics the sum of the counts."""
    fn, args = graft_entry.entry(CPU)
    whole = fn(*args)
    mesh = port_mesh.make_mesh([CPU] * 4)
    split = port_mesh.sharded_pipeline_step(mesh, fn.keywords["num_words"])(
        *args)
    for key in whole:
        assert torch.equal(split[key], whole[key]), key
    counts = torch.arange(16, dtype=torch.int32)
    assert port_mesh.psum_statistics(mesh, counts).tolist() == [120]


@pytest.mark.parametrize("pattern_len", [24, 300])
def test_2d_step_matches_reference(pattern_len):
    """make_2d_pipeline_step over a 4 x 2 (reads x index) mesh equals the
    reference's on its 8 devices: the sharded ranks, the acceptance and
    its sum, with patterns on K2 (24 chars) and on K3 (300 chars)."""
    rng = np.random.default_rng(12)
    sequences = [rng.integers(1, 5, size=2000).astype(np.uint8)]
    batch, window_len = 16, pattern_len + 104
    patterns = np.zeros((batch, pattern_len), dtype=np.uint8)
    windows = np.zeros((batch, window_len), dtype=np.uint8)
    for b in range(batch):
        start = int(rng.integers(0, 2000 - window_len))
        windows[b] = sequences[0][start:start + window_len]
        offset = int(rng.integers(0, window_len - pattern_len))
        patterns[b] = windows[b, offset:offset + pattern_len]
        for pos in rng.integers(0, pattern_len, size=b % 4):
            patterns[b, pos] = 1 + patterns[b, pos] % 4
    plen = np.full(batch, pattern_len, dtype=np.int32)
    wlen = np.full(batch, window_len, dtype=np.int32)
    budgets = np.full(batch, 1, dtype=np.int32)
    positions = rng.integers(0, 2001, size=batch).astype(np.int32)

    from jax.sharding import NamedSharding, PartitionSpec as P

    ref_mesh = ref_si.make_2d_mesh(jax.devices()[:8], index_axis_size=2)
    ref_sharded = ref_si.shard_single_index(RefFmIndex(sequences).fwd.bwt, 2)
    peq = ref_peq(patterns, plen)

    def put(array, spec):
        return jax.device_put(array, NamedSharding(ref_mesh, spec))

    index_axis, reads_axis = ref_si.INDEX_AXIS, ref_si.READS_AXIS
    want = ref_si.make_2d_pipeline_step(ref_mesh, peq.shape[2])(
        put(ref_sharded.bwt_shards, P(index_axis, None)),
        put(ref_sharded.occ_shards, P(index_axis, None, None)),
        put(ref_sharded.shard_starts, P(index_axis)),
        put(ref_sharded.shard_lengths, P(index_axis)),
        put(positions, P(reads_axis)),
        put(peq, P(reads_axis, None, None)),
        put(plen, P(reads_axis)),
        put(windows, P(reads_axis, None)),
        put(wlen, P(reads_axis)),
        put(budgets, P(reads_axis)),
    )

    mesh = port_si.make_2d_mesh([CPU] * 8, index_axis_size=2)
    sharded = port_si.shard_single_index(FmIndex(sequences).fwd.bwt, 2)
    got = port_si.make_2d_pipeline_step(mesh, peq.shape[2])(
        port_si.upload_shards(sharded, CPU), torch.from_numpy(positions),
        u32_tensor(build_peq_vectorized(patterns, plen), CPU),
        *(torch.from_numpy(a) for a in (plen, windows, wlen, budgets)),
    )
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2][0]) == int(np.asarray(want[2])[0])
    assert 0 < int(got[2][0]) < batch
