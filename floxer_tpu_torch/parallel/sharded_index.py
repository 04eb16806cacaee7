# Copied from floxer_tpu/parallel/sharded_index.py (its host-side shard layout functions); the device programs are the port's own.
"""Sharded FM-index: BWT rows distributed across an "index" axis of
devices.

The hg38-scale configuration: one device cannot hold the whole
occurrence table, so the BWT (fwd and rev) is sharded row-wise and a
global rank query becomes

    occ(c, pos) = sum over shards s of local_occ_s(c, clamp(pos - start_s))

Layout per index shard (built host-side by shard_single_index, as the
reference builds it):
  - bwt_shard: uint8 [shard_len]         padded to the max shard length
  - occ_shard: int32 [nb_shard, SIGMA]   LOCAL cumulative counts
  - shard_start: int32 []                first global row of the shard

In the reference each shard lives on a device of a jax mesh's "index"
axis, and a psum over that axis adds the partial counts. In the port the
axis is a list of torch devices that may repeat (the same card S times on
a one-card machine, the CPU in the tests), and the shards all lie on its
one device as stacked tables (index/device_index.ShardedDeviceIndex): a
kernel thread ranks in the shard that owns its position and adds the
totals of the shards before it (K13, K13l, and K11 over the shards:
csrc/fm_sharded.cu, csrc/frontier_search.cu), which is the psum's sum. The reads axis of the 2-D mesh splits
the per-read arrays into chunks, one per device of the axis, as
parallel/mesh.py does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..alphabet import SIGMA
from ..index.device_index import (
    ShardedDeviceIndex,
    locate_batch,
    shard_before,
    shard_rank_rows,
)
from ..index.fmindex import OCC_BLOCK
from ..ops.cuda_sharded import fm_sharded_rank
from .mesh import (
    READS_AXIS,
    Mesh,
    default_devices,
    device_grid,
    myers_distances,
    reads_chunks,
)

INDEX_AXIS = "index"


@dataclass
class HostShardedSingle:
    """Host-side row-sharded single-direction index, ready to device_put."""

    bwt_shards: np.ndarray  # uint8 [S, max_shard_len]
    occ_shards: np.ndarray  # int64 [S, nb+1, SIGMA] local cumulative
    shard_starts: np.ndarray  # int64 [S]
    shard_lengths: np.ndarray  # int64 [S]


def shard_single_index(bwt: np.ndarray, num_shards: int) -> HostShardedSingle:
    n = bwt.shape[0]
    base = -(-n // num_shards)
    base = -(-base // OCC_BLOCK) * OCC_BLOCK  # align shards to occ blocks
    starts = np.minimum(np.arange(num_shards) * base, n)
    lengths = np.minimum(starts + base, n) - starts
    max_len = int(base)
    nb = max_len // OCC_BLOCK + 1

    bwt_shards = np.zeros((num_shards, max_len), dtype=np.uint8)
    occ_shards = np.zeros((num_shards, nb + 1, SIGMA), dtype=np.int64)
    for s in range(num_shards):
        chunk = bwt[starts[s] : starts[s] + lengths[s]]
        bwt_shards[s, : len(chunk)] = chunk
        per_block = np.zeros((nb, SIGMA), dtype=np.int64)
        block_idx = np.arange(len(chunk)) // OCC_BLOCK
        np.add.at(per_block, (block_idx, chunk.astype(np.int64)), 1)
        np.cumsum(per_block, axis=0, out=occ_shards[s, 1:])
    return HostShardedSingle(
        bwt_shards,
        occ_shards,
        starts.astype(np.int64),
        lengths.astype(np.int64),
    )


@dataclass
class ShardedHostIndex:
    """Host-side stacked shard arrays of a full bidirectional index, ready
    to device_put along INDEX_AXIS."""

    fwd: HostShardedSingle
    rev: HostShardedSingle
    C: np.ndarray
    sampled_rows: np.ndarray  # int64 [S, ns_per_shard] pad 1<<30
    sampled_values: np.ndarray  # int64 [S, ns_per_shard]
    seq_starts: np.ndarray
    sampling_rate: int
    global_n: int


def shard_full_index(host_index, num_shards: int) -> ShardedHostIndex:
    """Row-shards both directions of a host FmIndex plus its SA samples."""
    fwd = shard_single_index(host_index.fwd.bwt, num_shards)
    rev = shard_single_index(host_index.rev.bwt, num_shards)
    rows = np.asarray(host_index.sampled_rows, dtype=np.int64)
    vals = np.asarray(host_index.sampled_values, dtype=np.int64)
    per = max(1, -(-len(rows) // num_shards))
    srows = np.full((num_shards, per), np.int64(1) << 30, dtype=np.int64)
    svals = np.zeros((num_shards, per), dtype=np.int64)
    for s in range(num_shards):
        chunk = slice(s * per, min((s + 1) * per, len(rows)))
        size = max(0, chunk.stop - chunk.start)
        if size > 0:
            srows[s, :size] = rows[chunk]
            svals[s, :size] = vals[chunk]
    return ShardedHostIndex(
        fwd=fwd,
        rev=rev,
        C=np.asarray(host_index.C, dtype=np.int64),
        sampled_rows=srows,
        sampled_values=svals,
        seq_starts=np.asarray(host_index.seq_starts, dtype=np.int64),
        sampling_rate=host_index.sampling_rate,
        global_n=int(host_index.n),
    )


# ---------------------------------------------------------------------------
# The device side: the shards of the index axis on its one device


def index_device(mesh: Mesh) -> torch.device:
    """The one device the index axis's shards lie on (its devices may
    repeat; one launch sums the shards, so they must be one device)."""
    devices = set(mesh.along(INDEX_AXIS))
    if len(devices) != 1:
        raise ValueError(
            f"the index axis's shards are summed in one launch, so its "
            f"devices must be one device, not {sorted(map(str, devices))}"
        )
    return devices.pop()


def device_index(mesh: Mesh, sh) -> ShardedDeviceIndex:
    """A ShardedHostIndex uploaded to the index axis's device (a
    ShardedDeviceIndex already there is taken as it is)."""
    device = index_device(mesh)
    if isinstance(sh, ShardedDeviceIndex):
        if sh.device != device:
            raise ValueError(f"the sharded index is on {sh.device}, the "
                             f"mesh's index axis on {device}")
        return sh
    return ShardedDeviceIndex.from_shards(sh, device)


def upload_shards(sharded: HostShardedSingle, device: torch.device):
    """One direction's shard tables on `device`: (rank rows int32 [S, nb,
    32], starts, lengths int32 [S], each symbol's total over the shards
    before each int32 [S, SIGMA]), the operands of K13."""
    rows = shard_rank_rows(sharded)
    return (
        torch.from_numpy(rows.view(np.int32)).to(device),
        torch.from_numpy(sharded.shard_starts.astype(np.int32)).to(device),
        torch.from_numpy(sharded.shard_lengths.astype(np.int32)).to(device),
        torch.from_numpy(shard_before(sharded).astype(np.int32)).to(device),
    )


def sharded_rank(mesh: Mesh, tables, positions: torch.Tensor):
    """K13 of each reads-axis chunk of the positions on its device (the
    tables there), joined on the axis's first device: int32 [B, SIGMA]."""
    chunks = reads_chunks(mesh, positions.shape[0])
    first = chunks[0][0]
    parts = []
    for device, part in chunks:
        rows, starts, lengths, before = (t.to(device) for t in tables)
        chunk = positions[part].to(device, torch.int32).contiguous()
        parts.append(fm_sharded_rank(chunk, rows, 0, starts, lengths,
                                     before).to(first))
    return torch.cat(parts)


def sharded_rank_all(mesh: Mesh, sharded: HostShardedSingle, positions):
    """Upload one direction's shards to the index axis's device and rank
    the positions (numpy or tensor, [B]) over them: int32 [B, SIGMA]."""
    device = index_device(mesh)
    positions = torch.as_tensor(np.asarray(positions, dtype=np.int32))
    return sharded_rank(mesh, upload_shards(sharded, device), positions)


def make_2d_pipeline_step(mesh: Mesh, num_words: int):
    """The 2-D dry-run step: the rank of the search stage over the
    row-sharded index (K13) beside reads-split Myers verification (K2 or
    K3) and the accepted count summed. Where the reference's step takes
    the shards' BWT and occ, this one takes their rank tables
    (upload_shards): step(tables, positions, peq, plen, windows, wlen,
    budgets) -> (ranks int32 [B, SIGMA], accepted int32 [B], num_accepted
    int64 [1])."""

    def step(tables, positions, peq, plen, windows, wlen, budgets):
        ranks = sharded_rank(mesh, tables, positions)
        chunks = reads_chunks(mesh, positions.shape[0])
        first = chunks[0][0]
        accepted = []
        for device, part in chunks:
            distances, _ = myers_distances(
                *(a[part].to(device) for a in (peq, plen, windows, wlen)),
                num_words=num_words,
            )
            accepted.append(
                (distances <= budgets[part].to(device)).to(torch.int32)
                .to(first))
        accepted = torch.cat(accepted)
        return ranks, accepted, accepted.to(torch.int64).sum().reshape(1)

    return step


def make_2d_mesh(devices=None, index_axis_size: int = 2) -> Mesh:
    if devices is None:
        devices = default_devices() * index_axis_size
    assert len(devices) % index_axis_size == 0
    grid = device_grid(devices, (len(devices) // index_axis_size,
                                 index_axis_size))
    return Mesh(grid, (READS_AXIS, INDEX_AXIS))


def make_index_mesh(devices) -> Mesh:
    """A 1-D mesh of the index axis."""
    return Mesh(device_grid(devices, (len(devices),)), (INDEX_AXIS,))


def sharded_locate(mesh: Mesh, sh, rows):
    """Batched locate against the sharded index (K13l): SA rows ->
    (reference_id, position), int32 tensors on the index axis's device.
    Bit-identical to the unsharded DeviceIndex locate."""
    index = device_index(mesh, sh)
    rows = torch.as_tensor(np.asarray(rows, dtype=np.int32)).to(index.device)
    return locate_batch(index, rows, sampling_rate=index.sampling_rate)


def sharded_frontier_search(
    mesh: Mesh,
    sh,
    padded_patterns: np.ndarray,
    seed_class: np.ndarray,
    tables,
    frontier_capacity: int,
    report_capacity: int,
    max_iterations: int,
):
    """The device frontier seed search with the index row-sharded across
    INDEX_AXIS, in one launch of K11 over the shard tables (its plain
    version on the CPU). Returns the same (reports int32 [R, 5],
    num_reports, overflow bool [S]) as the unsharded one, downloaded to
    numpy."""
    from ..search_device import block_search

    out = block_search(
        device_index(mesh, sh), padded_patterns[None], seed_class[None],
        tables, frontier_capacity, report_capacity, max_iterations,
    )
    return (out.reports[0].cpu().numpy(), int(out.num_reports[0]),
            out.overflow[0].cpu().numpy())

