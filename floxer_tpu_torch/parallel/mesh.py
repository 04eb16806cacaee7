"""Counterpart of floxer_tpu/parallel/mesh.py: the device mesh and the
dry-run pipeline steps.

The reference lays its chips out as a jax.sharding.Mesh and runs one
jitted step over it, every per-read array sharded along the "reads"
axis, the index replicated, the statistics merged with a psum. Here a
mesh is a grid of torch devices that may repeat (the same card several
times on a one-card machine, the CPU in the tests): a step splits each
per-read array into one chunk per position of the reads axis, runs the
chunk's work on its device, and the sums are taken on the host side of
the launches. The work is the port's kernels: K9l for the locate
(index/device_index.locate_batch), K2 or K3 for the Myers distances
(the reference's XLA myers_batched is not ported; ops/cuda_myers and
ops/cuda_myers_large take its role), and a sum.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import accelerator_device, cpu_requested
from ..index.device_index import locate_batch
from ..ops.cuda_myers import myers_small
from ..ops.cuda_myers_large import myers_large
from ..ops.myers import MAX_UNROLLED_WORDS, WORD

READS_AXIS = "reads"


@dataclass(frozen=True)
class Mesh:
    """Devices on named axes: devices is an object array of torch.device,
    one dimension per axis name."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def along(self, axis: str) -> list[torch.device]:
        """The devices along one axis (at the first position of the
        others)."""
        at = [0] * self.devices.ndim
        at[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(at)])


def default_devices() -> list[torch.device]:
    """The accelerator, or the CPU when FLOXER_TPU_PLATFORM=cpu asks for
    it (raises when neither)."""
    return [torch.device("cpu") if cpu_requested() else accelerator_device()]


def device_grid(devices, shape) -> np.ndarray:
    """An object array of torch devices of the given shape."""
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return grid.reshape(shape)


def make_mesh(devices=None, axis_name: str = READS_AXIS) -> Mesh:
    if devices is None:
        devices = default_devices()
    return Mesh(device_grid(devices, (len(devices),)), (axis_name,))


def on_device(value, device: torch.device):
    """A tensor, or a dataclass of tensors (a device index), on `device`
    (the same objects where they are there already)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.replace(value, **{
            field.name: on_device(getattr(value, field.name), device)
            for field in dataclasses.fields(value) if field.init
        })
    return value


def reads_chunks(mesh: Mesh, batch: int):
    """(device, slice of the batch) for each position of the reads axis:
    the batch split evenly, as the reference shards it (the batch must
    divide)."""
    devices = mesh.along(READS_AXIS)
    if batch % len(devices):
        raise ValueError(f"a batch of {batch} does not split over "
                         f"{len(devices)} devices of the reads axis")
    size = batch // len(devices)
    return [(device, slice(r * size, (r + 1) * size))
            for r, device in enumerate(devices)]


def myers_distances(peq, pattern_lengths, windows, window_lengths,
                    num_words: int):
    """(distance, end_col) int32 [B] of each pattern (peq int32 [B, SIGMA,
    W], uint32 bits) in its window (uint8 [B, N]): K2 up to
    MAX_UNROLLED_WORDS words, else K3 with the words padded to a multiple
    of 32 (their plain versions on the CPU)."""
    plen = pattern_lengths.to(torch.int32).contiguous()
    wlen = window_lengths.to(torch.int32).contiguous()
    texts = windows.to(torch.int32)
    if num_words <= MAX_UNROLLED_WORDS:
        return myers_small(peq.permute(2, 1, 0).contiguous(), plen,
                           texts.t().contiguous(), wlen)
    padded = -(-num_words // WORD) * WORD
    peq = torch.nn.functional.pad(peq, (0, padded - peq.shape[2]))
    return myers_large(peq.contiguous(), plen, texts.contiguous(), wlen)


def pipeline_step(index, seed_patterns_peq, pattern_lengths, windows,
                  window_lengths, error_budgets, probe_rows, num_words: int):
    """One device step over a batch, as the reference's pipeline_step:
    locate the anchors' SA rows, score every (pattern, window) pair with
    Myers, and count the accepted ones. peq int32 [B, SIGMA, W] (uint32
    bits), windows uint8 [B, N], the rest int32 [B]; returns the
    reference's dict (seq_ids, positions, distances, end_cols, accepted
    bool, num_accepted a 0-d int32 tensor)."""
    seq_ids, positions = locate_batch(index, probe_rows,
                                      sampling_rate=index.sampling_rate)
    distances, end_cols = myers_distances(
        seed_patterns_peq, pattern_lengths, windows, window_lengths,
        num_words,
    )
    accepted = distances <= error_budgets
    return {
        "seq_ids": seq_ids,
        "positions": positions,
        "distances": distances,
        "end_cols": end_cols,
        "accepted": accepted,
        "num_accepted": accepted.to(torch.int32).sum().to(torch.int32),
    }


def sharded_pipeline_step(mesh: Mesh, num_words: int):
    """pipeline_step over the mesh's reads axis: each per-read array split
    into one chunk per device of the axis, the index on every one of
    them, the chunks' outputs joined on the axis's first device and the
    accepted counts summed."""

    def step(index, *batch):
        chunks = reads_chunks(mesh, batch[0].shape[0])
        first = chunks[0][0]
        outs = [
            pipeline_step(on_device(index, device),
                          *(on_device(a[part], device) for a in batch),
                          num_words=num_words)
            for device, part in chunks
        ]
        joined = {key: torch.cat([out[key].to(first) for out in outs])
                  for key in outs[0] if key != "num_accepted"}
        joined["num_accepted"] = sum(
            out["num_accepted"].to(first) for out in outs)
        return joined

    return step


def psum_statistics(mesh: Mesh, per_chip_counts) -> torch.Tensor:
    """The counts' sum over the reads axis (the reference's global-stats
    merge as a collective): int64 [1] on the axis's first device."""
    chunks = reads_chunks(mesh, per_chip_counts.shape[0])
    first = chunks[0][0]
    total = sum(per_chip_counts[part].to(device).to(torch.int64).sum()
                .to(first) for device, part in chunks)
    return total.reshape(1)
