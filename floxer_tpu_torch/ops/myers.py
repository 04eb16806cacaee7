"""Host Peq packing and the full-Myers dispatch.

Counterpart of floxer_tpu/ops/myers.py (host parts): `myers_distance`
sends patterns of more than MAX_UNROLLED_WORDS words to the large-pattern
kernel (K3, ops/cuda_myers_large.py) and every other batch to the small
kernel (K2, ops/cuda_myers.py), as the reference's TPU dispatch does. The
XLA `myers_batched` / `myers_batched_large` are not ported: the plain
PyTorch versions beside each kernel take their role as the CPU oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabet import SIGMA

WORD = 32
# patterns up to this many words use the register kernel (K2); beyond it
# the warp-per-task kernel (K3)
MAX_UNROLLED_WORDS = 8


def build_peq_vectorized(
    patterns: np.ndarray, pattern_lengths: np.ndarray
) -> np.ndarray:
    """Host Peq table [B, SIGMA, W] uint32: bit i of word w of Peq[b, s] is
    set iff patterns[b, w*32+i] == s and w*32+i < pattern_lengths[b].
    Copied from floxer_tpu/ops/myers.py:build_peq_vectorized."""
    B, M = patterns.shape
    W = -(-M // WORD)
    padded = np.zeros((B, W * WORD), dtype=np.int64)
    padded[:, :M] = patterns
    idx = np.arange(W * WORD)
    valid = idx[None, :] < pattern_lengths[:, None]  # [B, W*32]
    bits = (np.uint32(1) << (idx % WORD).astype(np.uint32))[None, :]
    peq = np.zeros((B, SIGMA, W), dtype=np.uint32)
    for s in range(SIGMA):
        mask = (padded == s) & valid
        contrib = np.where(mask, bits, 0).astype(np.uint64)
        # sum bits per word (they are disjoint, so add == or)
        peq[:, s, :] = np.add.reduceat(
            contrib, np.arange(0, W * WORD, WORD), axis=1
        ).astype(np.uint32)
    return peq


MASK32 = 0xFFFFFFFF


def u32_tensor(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bits (torch has
    no usable uint32 arithmetic; the kernels read the words as uint32)."""
    return torch.from_numpy(
        np.ascontiguousarray(array, dtype=np.uint32).view(np.int32)
    ).to(device)


def widen(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding the unsigned 32-bit value, so shifts
    are logical and adds do not wrap (the plain versions compute on these,
    masking with MASK32 where a 32-bit result is needed)."""
    return words.to(torch.int64) & MASK32


def narrow(values: torch.Tensor) -> torch.Tensor:
    """int64 holding unsigned 32-bit values -> int32 with the same bits."""
    values = values & MASK32
    return torch.where(values >= 1 << 31, values - (1 << 32), values).to(
        torch.int32
    )


def pad_batch(
    sequences: list[np.ndarray], pad_to: int | None = None, multiple: int = 128
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side ragged->padded packing: [B, L] uint8 + lengths [B], L a
    multiple of `multiple`. Copied from
    floxer_tpu/ops/device_dp.py:pad_batch."""
    lengths = np.array([len(s) for s in sequences], dtype=np.int32)
    longest = int(lengths.max()) if len(sequences) else 1
    target = pad_to if pad_to is not None else longest
    target = max(target, 1)
    target = -(-target // multiple) * multiple
    out = np.zeros((len(sequences), target), dtype=np.uint8)
    for i, s in enumerate(sequences):
        out[i, : len(s)] = s
    return out, lengths


def myers_distance(
    patterns: np.ndarray,
    pattern_lengths: np.ndarray,
    texts: np.ndarray,
    text_lengths: np.ndarray,
    device: torch.device,
    sync: bool = True,
):
    """(distance, end_col) per row with dp_reference semantics: rightmost
    minimal end among columns 0..text_len-1. Patterns of more than
    MAX_UNROLLED_WORDS words go to K3, all others to K2.

    With sync=False the results stay on `device` as int32 tensors, so a
    caller submitting several batches downloads them after the last."""
    max_len = int(np.max(pattern_lengths)) if len(pattern_lengths) else 0
    if max_len > MAX_UNROLLED_WORDS * WORD:
        from .cuda_myers_large import myers_large_host

        return myers_large_host(
            patterns, pattern_lengths, texts, text_lengths, device, sync
        )
    from .cuda_myers import myers_small_host

    return myers_small_host(
        patterns, pattern_lengths, texts, text_lengths, device, sync
    )
