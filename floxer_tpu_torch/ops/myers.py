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


def full_myers_operands(
    rng: np.random.Generator,
    count: int,
    words: int,
    small: bool,
    device: torch.device,
    max_chars: int | None = None,
    spread: bool = False,
    max_columns: int | None = None,
):
    """Seeded operands of K2 (small=True: peq [W, 6, B], texts [N, B]) or
    K3 (peq [B, 6, Wp], texts [B, N]) at `words` pattern words, for the
    card tests and chip_smoke.py: (peq, plen, texts, tlen) on `device`.
    Pattern lengths cycle over every word (K2) or every group of 32 words
    (K3) up to max_chars (32 * words by default), so one launch holds tasks
    of every size the width takes (with spread=True the sizes spread evenly
    from the smallest to the largest over the tasks, so fewer tasks than
    sizes still reach the largest); each text holds a mutated copy of its
    pattern, with chars 6..15 at every 7th column (garbage past a fused
    window), cut to its first max_columns chars when given (a wide
    pattern's every group then runs on a short text); task 0 has m == 0,
    tasks 1 and 2 tlen 0 and 1."""
    top = min(max_chars or WORD * words, WORD * words)
    step = WORD if small else WORD * WORD
    spans = [(lo, min(lo + step, top + 1)) for lo in range(1, top + 1, step)]
    patterns, texts = [], []
    for i in range(count):
        at = (i * (len(spans) - 1) // max(count - 1, 1) if spread
              else i % len(spans))
        lo, hi = spans[at]
        m = int(rng.integers(lo, hi))
        n = int(rng.integers(m, m + 2 * (m // 10) + 60))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, max(1, n - m)))
        pattern = text[start : start + m].copy()
        for pos in rng.integers(0, m, size=int(rng.integers(0, m // 12 + 2))):
            pattern[pos] = 1 + (pattern[pos] % 4)
        text[::7] = rng.integers(6, 16, size=len(text[::7]))
        if max_columns is not None:
            text = text[:max_columns]
        patterns.append(pattern)
        texts.append(text)
    plen = np.asarray([len(p) for p in patterns], dtype=np.int32)
    tlen = np.asarray([len(t) for t in texts], dtype=np.int32)
    pat = np.zeros((count, max(plen.max(), 1)), dtype=np.uint8)
    txt = np.zeros((count, max(tlen.max(), 1)), dtype=np.int32)
    for i, (p, t) in enumerate(zip(patterns, texts)):
        pat[i, : len(p)] = p
        txt[i, : len(t)] = t
    plen[0] = 0
    tlen[1], tlen[2] = 0, 1
    peq = np.zeros((count, SIGMA, words), dtype=np.uint32)
    built = build_peq_vectorized(pat, plen)
    peq[:, :, : built.shape[2]] = built[:, :, :words]
    if small:
        peq, txt = np.transpose(peq, (2, 1, 0)), txt.T
    return (
        u32_tensor(peq, device),
        torch.from_numpy(plen).to(device),
        torch.from_numpy(np.ascontiguousarray(txt)).to(device),
        torch.from_numpy(tlen).to(device),
    )
