"""K2: full Myers for patterns of at most 8 words (256 chars).

Counterpart of floxer_tpu/ops/pallas_myers.py. `myers_small` launches the
hand-written CUDA kernel (csrc/myers_small.cu, `myers_small_cuda`) for
CUDA tensors and runs `myers_small_plain` for CPU tensors. Operands keep
the Pallas kernel's layouts: peq [W, 6, B] (uint32 bits in int32), plen
[B], texts [N, B] (chars 0..15, anything >= 6 matches nothing), tlen [B]
-> dist, end [B].
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabet import SIGMA

from ._build import check_operand, launch
from .myers import (
    MASK32, MAX_UNROLLED_WORDS, WORD, build_peq_vectorized, u32_tensor, widen,
)

SOURCE = "floxer_tpu_torch/csrc/myers_small.cu"
REPLACES = "floxer_tpu/ops/pallas_myers.py:38"
# the lanes per task of the kernel instance each word count W launches
# (myers_small_kernel<G>, G the smallest power of two >= W): the cases of
# floxer_myers_small in csrc/myers_small.cu
LANES_FOR_WORDS = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 6: 8, 7: 8, 8: 8}
# kernel launches in this process (read and reset by chip_smoke.py)
LAUNCHES = 0


def myers_small(
    peq: torch.Tensor,
    plen: torch.Tensor,
    texts: torch.Tensor,
    tlen: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist, end) int32 [B]: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_operands(peq, plen, texts, tlen)
    if peq.device.type == "cpu":
        return myers_small_plain(peq, plen, texts, tlen)
    return myers_small_cuda(peq, plen, texts, tlen)


def _check_operands(peq, plen, texts, tlen):
    W, _, B = peq.shape
    if not 1 <= W <= MAX_UNROLLED_WORDS:
        raise ValueError(f"myers_small takes 1..8 pattern words, got {W}")
    for tensor, name, shape in (
        (peq, "peq", (W, SIGMA, B)),
        (plen, "plen", (B,)),
        (texts, "texts", (texts.shape[0], B)),
        (tlen, "tlen", (B,)),
    ):
        check_operand(tensor, name, shape, torch.int32, peq.device)


def myers_small_cuda(peq, plen, texts, tlen):
    """The kernel on CUDA operands (myers_small's arguments); raises on
    CPU tensors."""
    global LAUNCHES
    _check_operands(peq, plen, texts, tlen)
    if peq.device.type != "cuda":
        raise ValueError(f"a CUDA kernel got operands on {peq.device}")
    W, _, B = peq.shape
    dist = torch.empty(B, dtype=torch.int32, device=peq.device)
    end = torch.empty(B, dtype=torch.int32, device=peq.device)
    if B == 0:
        return dist, end
    with torch.cuda.device(peq.device):
        launch(
            "floxer_myers_small",
            peq.data_ptr(), plen.data_ptr(), texts.data_ptr(),
            tlen.data_ptr(), B, W, texts.shape[0], dist.data_ptr(),
            end.data_ptr(), torch.cuda.current_stream(peq.device).cuda_stream,
        )
    LAUNCHES += 1
    return dist, end


def _group_ballot_carries(gen: int, prop: int, lanes: int) -> int:
    """The kernel's carries (csrc/myers_small.cu), on plain ints: the warp
    holds 32 / lanes tasks of `lanes` lanes each, bit l of `gen` and `prop`
    is lane l's generate and propagate bit (exclusive), and bit l of the
    result is the carry into lane l. One 32-bit lookahead add with each
    task's top lane masked out of both, so no carry crosses into the next
    task."""
    keep = MASK32 ^ sum(1 << lane for lane in range(lanes - 1, WORD, lanes))
    g, a = gen & keep, (gen | prop) & keep
    return ((a + g) ^ a ^ g) & MASK32


def myers_small_plain(peq, plen, texts, tlen):
    """The small kernel's recurrence in plain PyTorch: vectorized over
    tasks, loops over text columns and pattern words, 32-bit words held in
    int64."""
    W, _, B = peq.shape
    N = texts.shape[0]
    device = peq.device
    pq = widen(peq)
    plen = plen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    msb_word = torch.div(plen - 1, WORD, rounding_mode="floor")
    msb_mask = torch.ones_like(plen) << ((plen - 1) % WORD)
    active = [w <= msb_word for w in range(W)]
    vp = [torch.where(active[w], MASK32, 0) for w in range(W)]
    vn = [torch.zeros(B, dtype=torch.int64, device=device) for _ in range(W)]
    score = plen.clone()
    best = plen.clone()
    best_end = torch.zeros(B, dtype=torch.int64, device=device)
    chars = texts.to(torch.int64)
    bound = min(int(tlen.max()) - 1, N) if B else 0
    zero = torch.zeros(B, dtype=torch.int64, device=device)
    for j in range(bound):
        c = chars[j]
        add_carry = zero
        hp_carry = zero
        hn_carry = zero
        ph_msb = zero
        mh_msb = zero
        for w in range(W):
            eq = zero
            for s in range(SIGMA):
                eq = torch.where(c == s, pq[w, s], eq)
            wide = (eq & vp[w]) + vp[w] + add_carry
            add_carry = wide >> 32
            summ = wide & MASK32
            xh = (summ ^ vp[w]) | eq
            xv = eq | vn[w]
            ph = vn[w] | ((xh | vp[w]) ^ MASK32)
            mh = vp[w] & xh
            is_msb = msb_word == w
            ph_msb = torch.where(is_msb, ph & msb_mask, ph_msb)
            mh_msb = torch.where(is_msb, mh & msb_mask, mh_msb)
            ph_sh = ((ph << 1) & MASK32) | hp_carry
            mh_sh = ((mh << 1) & MASK32) | hn_carry
            hp_carry = ph >> 31
            hn_carry = mh >> 31
            vp[w] = torch.where(active[w], mh_sh | ((xv | ph_sh) ^ MASK32), 0)
            vn[w] = torch.where(active[w], ph_sh & xv, 0)
        score = score + (ph_msb != 0).to(torch.int64) - (mh_msb != 0).to(
            torch.int64
        )
        improves = (j + 1 < tlen) & (score <= best)
        best = torch.where(improves, score, best)
        best_end = torch.where(improves, j + 1, best_end)
    return best.to(torch.int32), best_end.to(torch.int32)


def myers_small_host(
    patterns: np.ndarray,
    pattern_lengths: np.ndarray,
    texts: np.ndarray,
    text_lengths: np.ndarray,
    device: torch.device,
    sync: bool = True,
):
    """Host-packing entry with the contract of
    floxer_tpu.ops.pallas_myers.myers_pallas: (distance, end_col) [B], as
    int32 tensors on `device` with sync=False."""
    peq = build_peq_vectorized(
        np.asarray(patterns), np.asarray(pattern_lengths)
    )  # [B, SIGMA, W]
    dist, end = myers_small(
        u32_tensor(np.transpose(peq, (2, 1, 0)), device),
        torch.from_numpy(np.asarray(pattern_lengths, dtype=np.int32)).to(device),
        torch.from_numpy(
            np.ascontiguousarray(np.asarray(texts, dtype=np.int32).T)
        ).to(device),
        torch.from_numpy(np.asarray(text_lengths, dtype=np.int32)).to(device),
    )
    if not sync:
        return dist, end
    return dist.cpu().numpy(), end.cpu().numpy()
