"""K3: full Myers for patterns of more than 256 chars.

Counterpart of floxer_tpu/ops/pallas_myers_large.py. `myers_large`
launches one of two hand-written CUDA kernels for CUDA tensors, chosen by
the padded word count Wp alone: the one-warp register kernel
(`myers_large_register`, csrc/myers_large.cu) for Wp up to the widest of
REGISTER_WORDS and the cluster kernel (`myers_large_cluster`,
csrc/myers_large_cluster.cu: a wavefront of warps on a thread-block
cluster) up to CLUSTER_WORDS, on as many blocks a task as
`cluster_blocks` picks for the launch's tasks; a wider Wp is refused with
a ValueError that names it. The shared-memory kernel
(`myers_large_shared`, csrc/myers_large.cu) stays as an entry point of its
own: no width routes to it, since the cluster kernel reaches past its
11,622-word limit of shared memory. All three compute the same function
and count their launches apart. For CPU tensors it runs
`myers_large_plain`. Operands keep the Pallas kernel's
layouts: peq [B, 6, Wp] (Wp a multiple of 32; uint32 bits in int32), plen
[B], texts [B, N] (chars 0..15, anything >= 6 matches nothing), tlen [B]
-> dist, end [B].
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..alphabet import SIGMA

from ._build import check_operand, launch
from .cuda_myers_banded import _exclusive_carries, pick_cluster_blocks
from .myers import MASK32, WORD, build_peq_vectorized, u32_tensor, widen

SOURCE = "floxer_tpu_torch/csrc/myers_large.cu"
CLUSTER_SOURCE = "floxer_tpu_torch/csrc/myers_large_cluster.cu"
REPLACES = "floxer_tpu/ops/pallas_myers_large.py:48"
# the widths (pattern words) of the register kernel's instances: the cases
# of floxer_myers_large_reg in csrc/myers_large.cu (R = words / 32 groups
# of 32 words, one word per lane); a launch takes the smallest instance
# that holds Wp
REGISTER_WORDS = (32, 64, 128, 256, 384, 512)
# the cluster kernel (csrc/myers_large_cluster.cu: kBlockWarps, kMaxBlocks,
# kMaxWords): a wavefront of warps of four 32-word groups on a
# thread-block cluster of up to CLUSTER_MAX_BLOCKS blocks of up to
# CLUSTER_BLOCK_WARPS warps a task, for any Wp past the register kernel's
# widest up to CLUSTER_WORDS
CLUSTER_BLOCK_WARPS = 16
CLUSTER_MAX_BLOCKS = 8
CLUSTER_WORDS = 16384
# kernel launches in this process, per kernel (read and reset by
# chip_smoke.py); `launches()` is K3's total; CLUSTER_WIDTHS counts the
# cluster kernel's launches by Wp; LONG_TASKS holds (Wp, tasks) of each
# cluster launch at the long reads' widths (up to LONG_WORDS)
REGISTER_LAUNCHES = 0
CLUSTER_LAUNCHES = 0
SHARED_LAUNCHES = 0
CLUSTER_WIDTHS: dict[int, int] = {}
LONG_WORDS = 2048
LONG_TASKS: list[tuple[int, int]] = []
# word-axis padding of the host entry (the Pallas kernel's lane tile)
WORD_TILE = 128


def launches() -> int:
    """K3's launches in this process, the three kernels together."""
    return REGISTER_LAUNCHES + CLUSTER_LAUNCHES + SHARED_LAUNCHES


def myers_large(
    peq: torch.Tensor,
    plen: torch.Tensor,
    texts: torch.Tensor,
    tlen: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist, end) int32 [B]: for CUDA tensors the register kernel up to
    REGISTER_WORDS' widest Wp and the cluster kernel up to CLUSTER_WORDS
    (a wider Wp raises a ValueError naming it); the plain version for CPU
    tensors."""
    _check_operands(peq, plen, texts, tlen)
    if peq.device.type == "cpu":
        return myers_large_plain(peq, plen, texts, tlen)
    if peq.shape[2] <= REGISTER_WORDS[-1]:
        return myers_large_register(peq, plen, texts, tlen)
    if peq.shape[2] <= CLUSTER_WORDS:
        return myers_large_cluster(peq, plen, texts, tlen)
    raise ValueError(
        f"a K3 pattern of {peq.shape[2]} words is wider than any kernel takes "
        f"on the card (the widest is {CLUSTER_WORDS} words)"
    )


def _check_operands(peq, plen, texts, tlen):
    B, _, Wp = peq.shape
    if Wp == 0 or Wp % WORD:
        raise ValueError(f"myers_large needs a multiple of 32 words, got {Wp}")
    for tensor, name, shape in (
        (peq, "peq", (B, SIGMA, Wp)),
        (plen, "plen", (B,)),
        (texts, "texts", (B, texts.shape[1])),
        (tlen, "tlen", (B,)),
    ):
        check_operand(tensor, name, shape, torch.int32, peq.device)


def _launch_cuda(entry, peq, plen, texts, tlen, *extra):
    """One launch of a C entry point on CUDA operands (`extra`: its int
    arguments after num_text); (dist, end) and whether it ran."""
    _check_operands(peq, plen, texts, tlen)
    if peq.device.type != "cuda":
        raise ValueError(f"a CUDA kernel got operands on {peq.device}")
    B, _, Wp = peq.shape
    dist = torch.empty(B, dtype=torch.int32, device=peq.device)
    end = torch.empty(B, dtype=torch.int32, device=peq.device)
    if B == 0:
        return dist, end, False
    with torch.cuda.device(peq.device):
        launch(
            entry,
            peq.data_ptr(), plen.data_ptr(), texts.data_ptr(),
            tlen.data_ptr(), B, Wp, texts.shape[1], *extra, dist.data_ptr(),
            end.data_ptr(), torch.cuda.current_stream(peq.device).cuda_stream,
        )
    return dist, end, True


def myers_large_register(peq, plen, texts, tlen):
    """The register kernel on CUDA operands (myers_large's arguments);
    raises above REGISTER_WORDS' widest Wp."""
    global REGISTER_LAUNCHES
    if peq.shape[2] > REGISTER_WORDS[-1]:
        raise ValueError(
            f"the register kernel takes up to {REGISTER_WORDS[-1]} words, "
            f"got {peq.shape[2]}"
        )
    dist, end, ran = _launch_cuda("floxer_myers_large_reg", peq, plen, texts,
                                  tlen)
    REGISTER_LAUNCHES += ran
    return dist, end


def cluster_blocks(words: int, tasks: int | None = None,
                   sms: int | None = None) -> int:
    """K3u's blocks a task at Wp words: pick_cluster_blocks' aim (blocks of
    about four warps) while `tasks` clusters of it fit the card's `sms`
    SMs a block each, else the most that fit, never fewer than the
    blocks that hold the width (without `tasks`, the aim). Measured in
    turns on overhanging roots at 544-2048 words and 8, 64 and 264 tasks
    (tools/k1_bench.py --large-layouts): a block more than the SMs hold
    runs its warps beside another cluster's on one SM, slower."""
    warps = -(-words // (WORD * 4))
    aim = pick_cluster_blocks(warps)
    if tasks is None:
        return aim
    fewest = -(-warps // CLUSTER_BLOCK_WARPS)
    return max(fewest, min(aim, sms // max(tasks, 1)))


@functools.lru_cache(maxsize=None)
def card_sms(device: torch.device) -> int:
    """The SMs of the card that holds `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def myers_large_cluster(peq, plen, texts, tlen, blocks: int | None = None):
    """The cluster kernel on CUDA operands (myers_large's arguments), on a
    cluster of `blocks` blocks a task (cluster_blocks' pick for the
    launch's tasks on this card unless given), at any Wp up to
    CLUSTER_WORDS; raises above, at a cluster size the width cannot take,
    and when the card refuses the cluster."""
    global CLUSTER_LAUNCHES
    words = peq.shape[2]
    if words > CLUSTER_WORDS:
        raise ValueError(
            f"the cluster kernel takes up to {CLUSTER_WORDS} words, got "
            f"{words}"
        )
    warps = -(-words // (WORD * 4))
    if blocks is not None and (not 1 <= blocks <= CLUSTER_MAX_BLOCKS
                               or -(-warps // blocks) > CLUSTER_BLOCK_WARPS):
        raise ValueError(f"a cluster of {blocks} blocks cannot hold {words} "
                         f"pattern words")
    if blocks is None and peq.device.type == "cuda":
        blocks = cluster_blocks(words, peq.shape[0], card_sms(peq.device))
    dist, end, ran = _launch_cuda("floxer_myers_large_cluster", peq, plen,
                                  texts, tlen, blocks)
    CLUSTER_LAUNCHES += ran
    if ran:
        CLUSTER_WIDTHS[words] = CLUSTER_WIDTHS.get(words, 0) + 1
        if words <= LONG_WORDS:
            LONG_TASKS.append((words, peq.shape[0]))
    return dist, end


def cluster_max_clusters(device: torch.device, words: int,
                         blocks: int) -> int:
    """Clusters of the cluster kernel's launch shape at Wp words on
    `blocks` blocks the card holds at once; 0 when none fits."""
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device):
        launch("floxer_myers_large_cluster_max_clusters", words, blocks,
               ctypes.addressof(clusters))
    return clusters.value


def myers_large_shared(peq, plen, texts, tlen):
    """The shared-memory kernel on CUDA operands (myers_large's
    arguments), at any Wp its shared memory holds (up to 11,622 words on
    an H100)."""
    global SHARED_LAUNCHES
    dist, end, ran = _launch_cuda("floxer_myers_large", peq, plen, texts,
                                  tlen)
    SHARED_LAUNCHES += ran
    return dist, end


def _chained_ballot_carries(gen: list[int], prop: list[int]) -> list[int]:
    """The register kernel's carries (csrc/myers_full_column.cuh
    `lookahead_carries`, chained in csrc/myers_large.cu), on plain ints:
    bit l of gen[i] and prop[i] is the generate and propagate bit of word
    32i + l (exclusive), and bit l of the result's [i] is the carry into
    that word. Within a group one 32-bit lookahead add; the add's carry
    out of lane 31 is the carry into the next group's lane 0."""
    carries, carry_in = [], 0
    for g, p in zip(gen, prop):
        a = g | p
        total = a + g + carry_in
        carries.append((total ^ a ^ g) & MASK32)
        carry_in = total >> 32
    return carries


def myers_large_plain(peq, plen, texts, tlen):
    """The large kernel's recurrence in plain PyTorch: vectorized over
    tasks and words (carries by a Kogge-Stone scan), one loop step per
    text column, 32-bit words held in int64."""
    B, _, Wp = peq.shape
    N = texts.shape[1]
    device = peq.device
    pq = widen(peq)
    plen = plen.to(torch.int64)
    tlen = tlen.to(torch.int64)
    chars = texts.to(torch.int64)
    words = torch.arange(Wp, device=device)[None, :]
    msb_word = torch.div(plen - 1, WORD, rounding_mode="floor")[:, None]
    msb_select = torch.where(
        words == msb_word, torch.ones_like(msb_word) << ((plen[:, None] - 1) % WORD), 0
    )
    active = words <= msb_word
    vp = torch.where(active, MASK32, 0)
    vn = torch.zeros_like(vp)
    zeros = torch.zeros((B, 1), dtype=torch.int64, device=device)
    score = plen.clone()
    best = plen.clone()
    best_end = torch.zeros(B, dtype=torch.int64, device=device)
    bound = min(int(tlen.max()) - 1, N) if B else 0
    for j in range(bound):
        c = chars[:, j]
        eq = torch.zeros_like(vp)
        for s in range(SIGMA):
            eq = torch.where((c == s)[:, None], pq[:, s], eq)
        wide = (eq & vp) + vp
        t = wide & MASK32
        carry_in = _exclusive_carries(wide >> 32, (t == MASK32).to(torch.int64))
        summ = (t + carry_in) & MASK32
        xh = (summ ^ vp) | eq
        xv = eq | vn
        ph = vn | ((xh | vp) ^ MASK32)
        mh = vp & xh
        ph_sh = ((ph << 1) & MASK32) | torch.cat([zeros, ph[:, :-1] >> 31], 1)
        mh_sh = ((mh << 1) & MASK32) | torch.cat([zeros, mh[:, :-1] >> 31], 1)
        vp = torch.where(active, mh_sh | ((xv | ph_sh) ^ MASK32), 0)
        vn = torch.where(active, ph_sh & xv, 0)
        score = score + ((ph & msb_select) != 0).any(1).to(torch.int64)
        score = score - ((mh & msb_select) != 0).any(1).to(torch.int64)
        improves = (j + 1 < tlen) & (score <= best)
        best = torch.where(improves, score, best)
        best_end = torch.where(improves, j + 1, best_end)
    return best.to(torch.int32), best_end.to(torch.int32)


def myers_large_host(
    patterns: np.ndarray,
    pattern_lengths: np.ndarray,
    texts: np.ndarray,
    text_lengths: np.ndarray,
    device: torch.device,
    sync: bool = True,
):
    """Host-packing entry with the contract of
    floxer_tpu.ops.pallas_myers_large.myers_pallas_large: (distance,
    end_col) [B] (int32 tensors on `device` with sync=False); the word
    axis is padded to a multiple of 128."""
    peq = build_peq_vectorized(
        np.asarray(patterns), np.asarray(pattern_lengths)
    )  # [B, SIGMA, W]
    B, _, W = peq.shape
    Wp = -(-max(W, 1) // WORD_TILE) * WORD_TILE
    peq_padded = np.zeros((B, SIGMA, Wp), dtype=np.uint32)
    peq_padded[:, :, :W] = peq
    dist, end = myers_large(
        u32_tensor(peq_padded, device),
        torch.from_numpy(np.asarray(pattern_lengths, dtype=np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(texts, dtype=np.int32)).to(device),
        torch.from_numpy(np.asarray(text_lengths, dtype=np.int32)).to(device),
    )
    if not sync:
        return dist, end
    return dist.cpu().numpy(), end.cpu().numpy()
