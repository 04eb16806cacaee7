"""K1: banded sliding-window Myers, the production verification kernel.

Counterpart of floxer_tpu/ops/pallas_myers_banded.py. `myers_banded`
launches one of four hand-written CUDA kernels for CUDA tensors, chosen by
band width alone: the one-warp register kernel (`myers_banded_register`,
csrc/myers_banded.cu) at the widths in REGISTER_BAND_WORDS, the multi-warp
register kernel (`myers_banded_wide`, csrc/myers_banded_wide.cu) at those
in WIDE_BAND_WORDS, the cluster kernel (`myers_banded_cluster`,
csrc/myers_banded_cluster.cu: the multi-warp column on a thread-block
cluster) at those in CLUSTER_BAND_WORDS, the shared-memory kernel
(`myers_banded_shared`, csrc/myers_banded.cu) at any other width up to
CLUSTER_MAX_WORDS; a wider band is refused with a ValueError that names
its width. All four compute the same function and count their launches
apart. For CPU tensors it runs
`myers_banded_plain`, the same recurrence as vectorized PyTorch with a
Python loop over text columns. The host packers `pack_nibbles` and
`prepare_banded_batch` are copied from the reference module, which imports
jax.

Kernel operands (uint32 words travel as int32 tensors with the same bits):
  vp0 [T, BW], planes0 [T, 4, BW] (three char bit-planes + the all-match
  plane), texts and stream [T, num_text/8] (4-bit chars, eight per word,
  little-endian), scalars [T, 6] int32 (tlen, j* = m - k,
  topshift = 32*BW - k, mfrozen, m, k) -> dist, end int32 [T].
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_operand, launch
from .myers import MASK32, WORD, u32_tensor, widen

SOURCE = "floxer_tpu_torch/csrc/myers_banded.cu"
WIDE_SOURCE = "floxer_tpu_torch/csrc/myers_banded_wide.cu"
CLUSTER_SOURCE = "floxer_tpu_torch/csrc/myers_banded_cluster.cu"
REPLACES = "floxer_tpu/ops/pallas_myers_banded.py:96"
# band widths (32-bit words) the register kernel is instantiated at: the
# cases of floxer_myers_banded_reg in csrc/myers_banded.cu (R = BW / 32
# words per lane)
REGISTER_BAND_WORDS = (32, 64, 128, 256, 384, 512)
# the multi-warp kernel (csrc/myers_banded_wide.cu: kWarps, kTileWords,
# kMaxBandWords): WIDE_WARPS warps a task of BW / WIDE_TILE_WORDS words a
# lane, for a band of a multiple of WIDE_TILE_WORDS words up to
# WIDE_MAX_WORDS; myers_banded sends it every 128-word tile (the fused
# wave's and the batcher's) past the register kernel's widest up to
# WIDE_MAX_WORDS
WIDE_WARPS = 4
WIDE_TILE_WORDS = WORD * WIDE_WARPS
WIDE_MAX_WORDS = 2048
WIDE_BAND_WORDS = tuple(range(REGISTER_BAND_WORDS[-1] + 128,
                              WIDE_MAX_WORDS + 1, 128))
# the cluster kernel (csrc/myers_banded_cluster.cu: kWordsPerLane,
# kBlockWarps, kMaxBlocks, kMaxBandWords): a lockstep column (every warp
# meets every other at a cluster barrier each column) on a thread-block cluster of up to CLUSTER_MAX_BLOCKS
# blocks of up to CLUSTER_BLOCK_WARPS warps a task, CLUSTER_WORDS_PER_LANE
# words a lane; it runs a band of a multiple of 32 CLUSTER_WORDS_PER_LANE
# words up to CLUSTER_MAX_WORDS, and myers_banded sends it every 128-word
# tile past the multi-warp kernel's widest
CLUSTER_WORDS_PER_LANE = 4
CLUSTER_BLOCK_WARPS = 16
CLUSTER_MAX_BLOCKS = 8
CLUSTER_MAX_WORDS = 16384
CLUSTER_BAND_WORDS = tuple(range(WIDE_MAX_WORDS + 128, CLUSTER_MAX_WORDS + 1,
                                 128))
# the warps a cluster block aims at: one for each of an SM's four
# sub-partitions (a column is dispatch-bound on its SM, and 4-warp blocks ran
# fastest: tools/k1_bench.py --clusters)
CLUSTER_AIM_WARPS = 4
# kernel launches in this process, per kernel (read and reset by
# chip_smoke.py); `launches()` is K1's total; CLUSTER_WIDTHS counts the
# cluster kernel's launches by band words; LONG_TASKS holds (band words,
# tasks) of each multi-warp launch
REGISTER_LAUNCHES = 0
WIDE_LAUNCHES = 0
CLUSTER_LAUNCHES = 0
SHARED_LAUNCHES = 0
CLUSTER_WIDTHS: dict[int, int] = {}
LONG_TASKS: list[tuple[int, int]] = []


def launches() -> int:
    """K1's launches in this process, the four kernels together."""
    return REGISTER_LAUNCHES + WIDE_LAUNCHES + CLUSTER_LAUNCHES + SHARED_LAUNCHES

(COL_TLEN, COL_JSTAR, COL_TOPSHIFT, COL_MFROZEN, COL_M, COL_K) = range(6)
NUM_SCALARS = 6


def pack_nibbles(chars: np.ndarray) -> np.ndarray:
    """Chars [T, Np] with values 0..15 (Np % 8 == 0) -> uint32 [T, Np/8],
    eight 4-bit nibbles per word, little-endian within the word.
    Copied from floxer_tpu/ops/pallas_myers_banded.py:pack_nibbles."""
    T, Np = chars.shape
    arr = chars.reshape(T, Np // 8, 8).astype(np.uint32)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
    return np.bitwise_or.reduce(arr << shifts, axis=2)


def prepare_banded_batch(
    patterns: list[np.ndarray],
    budgets: np.ndarray,
    band_words: int,
    num_text: int,
):
    """Vectorized host packing of per-task banded state: (vp0, planes0,
    packed stream, (tlen, jstar, topshift, mfrozen, minit, binit)) with
    tlen left 0 for the caller. Copied from
    floxer_tpu/ops/pallas_myers_banded.py:prepare_banded_batch."""
    T = len(patterns)
    b_store = band_words * WORD
    vp0 = np.zeros((T, band_words), dtype=np.uint32)
    planes0 = np.zeros((T, 4, band_words), dtype=np.uint32)
    stream = np.full((T, num_text), 7, dtype=np.uint8)
    tlen = np.zeros((T, 1), dtype=np.int32)
    jstar = np.zeros((T, 1), dtype=np.int32)
    topshift = np.zeros((T, 1), dtype=np.int32)
    mfrozen = np.zeros((T, 1), dtype=np.int32)
    minit = np.zeros((T, 1), dtype=np.int32)
    binit = np.zeros((T, 1), dtype=np.int32)

    bit_idx = np.arange(b_store)

    def pack_bits(bits: np.ndarray) -> np.ndarray:
        """bool [b_store] -> little-endian uint32 words [bw]."""
        return np.packbits(bits, bitorder="little").view("<u4")

    for t, pattern in enumerate(patterns):
        m = len(pattern)
        k = int(budgets[t])
        rows = bit_idx + k - (b_store - 1)  # absolute row at band pos p
        vp0[t] = pack_bits(rows >= 1)
        pad_rows = rows <= 0
        in_pat = (rows >= 1) & (rows <= m)
        codes = np.full(b_store, 7, dtype=np.int64)  # matches nothing
        codes[in_pat] = pattern[np.clip(rows[in_pat] - 1, 0, m - 1)]
        for i in range(3):
            planes0[t, i] = pack_bits(((codes >> i) & 1) != 0)
        planes0[t, 3] = pack_bits(pad_rows)
        n_stream = min(num_text, max(0, m - k))
        if n_stream > 0:
            stream[t, :n_stream] = pattern[k : k + n_stream]
        jstar[t, 0] = m - k
        topshift[t, 0] = b_store - k
        mfrozen[t, 0] = 1 if m >= b_store else 0
        minit[t, 0] = m
        binit[t, 0] = k
    packed_stream = pack_nibbles(stream)
    return vp0, planes0, packed_stream, (
        tlen, jstar, topshift, mfrozen, minit, binit
    )


def myers_banded(
    vp0: torch.Tensor,
    planes0: torch.Tensor,
    texts_packed: torch.Tensor,
    stream_packed: torch.Tensor,
    scalars: torch.Tensor,
    band_words: int,
    num_text: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist, end) int32 [T] on the operands' device: for CUDA tensors the
    register kernel at REGISTER_BAND_WORDS, the multi-warp kernel at
    WIDE_BAND_WORDS, the cluster kernel at CLUSTER_BAND_WORDS and the
    shared-memory kernel at any other width up to CLUSTER_MAX_WORDS (a
    wider band raises a ValueError naming its width); the plain version
    for CPU tensors."""
    args = (vp0, planes0, texts_packed, stream_packed, scalars, band_words,
            num_text)
    if vp0.device.type != "cpu":
        if band_words in REGISTER_BAND_WORDS:
            return myers_banded_register(*args)
        if band_words in WIDE_BAND_WORDS:
            return myers_banded_wide(*args)
        if band_words in CLUSTER_BAND_WORDS:
            return myers_banded_cluster(*args)
        if band_words > CLUSTER_MAX_WORDS:
            raise ValueError(
                f"a K1 band of {band_words} words is wider than any kernel "
                f"takes on the card (the widest is {CLUSTER_MAX_WORDS} words)"
            )
        return myers_banded_shared(*args)
    _check_operands(*args)
    return myers_banded_plain(*args)


def _check_operands(
    vp0, planes0, texts_packed, stream_packed, scalars, band_words, num_text
):
    T = vp0.shape[0]
    if band_words % WORD or num_text % 8:
        raise ValueError("band_words must be a multiple of 32, num_text of 8")
    for tensor, name, shape in (
        (vp0, "vp0", (T, band_words)),
        (planes0, "planes0", (T, 4, band_words)),
        (texts_packed, "texts_packed", (T, num_text // 8)),
        (stream_packed, "stream_packed", (T, num_text // 8)),
        (scalars, "scalars", (T, NUM_SCALARS)),
    ):
        check_operand(tensor, name, shape, torch.int32, vp0.device)


def _launch_cuda(entry, vp0, planes0, texts_packed, stream_packed, scalars,
                 band_words, num_text, *extra):
    """One launch of a C entry point (`extra`: its int arguments after
    text_words); (dist, end) and whether it ran."""
    T = vp0.shape[0]
    dist = torch.empty(T, dtype=torch.int32, device=vp0.device)
    end = torch.empty(T, dtype=torch.int32, device=vp0.device)
    if T == 0:
        return dist, end, False
    with torch.cuda.device(vp0.device):
        launch(
            entry,
            vp0.data_ptr(), planes0.data_ptr(), texts_packed.data_ptr(),
            stream_packed.data_ptr(), scalars.data_ptr(),
            T, band_words, num_text // 8, *extra, dist.data_ptr(),
            end.data_ptr(), torch.cuda.current_stream(vp0.device).cuda_stream,
        )
    return dist, end, True


def myers_banded_register(*args):
    """The register kernel on CUDA operands (myers_banded's arguments);
    raises at a band width outside REGISTER_BAND_WORDS."""
    global REGISTER_LAUNCHES
    _check_cuda(*args)
    if args[5] not in REGISTER_BAND_WORDS:
        raise ValueError(
            f"the register kernel takes band_words in {REGISTER_BAND_WORDS}, "
            f"got {args[5]}"
        )
    dist, end, ran = _launch_cuda("floxer_myers_banded_reg", *args)
    REGISTER_LAUNCHES += ran
    return dist, end


def myers_banded_wide(*args):
    """The multi-warp register kernel on CUDA operands (myers_banded's
    arguments); raises at a band width that is not a multiple of
    WIDE_TILE_WORDS words up to WIDE_MAX_WORDS."""
    global WIDE_LAUNCHES
    band_words = args[5]
    if band_words % WIDE_TILE_WORDS or band_words > WIDE_MAX_WORDS:
        raise ValueError(
            f"the multi-warp kernel takes a multiple of {WIDE_TILE_WORDS} "
            f"words up to {WIDE_MAX_WORDS}, got {band_words}"
        )
    _check_cuda(*args)
    dist, end, ran = _launch_cuda("floxer_myers_banded_wide", *args)
    WIDE_LAUNCHES += ran
    if ran:
        LONG_TASKS.append((band_words, args[0].shape[0]))
    return dist, end


def pick_cluster_blocks(warps: int) -> int:
    """The blocks of a cluster kernel's cluster (K1u, K3u) for `warps`
    warps a task: blocks of about CLUSTER_AIM_WARPS warps, at most
    CLUSTER_MAX_BLOCKS (then up to CLUSTER_BLOCK_WARPS warps each)."""
    return max(-(-warps // CLUSTER_BLOCK_WARPS),
               min(CLUSTER_MAX_BLOCKS, -(-warps // CLUSTER_AIM_WARPS)))


def cluster_blocks(band_words: int) -> int:
    """pick_cluster_blocks for K1u at a band width."""
    return pick_cluster_blocks(band_words // (WORD * CLUSTER_WORDS_PER_LANE))


def myers_banded_cluster(*args, blocks: int | None = None):
    """The cluster kernel on CUDA operands (myers_banded's arguments), on
    a cluster of `blocks` blocks a task (cluster_blocks' pick unless
    given); raises at a band width that is not a multiple of
    32 CLUSTER_WORDS_PER_LANE words up to CLUSTER_MAX_WORDS, at a cluster
    size the width cannot take, and when the card refuses the cluster."""
    global CLUSTER_LAUNCHES
    band_words = args[5]
    if (band_words % (WORD * CLUSTER_WORDS_PER_LANE)
            or not 0 < band_words <= CLUSTER_MAX_WORDS):
        raise ValueError(
            f"the cluster kernel takes a multiple of "
            f"{WORD * CLUSTER_WORDS_PER_LANE} words up to {CLUSTER_MAX_WORDS}, "
            f"got {band_words}"
        )
    warps = band_words // (WORD * CLUSTER_WORDS_PER_LANE)
    if blocks is not None and (not 1 <= blocks <= CLUSTER_MAX_BLOCKS
                               or -(-warps // blocks) > CLUSTER_BLOCK_WARPS):
        raise ValueError(f"a cluster of {blocks} blocks cannot hold "
                         f"{band_words} band words")
    _check_cuda(*args)
    blocks = cluster_blocks(band_words) if blocks is None else blocks
    dist, end, ran = _launch_cuda("floxer_myers_banded_cluster", *args, blocks)
    CLUSTER_LAUNCHES += ran
    if ran:
        CLUSTER_WIDTHS[band_words] = CLUSTER_WIDTHS.get(band_words, 0) + 1
    return dist, end


def cluster_max_clusters(device: torch.device, band_words: int,
                         blocks: int) -> int:
    """Clusters of the cluster kernel's launch shape at `band_words` on
    `blocks` blocks the card holds at once; 0 when none fits."""
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device):
        launch("floxer_myers_banded_cluster_max_clusters", band_words,
               blocks, ctypes.addressof(clusters))
    return clusters.value


def myers_banded_shared(*args):
    """The shared-memory kernel on CUDA operands (myers_banded's
    arguments), at any band width."""
    global SHARED_LAUNCHES
    _check_cuda(*args)
    dist, end, ran = _launch_cuda("floxer_myers_banded", *args)
    SHARED_LAUNCHES += ran
    return dist, end


def _check_cuda(*args):
    _check_operands(*args)
    if args[0].device.type != "cuda":
        raise ValueError(f"a CUDA kernel got operands on {args[0].device}")


def _nibble(packed: torch.Tensor, j: int) -> torch.Tensor:
    """Char j of every row of nibble-packed int64 words [T, Np/8]."""
    return (packed[:, j >> 3] >> (4 * (j & 7))) & 0xF


def _exclusive_carries(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Carry into each word of a multi-word add from per-word carry
    generate/propagate bits [T, W] (Kogge-Stone over the word axis)."""
    W = g.shape[1]
    d = 1
    while d < W:
        g_up = torch.nn.functional.pad(g[:, :-d], (d, 0))
        p_up = torch.nn.functional.pad(p[:, :-d], (d, 0))
        g = g | (p & g_up)
        p = p & p_up
        d *= 2
    return torch.nn.functional.pad(g[:, :-1], (1, 0))


def _ballot_carries(g: int, p: int) -> int:
    """The register kernel's carry across a warp (csrc/myers_banded.cu), on
    plain ints: bit l of `g` and `p` is lane l's run generate and propagate
    bit (exclusive, g & p == 0), and bit l of the result is the carry into
    lane l, from one 32-bit carry-lookahead add."""
    a = g | p
    return ((a + g) ^ a ^ g) & MASK32


def myers_banded_plain(
    vp0, planes0, texts_packed, stream_packed, scalars, band_words, num_text
):
    """The banded kernel's recurrence in plain PyTorch: vectorized over
    tasks, one loop step per text column, 32-bit words held in int64."""
    T = vp0.shape[0]
    device = vp0.device
    sc = scalars.to(torch.int64)
    tlen, jstar, topshift = sc[:, COL_TLEN], sc[:, COL_JSTAR], sc[:, COL_TOPSHIFT]
    mfrozen, m, k = sc[:, COL_MFROZEN] != 0, sc[:, COL_M], sc[:, COL_K]
    vp = widen(vp0)
    vn = torch.zeros_like(vp)
    p0, p1, p2, am = (widen(planes0[:, i]) for i in range(4))
    texts = widen(texts_packed)
    stream = widen(stream_packed)
    s_bot = k.clone()
    s_m = m.clone()
    best = m.clone()
    best_end = torch.zeros(T, dtype=torch.int64, device=device)
    ones = torch.ones(T, dtype=torch.int64, device=device)
    zeros = torch.zeros(T, dtype=torch.int64, device=device)
    last_col = min(int(tlen.max()) - 1, num_text) if T else 0

    def shr(x, entering):
        """Band slide: one bit toward word 0, `entering` at the top."""
        nxt = torch.cat([x[:, 1:] & 1, entering[:, None]], dim=1)
        return (x >> 1) | (nxt << 31)

    def sel(plane, bit):
        return torch.where(bit[:, None] != 0, plane, plane ^ MASK32)

    for col in range(1, last_col + 1):
        j = col - 1
        tch = _nibble(texts, j)
        pch = _nibble(stream, j)
        sliding = col <= jstar
        sl = sliding[:, None]
        vp = torch.where(sl, shr(vp, ones), vp)
        vn = torch.where(sl, shr(vn, zeros), vn)
        p0 = torch.where(sl, shr(p0, pch & 1), p0)
        p1 = torch.where(sl, shr(p1, (pch >> 1) & 1), p1)
        p2 = torch.where(sl, shr(p2, (pch >> 2) & 1), p2)
        am = torch.where(sl, shr(am, zeros), am)
        s_bot = s_bot + sliding.to(torch.int64)

        eq = (sel(p0, tch & 1) & sel(p1, tch & 2) & sel(p2, tch & 4)) | am
        xv = eq | vn
        wide = (eq & vp) + vp
        t = wide & MASK32
        carry_in = _exclusive_carries(wide >> 32, (t == MASK32).to(torch.int64))
        summ = (t + carry_in) & MASK32
        xh = (summ ^ vp) | eq
        ph = vn | ((xh | vp) ^ MASK32)
        mh = vp & xh

        d_bot = (ph[:, -1] >> 31) - (mh[:, -1] >> 31)
        s_bot = s_bot + d_bot
        s_m = torch.where(
            col == jstar, s_bot, s_m + torch.where(sliding, 0, d_bot)
        )

        pessim = torch.where(sliding, col >= topshift, mfrozen).to(torch.int64)
        ph_sh = ((ph << 1) & MASK32) | torch.cat(
            [pessim[:, None], ph[:, :-1] >> 31], dim=1
        )
        mh_sh = ((mh << 1) & MASK32) | torch.cat(
            [zeros[:, None], mh[:, :-1] >> 31], dim=1
        )
        vp = mh_sh | ((xv | ph_sh) ^ MASK32)
        vn = ph_sh & xv

        improves = (col < tlen) & (col >= jstar) & (s_m <= best)
        best = torch.where(improves, s_m, best)
        best_end = torch.where(improves, col, best_end)
    return best.to(torch.int32), best_end.to(torch.int32)


def myers_banded_host(
    patterns: list[np.ndarray],
    texts: np.ndarray,  # [T, Np] padded uint8
    text_lengths: np.ndarray,
    budgets: np.ndarray,
    band_words: int,
    device: torch.device,
    sync: bool = True,
):
    """Host-packing entry with the contract of
    floxer_tpu.ops.pallas_myers_banded.myers_pallas_banded: (distance,
    end_col) per task, as int32 tensors on `device` with sync=False.
    Requires 0 < budget < m and band_words*32 >= n - m + 2*budget + 1 for
    every task. No pad rows: the kernel stops each task at its tlen."""
    operands, num_text = banded_operands(
        patterns, texts, text_lengths, budgets, band_words, device
    )
    dist, end = myers_banded(*operands, band_words, num_text)
    if not sync:
        return dist, end
    return dist.cpu().numpy(), end.cpu().numpy()


def banded_operands(
    patterns: list[np.ndarray],
    texts: np.ndarray,  # [T, Np] padded uint8
    text_lengths: np.ndarray,
    budgets: np.ndarray,
    band_words: int,
    device: torch.device,
):
    """The host packing of myers_banded_host: ((vp0, planes0, texts_packed,
    stream_packed, scalars) on `device`, num_text)."""
    T = len(patterns)
    num_text = -(-max(texts.shape[1], 1) // 8) * 8
    vp0, planes0, stream, scalars = prepare_banded_batch(
        patterns, budgets, band_words, num_text
    )
    scalars[COL_TLEN][:, 0] = text_lengths
    texts_u8 = np.zeros((T, num_text), dtype=np.uint8)
    texts_u8[:, : texts.shape[1]] = texts
    return (
        u32_tensor(vp0, device),
        u32_tensor(planes0, device),
        u32_tensor(pack_nibbles(texts_u8), device),
        u32_tensor(stream, device),
        torch.from_numpy(np.concatenate(scalars, axis=1)).to(device),
    ), num_text


def band_cases(rng: np.random.Generator, count: int, band_words: int):
    """Seeded K1 tasks that fit a band of band_words words
    (n - m + 2k + 1 <= 32 * band_words): patterns shorter and longer than
    the band, windows from m - k to the band's limit, and some text chars
    6..15 as fused windows carry past their end. (patterns, texts,
    budgets) for banded_operands, after padding the texts."""
    bits = WORD * band_words
    patterns, texts, budgets = [], [], []
    for _ in range(count):
        k = int(rng.integers(1, min(200, bits // 6)))
        m = int(rng.integers(k + 1, k + 2 + min(2 * bits, 2400)))
        n = int(rng.integers(max(1, m - k), m + min(bits - 2 * k, 600)))
        pattern = rng.integers(1, 5, size=m).astype(np.uint8)
        noisy = pattern.copy()
        for pos in rng.integers(0, m, size=int(rng.integers(0, k + 2))):
            noisy[pos] = 1 + (noisy[pos] % 4)
        lead = rng.integers(1, 5, size=int(rng.integers(0, k + 1)))
        tail = rng.integers(1, 5, size=n)
        text = np.concatenate([lead, noisy, tail]).astype(np.uint8)[:n]
        if rng.random() < 0.2:
            text[::9] = rng.integers(6, 16, size=len(text[::9]))
        patterns.append(pattern)
        texts.append(text)
        budgets.append(k)
    return patterns, texts, np.asarray(budgets)


def deep_band_cases(rng: np.random.Generator, count: int, band_words: int,
                    max_columns: int):
    """Seeded K1 tasks whose pattern rows fill most of a band of
    band_words words from the first column on: a budget k of half to
    nearly all of the band's bits, m = k + j* with j* below the text's
    length, texts of max_columns / 2 to max_columns chars (a mutated copy
    of the pattern's end, after random chars where the pattern is
    shorter; chars 6..15 in some), so every warp of a wide
    band holds real rows within a few columns. Every other pattern is made
    of runs of one char, 200-3000 long: a text char that a run lacks
    leaves its rows propagating, so a carry crosses whole warps.
    (patterns, texts, budgets) for banded_operands, after padding the
    texts."""
    bits = WORD * band_words
    patterns, texts, budgets = [], [], []
    for i in range(count):
        n = int(rng.integers(max(2, max_columns // 2), max_columns + 1))
        jstar = int(rng.integers(1, n))
        k_top = bits - n + jstar  # the band's limit, exclusive
        k = int(rng.integers(max(1, min(bits // 2, k_top - 1)), k_top))
        if i % 2:
            runs = rng.integers(200, 3001, size=(k + jstar) // 200 + 1)
            chars = rng.integers(1, 5, size=len(runs))
            pattern = np.repeat(chars, runs)[: k + jstar].astype(np.uint8)
        else:
            pattern = rng.integers(1, 5, size=k + jstar).astype(np.uint8)
        tail = pattern[-n:]
        text = np.concatenate(
            [rng.integers(1, 5, size=n - len(tail)), tail]).astype(np.uint8)
        for pos in rng.integers(0, n, size=int(rng.integers(0, n // 8 + 2))):
            text[pos] = 1 + (text[pos] % 4)
        if rng.random() < 0.5:
            text[::9] = rng.integers(6, 16, size=len(text[::9]))
        patterns.append(pattern)
        texts.append(text)
        budgets.append(k)
    return patterns, texts, np.asarray(budgets)

