"""The port's kernel modules (floxer_tpu_torch/ops/cuda_myers*.py) against
the reference's Pallas kernels in interpret mode and the DP oracle.

On the CPU each entry point runs its kernel's plain PyTorch version
(tests/test_torch_cuda.py holds the CUDA kernels against those plain
versions on the card). Every comparison of (distance, end) is exact."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from floxer_tpu.ops.device_dp import pad_batch
from floxer_tpu.ops.dp_reference import _rightmost_argmin, semi_global_dp_matrix
from floxer_tpu.ops.myers_banded import band_store_bits, myers_banded_np
from floxer_tpu.ops.pallas_myers import myers_pallas
from floxer_tpu.ops.pallas_myers_banded import myers_pallas_banded
from floxer_tpu.ops.pallas_myers_large import myers_pallas_large
from floxer_tpu_torch.ops import cuda_myers, cuda_myers_banded, cuda_myers_large
from floxer_tpu_torch.ops.cuda_myers import myers_small_host
from floxer_tpu_torch.ops.cuda_myers_banded import myers_banded_host
from floxer_tpu_torch.ops.cuda_myers_large import myers_large_host
from floxer_tpu_torch.ops.myers import full_myers_operands, myers_distance

CPU = torch.device("cpu")


def oracle(pattern, text):
    dp = semi_global_dp_matrix(text, pattern)
    last = dp[-1]
    end = _rightmost_argmin(last)
    return int(last[end]), end


def banded_cases(seed, count=10):
    """tests/test_pallas_myers_banded.py's generator: a text and a mutated
    slice of it, 0 < budget < m."""
    rng = np.random.default_rng(seed)
    patterns, texts, budgets = [], [], []
    for _ in range(count):
        m = int(rng.integers(60, 500))
        budget = int(rng.integers(1, max(2, m // 5)))
        extra = int(rng.integers(0, budget + 2))
        n = m + 2 * budget + 1 + extra
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, n - m))
        pattern = text[start : start + m].copy()
        for _ in range(int(rng.integers(0, budget + 2))):
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, len(pattern)))
            if op == 0:
                pattern[pos] = 1 + (pattern[pos] % 4)
            elif op == 1 and len(pattern) > 10:
                pattern = np.delete(pattern, pos)
            else:
                pattern = np.insert(pattern, pos, rng.integers(1, 5))
        if budget >= len(pattern):
            continue
        patterns.append(pattern)
        texts.append(text)
        budgets.append(budget)
    return patterns, texts, budgets


def full_cases(seed, count, m_lo, m_hi, garbage_every=0):
    """tests/test_pallas_myers*.py's generator; garbage_every > 0 puts
    chars 6..15 into the texts, as fused windows carry past their end."""
    rng = np.random.default_rng(seed)
    patterns, texts = [], []
    for _ in range(count):
        m = int(rng.integers(m_lo, m_hi))
        n = int(rng.integers(m, m + 60))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, max(1, n - m)))
        pattern = text[start : start + m].copy()
        for _ in range(int(rng.integers(0, 5))):
            pos = int(rng.integers(0, len(pattern)))
            pattern[pos] = 1 + (pattern[pos] % 4)
        if garbage_every:
            text[::garbage_every] = rng.integers(6, 16, size=len(text[::garbage_every]))
        patterns.append(pattern)
        texts.append(text)
    return patterns, texts


def band_words_for(patterns, texts, budgets):
    bits = max(
        band_store_bits(len(p), len(t), int(k))
        for p, t, k in zip(patterns, texts, budgets)
    )
    return -(-(-(-bits // 32)) // 128) * 128


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_plain_matches_pallas_and_oracle(seed):
    patterns, texts, budgets = banded_cases(seed)
    txt, tlen = pad_batch(texts)
    band_words = band_words_for(patterns, texts, budgets)
    want = myers_pallas_banded(
        patterns, txt, tlen, np.asarray(budgets), band_words, interpret=True
    )
    got = myers_banded_host(
        patterns, txt, tlen, np.asarray(budgets), band_words, CPU
    )
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for i, (pattern, text, budget) in enumerate(zip(patterns, texts, budgets)):
        full = oracle(pattern, text)
        if full[0] <= budget:
            assert (int(got[0][i]), int(got[1][i])) == full, f"row {i}"
        else:
            assert got[0][i] > budget, f"row {i} false accept"


@pytest.mark.parametrize("seed,max_m", [(0, 30), (1, 90), (2, 257)])
def test_small_plain_matches_pallas_and_oracle(seed, max_m):
    patterns, texts = full_cases(seed, 7, 2, max_m, garbage_every=7)
    pat, plen = pad_batch(patterns)
    txt, tlen = pad_batch(texts)
    want = myers_pallas(pat, plen, txt, tlen, interpret=True)
    got = myers_small_host(pat, plen, txt, tlen, CPU)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    clean_patterns, clean_texts = full_cases(seed, 7, 2, max_m)
    pat, plen = pad_batch(clean_patterns)
    txt, tlen = pad_batch(clean_texts)
    dist, end = myers_small_host(pat, plen, txt, tlen, CPU)
    for i, (pattern, text) in enumerate(zip(clean_patterns, clean_texts)):
        assert (int(dist[i]), int(end[i])) == oracle(pattern, text), f"row {i}"


@pytest.mark.parametrize("seed,max_m", [(0, 60), (1, 300)])
def test_large_plain_matches_pallas_and_oracle(seed, max_m):
    patterns, texts = full_cases(seed, 5, 20, max_m, garbage_every=11)
    pat, plen = pad_batch(patterns)
    txt, tlen = pad_batch(texts)
    want = myers_pallas_large(pat, plen, txt, tlen, interpret=True)
    got = myers_large_host(pat, plen, txt, tlen, CPU)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    clean_patterns, clean_texts = full_cases(seed, 5, 20, max_m)
    pat, plen = pad_batch(clean_patterns)
    txt, tlen = pad_batch(clean_texts)
    dist, end = myers_large_host(pat, plen, txt, tlen, CPU)
    for i, (pattern, text) in enumerate(zip(clean_patterns, clean_texts)):
        assert (int(dist[i]), int(end[i])) == oracle(pattern, text), f"row {i}"


def test_myers_distance_dispatch_by_word_count():
    """Patterns over 8 words go to K3, all others to K2; both exact."""
    for max_m in (200, 400):
        patterns, texts = full_cases(5, 6, max_m - 100, max_m)
        pat, plen = pad_batch(patterns)
        txt, tlen = pad_batch(texts)
        before = (cuda_myers.LAUNCHES, cuda_myers_large.launches())
        dist, end = myers_distance(pat, plen, txt, tlen, CPU)
        # the plain versions launch nothing
        assert (cuda_myers.LAUNCHES, cuda_myers_large.launches()) == before
        for i, (pattern, text) in enumerate(zip(patterns, texts)):
            assert (int(dist[i]), int(end[i])) == oracle(pattern, text)


def test_dead_tasks_return_the_sentinel():
    """tlen <= 1 scores no column: distance = pattern length, end 0 (what
    the fused wave hands a task whose walk already failed)."""
    patterns, texts = full_cases(3, 4, 20, 200)
    pat, plen = pad_batch(patterns)
    txt, _ = pad_batch(texts)
    for host in (myers_small_host, myers_large_host):
        dist, end = host(pat, plen, txt, np.zeros(4, dtype=np.int32), CPU)
        np.testing.assert_array_equal(dist, plen)
        np.testing.assert_array_equal(end, 0)


def test_operands_are_validated_on_the_cpu_route():
    peq = torch.zeros((2, 6, 4), dtype=torch.int32)
    lens = torch.ones(4, dtype=torch.int32)
    texts = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_myers.myers_small(peq, lens, texts.t().contiguous().t(), lens)
    with pytest.raises(ValueError, match="int32"):
        cuda_myers.myers_small(peq, lens.to(torch.int64), texts, lens)
    with pytest.raises(ValueError, match="shape"):
        cuda_myers_large.myers_large(
            torch.zeros((4, 6, 32), dtype=torch.int32), lens, texts, lens[:3]
        )
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_myers_banded.myers_banded(
            *(torch.zeros((1, 8), dtype=torch.int32),) * 5, 8, 8
        )


# per lane: 0 kills the carry, 1 generates it, 2 propagates it (a run's
# generate and propagate bits are exclusive)
LANE_STATES = st.lists(st.integers(0, 2), min_size=32, max_size=32)


@settings(max_examples=300, deadline=None)
@given(LANE_STATES)
def test_ballot_carry_equals_the_word_scan(states):
    """K1's register kernel carries between lanes with one 32-bit
    carry-lookahead add on the lanes' generate and propagate ballots;
    the carry into every lane equals the plain version's Kogge-Stone scan
    over the same (G, P) vectors."""
    g = [int(s == 1) for s in states]
    p = [int(s == 2) for s in states]
    want = cuda_myers_banded._exclusive_carries(
        torch.tensor([g], dtype=torch.int64),
        torch.tensor([p], dtype=torch.int64),
    )[0].tolist()
    got = cuda_myers_banded._ballot_carries(
        sum(bit << lane for lane, bit in enumerate(g)),
        sum(bit << lane for lane, bit in enumerate(p)),
    )
    assert [(got >> lane) & 1 for lane in range(32)] == want


def test_register_widths_are_the_kernel_sources():
    """REGISTER_BAND_WORDS lists exactly the widths csrc/myers_banded.cu
    instantiates the register kernel at (R = BW / 32 words per lane)."""
    source = (
        Path(__file__).resolve().parent.parent / cuda_myers_banded.SOURCE
    ).read_text()
    instances = {
        32 * int(r) for r in re.findall(r"^\s*FLOXER_REG_CASE\((\d+)\)$",
                                        source, re.M)
    }
    assert instances == set(cuda_myers_banded.REGISTER_BAND_WORDS)
    assert {bw // 32 for bw in instances} >= {1, 2, 4, 8, 12, 16}


@pytest.mark.parametrize("band_words", [128, 640])
def test_banded_kernels_refuse_cpu_operands(band_words):
    """On the CPU myers_banded runs the plain version at every width and
    counts no launch; the kernels' own wrappers refuse CPU tensors."""
    patterns, texts, budgets = banded_cases(4, count=4)
    txt, tlen = pad_batch(texts)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, np.asarray(budgets), band_words, CPU
    )
    before = cuda_myers_banded.launches()
    dist, _ = cuda_myers_banded.myers_banded(*operands, band_words, num_text)
    assert cuda_myers_banded.launches() == before
    assert dist.device == CPU
    for kernel in (cuda_myers_banded.myers_banded_register,
                   cuda_myers_banded.myers_banded_shared):
        with pytest.raises(ValueError, match="CUDA kernel"):
            kernel(*operands, band_words, num_text)


@pytest.mark.parametrize(
    "band_words", (*cuda_myers_banded.REGISTER_BAND_WORDS, 640)
)
def test_band_cases_fit_their_band(band_words):
    """The card tests' and chip_smoke.py's K1 generator gives tasks the
    band holds (n - m + 2k + 1 <= 32 * band_words, 0 < k < m, windows
    from m - k chars), reproducibly from the seed."""
    draw = [
        cuda_myers_banded.band_cases(np.random.default_rng(band_words), 24,
                                     band_words)
        for _ in range(2)
    ]
    patterns, texts, budgets = draw[0]
    assert len(patterns) == len(texts) == len(budgets) == 24
    for pattern, text, k in zip(patterns, texts, budgets):
        m, n = len(pattern), len(text)
        assert 0 < k < m and n >= m - k
        assert n - m + 2 * k + 1 <= 32 * band_words
    for a, b in zip(draw[0], draw[1]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def lane_vectors(states):
    """Per-lane 0 (kill), 1 (generate), 2 (propagate) -> the generate and
    propagate bits as lists."""
    return [int(s == 1) for s in states], [int(s == 2) for s in states]


def mask_of(bits):
    return sum(bit << lane for lane, bit in enumerate(bits))


def word_scan(g, p):
    """The plain versions' carries into each word of one multi-word add."""
    return cuda_myers_banded._exclusive_carries(
        torch.tensor([g], dtype=torch.int64),
        torch.tensor([p], dtype=torch.int64),
    )[0].tolist()


@settings(max_examples=300, deadline=None)
@given(LANE_STATES, st.sampled_from(sorted(set(cuda_myers.LANES_FOR_WORDS.values()))))
def test_group_ballot_carry_equals_each_tasks_word_scan(states, lanes):
    """K2 holds 32 / lanes tasks per warp and carries with one lookahead
    add on the warp's ballots, each task's top lane masked out: the carry
    into every lane equals the plain version's scan over that task's own
    words alone, so no carry crosses from one task into the next."""
    g, p = lane_vectors(states)
    got = cuda_myers._group_ballot_carries(mask_of(g), mask_of(p), lanes)
    for first in range(0, 32, lanes):
        task = slice(first, first + lanes)
        want = word_scan(g[task], p[task])
        assert [(got >> lane) & 1 for lane in range(first, first + lanes)] == want


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 16).flatmap(
    lambda groups: st.lists(st.integers(0, 2), min_size=32 * groups,
                            max_size=32 * groups)
))
def test_chained_group_carries_equal_the_word_scan(states):
    """K3's register kernel carries within each group of 32 words by one
    lookahead add and from group to group through that add's carry out:
    the carry into every word equals the plain version's scan over all
    the task's words."""
    g, p = lane_vectors(states)
    groups = len(states) // 32
    got = cuda_myers_large._chained_ballot_carries(
        [mask_of(g[32 * i : 32 * i + 32]) for i in range(groups)],
        [mask_of(p[32 * i : 32 * i + 32]) for i in range(groups)],
    )
    flat = [(got[w // 32] >> (w % 32)) & 1 for w in range(len(states))]
    assert flat == word_scan(g, p)


def kernel_source(module) -> str:
    return (Path(__file__).resolve().parent.parent / module.SOURCE).read_text()


def test_full_myers_instances_are_the_kernel_sources():
    """REGISTER_WORDS lists exactly the widths csrc/myers_large.cu
    instantiates K3's register kernel at (R = words / 32 groups), and
    LANES_FOR_WORDS the lanes per task csrc/myers_small.cu launches K2 at
    for each word count: the smallest power of two that holds W words."""
    instances = {
        32 * int(r) for r in re.findall(
            r"^\s*FLOXER_LARGE_REG_CASE\((\d+)\)$",
            kernel_source(cuda_myers_large), re.M,
        )
    }
    assert instances == set(cuda_myers_large.REGISTER_WORDS)
    assert {w // 32 for w in instances} >= {1, 2, 4, 8, 12, 16}
    cases = {
        int(w): int(g) for w, g in re.findall(
            r"^\s*FLOXER_SMALL_CASE\((\d+), (\d+)\)$",
            kernel_source(cuda_myers), re.M,
        )
    }
    assert cases == cuda_myers.LANES_FOR_WORDS
    assert sorted(cases) == list(range(1, 9))
    for words, lanes in cases.items():
        assert lanes >= words and lanes & (lanes - 1) == 0
        assert lanes == 1 or lanes // 2 < words


@pytest.mark.parametrize("words", [3, 128, 640])
def test_full_myers_kernels_refuse_cpu_operands(words):
    """On the CPU myers_small and myers_large run the plain version and
    count no launch; the kernels' own entries refuse CPU tensors."""
    small = words <= 8
    args = full_myers_operands(np.random.default_rng(words), 6, words, small,
                               CPU, max_chars=300)
    before = (cuda_myers.LAUNCHES, cuda_myers_large.launches())
    entry = cuda_myers.myers_small if small else cuda_myers_large.myers_large
    dist, _ = entry(*args)
    assert (cuda_myers.LAUNCHES, cuda_myers_large.launches()) == before
    assert dist.device == CPU
    kernels = ((cuda_myers.myers_small_cuda,) if small else
               (cuda_myers_large.myers_large_register,
                cuda_myers_large.myers_large_shared))
    for kernel in kernels:
        with pytest.raises(ValueError, match="CUDA kernel|register kernel"):
            kernel(*args)


@pytest.mark.parametrize("words,small", [(1, True), (5, True), (8, True),
                                         (64, False), (512, False)])
def test_full_myers_operands_span_every_size(words, small):
    """The card tests' and chip_smoke.py's K2/K3 generator puts tasks of
    every word count (K2) or group count (K3) the width takes into one
    launch, with a dead task (m == 0), tlen 0 and 1, and garbage chars,
    reproducibly from the seed."""
    draw = [full_myers_operands(np.random.default_rng(words), 40, words,
                                small, CPU) for _ in range(2)]
    peq, plen, texts, tlen = draw[0]
    assert all(torch.equal(a, b) for a, b in zip(*draw))
    unit = 32 if small else 1024
    sizes = set((-(-plen[plen > 0] // unit)).tolist())
    assert sizes == set(range(1, -(-32 * words // unit) + 1))
    assert int(plen[0]) == 0 and tlen[1:3].tolist() == [0, 1]
    assert int(texts.max()) >= 6
    assert tuple(peq.shape) == ((words, 6, 40) if small else (40, 6, words))


# ---- the multi-warp kernels (the lockstep K1 column of
# tools/csrc/k1w_lockstep.cu and K1u's of csrc/myers_banded_cluster.cu,
# K3u's wavefront of csrc/myers_large_cluster.cu), emulated lane by lane
# and warp by warp on
# numpy int64 words masked to 32 bits

MASK = 0xFFFFFFFF
LANES = np.arange(32, dtype=np.int64)


def ballot(bits):
    """Per-lane 0/1 bits [..., 32] -> the warp's ballot masks [...]."""
    return (bits.astype(np.int64) << LANES).sum(-1)


def bits_of(mask, count):
    """Masks [...] -> bits [..., count]."""
    return (mask[..., None] >> np.arange(count, dtype=np.int64)) & 1


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 16), st.sampled_from([1, 2, 4]), st.data())
def test_warp_lookahead_and_carry_select_equal_the_word_scan(warps, R, data):
    """K1's multi-warp carry: per warp the lanes' run (G, P) give two
    ballots and the warp's (G, P); the carry into each warp is the same
    one-add lookahead over the warps' (G, P) masks; before the barrier
    each lane computes its run's carries for carry-in 0 and 1 into its
    warp, and after it selects by the warp's carry. The carry into every
    word equals the plain version's scan over the whole band."""
    states = data.draw(st.lists(st.integers(0, 2), min_size=32 * warps * R,
                                max_size=32 * warps * R))
    g, p = lane_vectors(states)
    gen = np.asarray(g, dtype=np.int64).reshape(warps, 32, R)
    prop = np.asarray(p, dtype=np.int64).reshape(warps, 32, R)
    words = np.arange(R, dtype=np.int64)
    gen_run = (gen << words).sum(-1)
    prop_run = (prop << words).sum(-1)
    any_run = gen_run | prop_run
    gm = ballot(((any_run + gen_run) >> R) != 0)
    pm = ballot(prop_run == (1 << R) - 1)
    any_ = gm | pm
    warp_g = (any_ + gm) >> 32
    warp_p = (pm == MASK).astype(np.int64)
    warp_carries = cuda_myers_banded._ballot_carries(
        mask_of(warp_g.tolist()), mask_of(warp_p.tolist())
    )
    runs = []
    for cin in (0, 1):
        lanes_in = bits_of(((any_ + gm + cin) ^ any_ ^ gm) & MASK, 32)
        runs.append((any_run + gen_run + lanes_in) ^ any_run ^ gen_run)
    cin_w = bits_of(np.asarray(warp_carries), warps)[:, None]
    chosen = np.where(cin_w != 0, runs[1], runs[0])
    got = bits_of(chosen, R).reshape(-1).tolist()
    assert got == word_scan(g, p)


def emulate_banded_wide(args, warps, R, blocks=1):
    """The multi-warp K1 column with its warps in lockstep on K1's operands
    (numpy, as myers_banded takes them) at `warps` warps of 32 lanes with R
    words each: tools/csrc/k1w_lockstep.cu's column (the routed one-block
    kernel's schedule is tests/test_torch_wide_exchange.py's mirror): per
    column the in-warp steps, the (G, P) words and the top bits each
    warp publishes, the carry into each warp from the warps' masks, the
    heads lane 31 takes from the warp above; the sliding and frozen columns
    and the scores as the kernel runs them. Tasks run together, each masked
    to its own columns. With blocks > 1 it is csrc/myers_banded_cluster.cu's
    kernel on a cluster of `blocks` blocks of ceil(warps / blocks) warps:
    each warp pushes one word into every block's copy, with the top bits of
    its last word for either carry into it, and after the one barrier
    reads only its own block's: the carries into itself and the warp below
    (the lookahead over 32-warp words chained by their carries), the warp
    below's top bits for its carry, the warp above's slide bits."""
    vp0, planes0, texts_packed, stream_packed, scalars, band_words, _ = args
    assert band_words == 32 * warps * R
    T = vp0.shape[0]
    shape = (T, warps, 32, R)
    block_warps = -(-warps // blocks)
    assert -(-warps // block_warps) == blocks  # no block is idle throughout
    block_of = np.arange(warps) // block_warps
    cluster = blocks > 1

    def unsigned(a):
        return a.astype(np.int64) & MASK

    vp = unsigned(vp0).reshape(shape)
    vn = np.zeros(shape, dtype=np.int64)
    p0, p1, p2, am = (unsigned(planes0[:, i]).reshape(shape) for i in range(4))
    texts, stream = unsigned(texts_packed), unsigned(stream_packed)
    sc = scalars.astype(np.int64)
    tlen, jstar, topshift = sc[:, 0], sc[:, 1], sc[:, 2]
    mfrozen, m, k = (sc[:, 3] != 0).astype(np.int64), sc[:, 4], sc[:, 5]
    num_words = texts.shape[1]
    last_col = np.minimum(tlen - 1, num_words * 8)
    slide_end = np.minimum(jstar, last_col)
    s_bot, s_m, best = k.copy(), m.copy(), m.copy()
    best_end = np.zeros(T, dtype=np.int64)
    words = np.arange(R, dtype=np.int64)
    warp_ids = np.arange(warps, dtype=np.int64)

    def head_bits(vp_, vn_, p0_, p1_, p2_, am_):
        return ((vp_ & 1) | ((vn_ & 1) << 1) | ((p0_ & 1) << 2)
                | ((p1_ & 1) << 3) | ((p2_ & 1) << 4) | ((am_ & 1) << 5))

    # lane 31's head: the initial word 0 of the warp above
    head = np.zeros((T, warps), dtype=np.int64)
    head[:, :-1] = head_bits(vp[:, 1:, 0, 0], 0, p0[:, 1:, 0, 0],
                             p1[:, 1:, 0, 0], p2[:, 1:, 0, 0], am[:, 1:, 0, 0])

    def slide(x, entering):
        nxt = np.concatenate([x[..., 1:] & 1, (entering & 1)[..., None]], -1)
        return (x >> 1) | (nxt << 31)

    for col in range(1, int(last_col.max(initial=0)) + 1):
        j = col - 1
        live = col <= last_col
        sliding = live & (col <= slide_end)
        tch = (texts[:, j >> 3] >> (4 * (j & 7))) & 0xF
        pch = (stream[:, j >> 3] >> (4 * (j & 7))) & 0xF
        old = (vp, vn, p0, p1, p2, am)

        # 1) slide; the top warp's lane 31 takes the pattern char
        head[:, -1] = 1 | ((pch & 7) << 2)
        nxt = np.roll(head_bits(*(x[..., 0] for x in old)), -1, axis=2)
        nxt[:, :, 31] = head
        slid = [slide(x, nxt >> shift) for shift, x in enumerate(old)]
        sl = sliding[:, None, None, None]
        vp, vn, p0, p1, p2, am = (np.where(sl, s, x) for s, x in zip(slid, old))

        # 2) Eq, the adds, the runs' and the warps' (G, P), both carry-ins
        planes = [np.where((tch & bit)[:, None, None, None] != 0, 0, MASK)
                  for bit in (1, 2, 4)]
        eq = ((p0 ^ planes[0]) & (p1 ^ planes[1]) & (p2 ^ planes[2])) | am
        a = eq & vp
        t = (a + vp) & MASK
        gen_run = (((a + vp) >> 32) << words).sum(-1)
        prop_run = ((t == MASK).astype(np.int64) << words).sum(-1)
        any_run = gen_run | prop_run
        gm = ballot(((any_run + gen_run) >> R) != 0)
        pm = ballot(prop_run == (1 << R) - 1)
        any_ = gm | pm
        runs = [
            (any_run + gen_run + bits_of(((any_ + gm + c) ^ any_ ^ gm) & MASK, 32))
            ^ any_run ^ gen_run
            for c in (0, 1)
        ]
        low = (((any_ + gm) >> 32) | ((pm == MASK).astype(np.int64) << 1)
               | (((eq[:, :, 0, 0] | vn[:, :, 0, 0]) & 1) << 2)
               | (head_bits(0, 0, p0[:, :, 0, 0], p1[:, :, 0, 0],
                            p2[:, :, 0, 0], am[:, :, 0, 0]) << 1))
        if cluster:
            # lane 31's top bits of its last word for either carry into
            # the warp, in the warp's word
            for c, at in ((0, 7), (1, 9)):
                last = ((runs[c][..., 31] >> (R - 1)) & 1)
                xh_l = ((((t[..., 31, R - 1] + last) & MASK)
                         ^ vp[..., 31, R - 1]) | eq[..., 31, R - 1])
                ph_l = vn[..., 31, R - 1] | ((xh_l | vp[..., 31, R - 1]) ^ MASK)
                mh_l = vp[..., 31, R - 1] & xh_l
                low = low | (((ph_l >> 31) | ((mh_l >> 31) << 1)) << at)

        # 3) after the barrier: the carries into every warp from each
        # block's copy of the warps' words, the deltas
        copies = np.repeat(low[:, None, :], blocks, axis=1)  # [T, C, W]
        seen_cin = np.zeros((T, blocks, warps), dtype=np.int64)
        for i in range(T):
            for b in range(blocks):
                seen = copies[i, b]
                carries = cuda_myers_large._chained_ballot_carries(
                    [mask_of((seen[q:q + 32] & 1).tolist())
                     for q in range(0, warps, 32)],
                    [mask_of(((seen[q:q + 32] >> 1) & 1).tolist())
                     for q in range(0, warps, 32)],
                )
                w = np.arange(warps)
                seen_cin[i, b] = (np.asarray(carries, dtype=np.int64)[w >> 5]
                                  >> (w & 31)) & 1
        # warp g reads its own block's copy: its carry, the warp below's
        cin = seen_cin[:, block_of, warp_ids]
        cin_below = seen_cin[:, block_of, np.maximum(warp_ids - 1, 0)]
        runs_in = np.where(cin[..., None] != 0, runs[1], runs[0])
        carry = (runs_in[..., None] >> words) & 1
        xh = (((t + carry) & MASK) ^ vp) | eq
        ph, mh = vn | ((xh | vp) ^ MASK), vp & xh
        xv = eq | vn
        top = (ph[..., R - 1] >> 31) | ((mh[..., R - 1] >> 31) << 1)
        # 4) the shift (after the one-block kernel's second barrier); lane 0
        # takes the warp below's top bits: in the cluster from the word it
        # published, for the carry into it
        pessim = np.where(sliding, col >= topshift, mfrozen).astype(np.int64)
        below = np.empty((T, warps), dtype=np.int64)
        if cluster:
            published = copies[:, block_of, np.maximum(warp_ids - 1, 0)]
            below[:] = (published >> np.where(cin_below != 0, 9, 7)) & 3
        else:
            below[:, 1:] = top[:, :-1, 31]
        below[:, 0] = pessim
        hcarry = np.roll(top, 1, axis=2)
        hcarry[:, :, 0] = below
        ph_sh = ((ph << 1) & MASK) | np.concatenate(
            [(hcarry & 1)[..., None], ph[..., :-1] >> 31], -1)
        mh_sh = ((mh << 1) & MASK) | np.concatenate(
            [(hcarry >> 1)[..., None], mh[..., :-1] >> 31], -1)
        new_vp = mh_sh | ((xv | ph_sh) ^ MASK)
        new_vn = ph_sh & xv
        lv = live[:, None, None, None]
        vp, vn = np.where(lv, new_vp, vp), np.where(lv, new_vn, vn)
        # 5) lane 31's next head from the warp above's published word, in
        # its own block's copy
        above = copies[:, block_of, np.minimum(warp_ids + 1, warps - 1)]
        top31 = top[:, :, 31]
        ph_t, mh_t, xv_a = top31 & 1, top31 >> 1, (above >> 2) & 1
        next_head = (((mh_t | ((xv_a | ph_t) ^ 1)) & 1) | ((ph_t & xv_a) << 1)
                     | (((above >> 3) & 15) << 2))
        head = np.where(sliding[:, None], next_head, head)
        # 6) the scores of the top warp's lane 31
        d = (top31[:, -1] & 1) - (top31[:, -1] >> 1)
        frozen = live & ~sliding
        s_bot = np.where(sliding, s_bot + 1 + d, s_bot)
        s_m = np.where(frozen, s_m + d, s_m)
        improves = frozen & (s_m <= best)
        best = np.where(improves, s_m, best)
        best_end = np.where(improves, col, best_end)
        turn = (col == slide_end) & (slide_end >= 1) & (slide_end == jstar)
        s_m = np.where(turn, s_bot, s_m)
        improves = turn & (s_m <= best)
        best = np.where(improves, s_m, best)
        best_end = np.where(improves, jstar, best_end)
    return best, best_end


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("warps,R", [(2, 1), (4, 1), (2, 2), (3, 2), (4, 2)])
def test_banded_wide_emulation_equals_plain(warps, R, seed):
    """The multi-warp K1 column (slide with the heads from the warp above,
    the warps' carry lookahead, the shift with the top bits from the warp
    below, the scores of the top warp) emulated lane by lane equals
    myers_banded_plain on two seeds' tasks, tlen 0 and 1 among them, some
    with chars 6..15 in their texts."""
    check_banded_emulation(warps, R, seed)


@pytest.mark.parametrize("blocks,warps,R,deep", [
    (2, 2, 1, False), (2, 3, 2, False), (3, 5, 1, False), (2, 2, 1, True),
    (3, 5, 1, True), (4, 4, 2, True), (4, 8, 1, True),
])
def test_banded_cluster_emulation_equals_plain(blocks, warps, R, deep):
    """K1u's column across a cluster (csrc/myers_banded_cluster.cu): each
    warp's word pushed into every block and read there for the lookahead
    and the slide's head bits from the warp above, the top bits pushed
    into the block of the warp above, the top block's scores; 2-4 blocks
    of 1-2 warps, the last block's spare warp idle, emulated lane by lane
    and block by block, equal to myers_banded_plain (on deep bands, whose
    pattern rows reach every warp from the first column, too)."""
    check_banded_emulation(warps, R, 0, blocks, deep)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2), min_size=1, max_size=128))
def test_cluster_lookahead_equals_the_word_scan(states):
    """K1u's carry into each of up to 128 warps (csrc/myers_banded_cluster.cu
    warp_carry<Q>): the warps' (G, P) bits in Q = ceil(W / 32) ballot
    words, one lookahead add each, each word's carry out into the next,
    equal the plain version's scan over the warps."""
    g, p = lane_vectors(states)
    carries = cuda_myers_large._chained_ballot_carries(
        [mask_of(g[q:q + 32]) for q in range(0, len(states), 32)],
        [mask_of(p[q:q + 32]) for q in range(0, len(states), 32)],
    )
    got = [(carries[w >> 5] >> (w & 31)) & 1 for w in range(len(states))]
    assert got == word_scan(g, p)


def check_banded_emulation(warps, R, seed, blocks=1, deep=False):
    """emulate_banded_wide at (warps, R, blocks) on seeded band_cases (or
    deep_band_cases of up to 1500 columns) equals myers_banded_plain, tlen
    0 and 1 and chars 6..15 among the tasks."""
    band_words = 32 * warps * R
    rng = np.random.default_rng(band_words + warps + 97 * seed)
    if deep:
        patterns, texts, budgets = cuda_myers_banded.deep_band_cases(
            rng, 12, band_words, 1500)
    else:
        patterns, texts, budgets = cuda_myers_banded.band_cases(
            rng, 12, band_words)
    texts[3] = texts[3].copy()
    texts[3][::5] = 9  # garbage chars in at least one task
    txt, tlen = pad_batch(texts)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, budgets, band_words, CPU
    )
    operands[4][0, cuda_myers_banded.COL_TLEN] = 0
    operands[4][1, cuda_myers_banded.COL_TLEN] = 1
    want = cuda_myers_banded.myers_banded_plain(*operands, band_words, num_text)
    got = emulate_banded_wide(
        (*(t.numpy() for t in operands), band_words, num_text), warps, R,
        blocks,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert int(want[1][0]) == 0 and int(want[0][0]) == int(operands[4][0, 4])


def emulate_large_wide(args, warps, R, blocks=1):
    """csrc/myers_large_cluster.cu's wavefront (K3u, which myers_large runs
    past the register kernel's widest) on K3's operands (numpy) at `warps`
    warps of R groups of 32 words on a cluster of `blocks` blocks of
    ceil(warps / blocks) warps (one block: the whole wavefront on one
    SM): each task runs its ceil(m / 1024) groups on ceil(groups / R)
    warps; at step s warp w runs chunk s - w of 32 columns, reading the
    carry out and lane 31's top bits the warp below published for that
    chunk at step s - 1 (ring slot (s - 1) & 1) and publishing its own
    (slot s & 1) into the ring of the block that holds the warp above,
    indexed by that warp's place there; each block holds its own words'
    Peq rows; the top warp keeps the score. All warps of a step run at
    once, as the barrier between steps allows."""
    peq, plen, texts, tlen = (a.astype(np.int64) for a in args)
    peq &= MASK
    B, _, Wp = peq.shape
    N = texts.shape[1]
    assert Wp == 32 * warps * R
    block_warps = -(-warps // blocks)
    block_of = np.arange(warps) // block_warps
    local_of = np.arange(warps) % block_warps
    stride = 32 * R * block_warps  # words a block holds
    # each block's Peq rows by its words [B, C, 7, stride] with the zero
    # row 6 (past Wp: zero words)
    padded = np.zeros((B, 7, stride * blocks), dtype=np.int64)
    padded[:, :6, :Wp] = peq
    block_rows = padded.reshape(B, 7, blocks, stride).transpose(0, 2, 1, 3)
    ncols = np.maximum(np.minimum(tlen - 1, N), 0)
    msb_word = np.floor_divide(plen - 1, 32)
    dead = (msb_word < 0) | (msb_word >= Wp)
    groups = np.where(dead, 1, (msb_word >> 5) + 1)
    active = -(-groups // R)
    my_groups = np.clip(groups[:, None] - R * np.arange(warps), 0, R)
    chunks = -(-ncols // 32)
    steps = chunks + active - 1
    word = (32 * (R * np.arange(warps)[:, None] + np.arange(R))[..., None]
            + LANES)  # [W, R, 32]
    vp = np.where(word[None] <= msb_word[:, None, None, None], MASK, 0)
    vn = np.zeros_like(vp)
    score, best = plen.copy(), plen.copy()
    best_end = np.zeros(B, dtype=np.int64)
    ring = np.zeros((2, B, blocks, block_warps, 32), dtype=np.int64)
    top_warp = active - 1
    last_group = my_groups[np.arange(B), top_warp] - 1
    msb_lane, msb_bit = msb_word & 31, (plen - 1) & 31
    wi = np.arange(warps)
    for step in range(int(steps.max(initial=0))):
        chunk = np.tile(step - wi, (B, 1))  # [B, W]
        runs = (chunk >= 0) & (chunk < chunks[:, None]) & (wi < active[:, None])
        # warp g's slots in its own block (warp 0's stay unread)
        from_below = ring[(step - 1) & 1][:, block_of, local_of]
        from_below[:, 0] = 0
        for q in range(32):
            col = 32 * chunk + q
            live = runs & (col < ncols[:, None])
            c = np.take_along_axis(texts, np.clip(col, 0, N - 1), 1)
            c = np.where((col < N) & (c < 6), c, 6)
            # each warp's char's row in its own block's Peq [B, W, stride]
            eq = block_rows[np.arange(B)[:, None], block_of[None, :], c]
            local_word = word - (stride * block_of)[:, None, None]
            eq = np.take_along_axis(eq, np.broadcast_to(
                local_word.reshape(1, warps, -1), (B, warps, 32 * R)
            ), 2).reshape(vp.shape)
            a = eq & vp
            t = (a + vp) & MASK
            gm, pm = ballot((a + vp) >> 32), ballot(t == MASK)  # [B, W, R]
            cin = from_below[:, :, q] & 1
            carry = np.zeros_like(vp)
            couts = np.zeros((B, warps, R), dtype=np.int64)
            for i in range(R):
                any_ = gm[..., i] | pm[..., i]
                total = any_ + gm[..., i] + cin
                carry[:, :, i] = bits_of(((total ^ any_ ^ gm[..., i]) & MASK), 32)
                cin = total >> 32
                couts[..., i] = cin
            xh = (((t + carry) & MASK) ^ vp) | eq
            ph, mh = vn | ((xh | vp) ^ MASK), vp & xh
            xv = eq | vn
            top = (ph >> 31) | ((mh >> 31) << 1)
            rotated = np.roll(top, 1, axis=3)  # lane l: lane l - 1's
            below = np.concatenate(
                [(from_below[:, :, q] >> 1)[:, :, None], rotated[:, :, :-1, 0]], 2
            )
            rotated[..., 0] = below
            ph_sh = ((ph << 1) & MASK) | (rotated & 1)
            mh_sh = ((mh << 1) & MASK) | (rotated >> 1)
            lv = live[:, :, None, None]
            vp = np.where(lv, mh_sh | ((xv | ph_sh) ^ MASK), vp)
            vn = np.where(lv, ph_sh & xv, vn)
            # publish: the carry out of the warp's last group and its lane
            # 31's top bits (every warp but the top one)
            last = np.clip(my_groups - 1, 0, R - 1)
            cout = np.take_along_axis(couts, last[..., None], 2)[..., 0]
            top31 = np.take_along_axis(top[..., 31], last[..., None], 2)[..., 0]
            # pushed into the ring of the warp above, in its block
            publish = live & (wi < top_warp[:, None])
            slots = ring[step & 1][:, block_of[1:], local_of[1:], q]
            ring[step & 1][:, block_of[1:], local_of[1:], q] = np.where(
                publish[:, :-1], (cout | (top31 << 1))[:, :-1], slots
            )
            # the score in the top warp's lane that owns row m
            tw = np.arange(B), top_warp
            bits_ph = (ph[tw][np.arange(B), last_group, msb_lane] >> msb_bit) & 1
            bits_mh = (mh[tw][np.arange(B), last_group, msb_lane] >> msb_bit) & 1
            scored = live[tw] & ~dead
            score = np.where(scored, score + bits_ph - bits_mh, score)
            improves = scored & (score <= best)
            best = np.where(improves, score, best)
            best_end = np.where(improves, col[tw] + 1, best_end)
    best_end = np.where(dead, ncols, best_end)
    return np.where(dead, plen, best), best_end


@pytest.mark.parametrize("warps,R", [(2, 1), (3, 1), (2, 2), (4, 2)])
def test_large_wide_wavefront_emulation_equals_plain(warps, R):
    """K3u's skewed wavefront on one block (each task on its own groups'
    warps, chunks of 32 columns a step behind the warp below, the carry
    out and top bits through a two-slot ring, the top warp's score)
    emulated lane by lane equals myers_large_plain on seeded tasks of
    every group count, with m == 0, tlen 0 and 1 and chars 6..15 among
    them."""
    words = 32 * warps * R
    args = full_myers_operands(np.random.default_rng(words + R), 3 * warps * R,
                               words, False, CPU)
    want = cuda_myers_large.myers_large_plain(*args)
    got = emulate_large_wide([t.numpy() for t in args], warps, R)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("blocks,warps,R", [(2, 2, 1), (3, 3, 1), (2, 3, 2),
                                            (3, 5, 1)])
def test_large_cluster_wavefront_emulation_equals_plain(blocks, warps, R):
    """K3u's wavefront across a cluster (csrc/myers_large_cluster.cu): each
    block's Peq rows of its own words, a warp's carry out and top bits
    pushed into the ring of the block that holds the warp above, one
    barrier a step over the cluster; 2-3 blocks of 1-2 warps, the last
    block's spare warp idle, emulated lane by lane and block by block on
    tasks of every group count, with m == 0, tlen 0 and 1 and chars 6..15
    among them, equal to myers_large_plain."""
    words = 32 * warps * R
    args = full_myers_operands(np.random.default_rng(words + R + blocks),
                               3 * warps * R, words, False, CPU)
    want = cuda_myers_large.myers_large_plain(*args)
    got = emulate_large_wide([t.numpy() for t in args], warps, R, blocks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_banded_plain_past_2048_words_equals_the_reference_oracle():
    """myers_banded_plain at 2176 band words, the narrowest band the cluster
    kernel takes (the card kernels are held to it there), equals the JAX
    package's own banded oracle myers_banded_np at the same band store on
    2 tasks of about 200 columns (substitutions; then an insertion and a
    deletion besides)."""
    band_words = cuda_myers_banded.CLUSTER_BAND_WORDS[0]
    assert band_words == 2176
    rng = np.random.default_rng(2176)
    patterns, texts, budgets = [], [], []
    for indels in (False, True):
        text = rng.integers(1, 5, size=200).astype(np.uint8)
        pattern = text[20:190].copy()
        pattern[::13] = 1 + (pattern[::13] % 4)
        if indels:
            pattern = np.insert(np.delete(pattern, 40), 120, 3)
        patterns.append(pattern)
        texts.append(text)
        budgets.append(60)
    txt, tlen = pad_batch(texts)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, np.asarray(budgets), band_words, CPU
    )
    dist, end = cuda_myers_banded.myers_banded_plain(*operands, band_words,
                                                     num_text)
    for i, (pattern, text, budget) in enumerate(zip(patterns, texts,
                                                    budgets)):
        want = myers_banded_np(pattern, text, budget, b_store=32 * band_words)
        assert (int(dist[i]), int(end[i])) == want
        assert int(dist[i]) <= budget


def test_wide_instances_are_the_kernel_sources():
    """WIDE_WARPS, WIDE_TILE_WORDS and WIDE_MAX_WORDS are
    csrc/myers_banded_wide.cu's kWarps, kTileWords and kMaxBandWords (a
    tile a word a lane of its warps); WIDE_BAND_WORDS holds every 128-word
    tile from past the register kernel's widest to 2048, each a width the
    kernel takes (5 to 16 words a lane). K3 has no multi-warp one-block
    kernel: myers_large routes 544 words on to the cluster kernel, whose
    widest, block warps and cluster sizes are csrc/myers_large_cluster.cu's
    constants as K1u's are csrc/myers_banded_cluster.cu's;
    CLUSTER_BAND_WORDS holds every 128-word tile from 2176 to past F3's
    6528 words (the widest 16384), and each pick of blocks holds its
    width, K3u's for 1 to 264 tasks on 132 SMs too."""
    root = Path(__file__).resolve().parent.parent / "floxer_tpu_torch" / "csrc"

    def constant(source, name):
        found = re.findall(rf"^constexpr int {name} = (\d+);$",
                           (root / source).read_text(), re.M)
        assert len(found) == 1, (source, name)
        return int(found[0])

    k1 = cuda_myers_banded
    assert constant("myers_banded_wide.cu", "kWarps") == k1.WIDE_WARPS
    assert re.search(r"^constexpr int kTileWords = 32 \* kWarps;$",
                     (root / "myers_banded_wide.cu").read_text(), re.M)
    assert k1.WIDE_TILE_WORDS == 32 * k1.WIDE_WARPS == 128
    assert (constant("myers_banded_wide.cu", "kMaxBandWords")
            == k1.WIDE_MAX_WORDS)
    assert k1.WIDE_BAND_WORDS == tuple(range(640, 2049, 128))
    assert all(bw % k1.WIDE_TILE_WORDS == 0
               and 5 <= bw // k1.WIDE_TILE_WORDS <= 16
               for bw in k1.WIDE_BAND_WORDS)
    assert not (root / "myers_large_wide.cu").exists()
    assert cuda_myers_large.REGISTER_WORDS[-1] + 32 == 544
    assert not hasattr(cuda_myers_large, "myers_large_wide")
    k3 = cuda_myers_large
    for source, module, widest in (
        ("myers_banded_cluster.cu", k1, k1.CLUSTER_MAX_WORDS),
        ("myers_large_cluster.cu", k3, k3.CLUSTER_WORDS),
    ):
        assert constant(source, "kBlockWarps") == module.CLUSTER_BLOCK_WARPS
        assert constant(source, "kMaxBlocks") == module.CLUSTER_MAX_BLOCKS
        assert constant(source, "kMaxBandWords" if module is k1
                        else "kMaxWords") == widest
        assert widest == (32 * 4 * module.CLUSTER_BLOCK_WARPS
                          * module.CLUSTER_MAX_BLOCKS)
    R = k1.CLUSTER_WORDS_PER_LANE
    assert constant("myers_banded_cluster.cu", "kWordsPerLane") == R
    assert constant("myers_large_cluster.cu", "kGroupsPerWarp") == 4
    assert k1.CLUSTER_BAND_WORDS == tuple(range(2176, 16385, 128))
    assert 6528 in k1.CLUSTER_BAND_WORDS and k3.CLUSTER_WORDS >= 8192
    for words in k1.CLUSTER_BAND_WORDS:
        warps = words // (32 * R)
        blocks = k1.cluster_blocks(words)
        assert blocks <= k1.CLUSTER_MAX_BLOCKS
        assert -(-warps // blocks) <= k1.CLUSTER_BLOCK_WARPS
        assert k3.cluster_blocks(words) == blocks
    for words in range(544, k3.CLUSTER_WORDS + 1, 32):
        warps = -(-words // 128)
        for tasks in (1, 8, 64, 132, 264, 10_000):
            blocks = k3.cluster_blocks(words, tasks, 132)
            assert 1 <= blocks <= k3.cluster_blocks(words)
            assert -(-warps // blocks) <= k3.CLUSTER_BLOCK_WARPS


@pytest.mark.parametrize("words,tasks,blocks", [
    (544, 8, 2), (544, 64, 2), (544, 264, 1), (768, 64, 2), (1280, 8, 3),
    (1280, 64, 2), (1280, 264, 1), (2048, 8, 4), (2048, 64, 2),
    (2048, 264, 1), (3200, 8, 7), (8192, 132, 4),
])
def test_large_cluster_pick_follows_the_tasks(words, tasks, blocks):
    """K3u's blocks a task on a card of 132 SMs: about four warps a block
    while the launch's clusters fit the SMs a block each (the layouts
    that won in turns at 544-2048 words: tools/k1_bench.py
    --large-layouts), else the most that fit, never fewer than hold the
    width (8192 words: 4 blocks of 16 warps)."""
    assert cuda_myers_large.cluster_blocks(words, tasks, 132) == blocks


@pytest.mark.parametrize("band_words", [1024, 2176])
def test_wide_and_past_wide_bands_refuse_cpu_operands(band_words):
    """On the CPU myers_banded runs the plain version at a multi-warp width
    and past it, counting no launch; the multi-warp wrapper refuses CPU
    tensors, a width past 2048 words and one that is not a multiple of
    128 words."""
    patterns, texts, budgets = banded_cases(5, count=3)
    txt, tlen = pad_batch(texts)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, np.asarray(budgets), band_words, CPU
    )
    before = cuda_myers_banded.launches()
    dist, _ = cuda_myers_banded.myers_banded(*operands, band_words, num_text)
    assert cuda_myers_banded.launches() == before and dist.device == CPU
    with pytest.raises(ValueError, match="CUDA kernel|multi-warp"):
        cuda_myers_banded.myers_banded_wide(*operands, band_words, num_text)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, np.asarray(budgets), band_words - 32, CPU
    )
    with pytest.raises(ValueError, match="multi-warp"):
        cuda_myers_banded.myers_banded_wide(*operands, band_words - 32,
                                            num_text)


@pytest.mark.parametrize("band_words", [2176, 6528, 16384])
def test_cluster_bands_refuse_cpu_operands(band_words):
    """On the CPU myers_banded runs the plain version at a cluster width,
    counting no launch; the cluster wrappers refuse CPU tensors, a width
    past their widest or off their tiles, and a cluster that cannot hold
    the width."""
    patterns, texts, budgets = banded_cases(6, count=2)
    txt, tlen = pad_batch(texts)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, np.asarray(budgets), band_words, CPU
    )
    before = cuda_myers_banded.launches()
    dist, _ = cuda_myers_banded.myers_banded(*operands, band_words, num_text)
    assert cuda_myers_banded.launches() == before and dist.device == CPU
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_myers_banded.myers_banded_cluster(*operands, band_words,
                                               num_text)
    with pytest.raises(ValueError, match="cannot hold"):
        cuda_myers_banded.myers_banded_cluster(*operands, band_words,
                                               num_text, blocks=1)
    for wrong in (band_words + 32, 16384 + 128):
        with pytest.raises(ValueError, match="cluster kernel takes"):
            cuda_myers_banded.myers_banded_cluster(
                *operands[:2], *operands[2:], wrong, num_text)
    args = full_myers_operands(np.random.default_rng(band_words), 6, 32,
                               False, CPU)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_myers_large.myers_large_cluster(*args)
    with pytest.raises(ValueError, match="cannot hold"):
        cuda_myers_large.myers_large_cluster(*args, blocks=9)


@pytest.mark.parametrize("words,count", [(544, 12), (2048, 12)])
def test_spread_operands_reach_the_widest_group(words, count):
    """full_myers_operands(spread=True) spreads K3's tasks from the first
    groups to the width's last (task 0 keeps m == 0), so a dozen tasks
    reach every warp of the multi-warp kernel; without spread the same
    count stops short."""
    args = full_myers_operands(np.random.default_rng(words), count, words,
                               False, CPU, spread=True)
    plen = args[1].numpy()
    groups = -(-plen[1:] // 1024)
    assert groups[0] <= -(-words // 32 // (count - 1)) + 1
    assert groups[-1] == words // 32 and np.all(np.diff(groups) >= 0)
    cycled = full_myers_operands(np.random.default_rng(words), count, words,
                                 False, CPU)[1].numpy()
    assert -(-cycled.max() // 1024) < words // 32
