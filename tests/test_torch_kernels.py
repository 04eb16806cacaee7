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
from floxer_tpu.ops.myers_banded import band_store_bits
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
