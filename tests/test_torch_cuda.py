"""floxer_tpu_torch on the card: each CUDA kernel (K1-K13l) against its
plain PyTorch version, a fused wave on the card against the same wave on the
CPU, and the CLI's --engine device (and --device-search) against the host
engine.

Every test here needs a CUDA device and skips without one. The module
imports no jax (the GPU machine has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from floxer_tpu_torch.cli import parse_and_validate
from floxer_tpu_torch import pipeline
from floxer_tpu_torch.ops import cuda_myers, cuda_myers_banded, cuda_myers_large
from floxer_tpu_torch.ops.cuda_myers import myers_small_host
from floxer_tpu_torch.ops.cuda_myers_banded import band_cases, myers_banded_host
from floxer_tpu_torch.ops.cuda_myers_large import myers_large_host
from floxer_tpu_torch.ops.fused_verify import FusedBatch
from floxer_tpu_torch.ops.myers import full_myers_operands
from floxer_tpu_torch.ops.resident import ResidentBank
from floxer_tpu_torch.scripts import (
    ablate_banded_kernel,
    microbench_carry_scaling,
    microbench_column_loop,
)
from test_e2e import check_output_records, parse_sam

DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def cases(rng, count, m_lo, m_hi, garbage_every=0):
    """A text and a mutated slice of it per task; garbage_every > 0 puts
    chars 6..15 into the texts, as fused windows carry past their end."""
    patterns, texts = [], []
    for _ in range(count):
        m = int(rng.integers(m_lo, m_hi))
        n = int(rng.integers(m, m + 2 * (m // 10) + 60))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, max(1, n - m)))
        pattern = text[start : start + m].copy()
        for _ in range(int(rng.integers(0, m // 12 + 2))):
            pos = int(rng.integers(0, len(pattern)))
            pattern[pos] = 1 + (pattern[pos] % 4)
        if garbage_every:
            text[::garbage_every] = rng.integers(
                6, 16, size=len(text[::garbage_every])
            )
        patterns.append(pattern)
        texts.append(text)
    return patterns, texts


def pad(seqs):
    out = np.zeros((len(seqs), max(len(s) for s in seqs)), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, np.asarray([len(s) for s in seqs], dtype=np.int32)


@pytest.mark.parametrize("band_words", [128, 256])
def test_banded_kernel_matches_plain(cuda_device, band_words):
    rng = np.random.default_rng(band_words)
    patterns, texts = cases(rng, 96, 60, 2000)
    budgets = np.asarray([max(1, len(p) // 10) for p in patterns])
    txt, tlen = pad(texts)
    launches = cuda_myers_banded.launches()
    got = myers_banded_host(patterns, txt, tlen, budgets, band_words, cuda_device)
    assert cuda_myers_banded.launches() == launches + 1
    want = myers_banded_host(patterns, txt, tlen, budgets, band_words, CPU)
    np.testing.assert_array_equal(got, want)


def band_args(rng, band_words, device, count=48):
    patterns, texts, budgets = band_cases(rng, count, band_words)
    txt, tlen = pad(texts)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, budgets, band_words, device
    )
    return (*operands, band_words, num_text)


def k1_counts():
    return (cuda_myers_banded.REGISTER_LAUNCHES,
            cuda_myers_banded.WIDE_LAUNCHES,
            cuda_myers_banded.CLUSTER_LAUNCHES,
            cuda_myers_banded.SHARED_LAUNCHES)


def zero_k1_counts():
    cuda_myers_banded.REGISTER_LAUNCHES = 0
    cuda_myers_banded.WIDE_LAUNCHES = 0
    cuda_myers_banded.CLUSTER_LAUNCHES = 0
    cuda_myers_banded.SHARED_LAUNCHES = 0


@pytest.mark.parametrize("band_words", cuda_myers_banded.REGISTER_BAND_WORDS)
def test_register_kernel_matches_plain_and_shared(cuda_device, band_words):
    """K1's register kernel at each instantiated width equals the plain
    version and the shared-memory kernel on the same operands, and
    myers_banded routes the width to it."""
    args = band_args(np.random.default_rng(band_words + 7), band_words,
                     cuda_device)
    before = k1_counts()
    register = cuda_myers_banded.myers_banded_register(*args)
    shared = cuda_myers_banded.myers_banded_shared(*args)
    routed = cuda_myers_banded.myers_banded(*args)
    assert k1_counts() == (before[0] + 2, *before[1:3], before[3] + 1)
    plain = cuda_myers_banded.myers_banded_plain(
        *(t.cpu() for t in args[:5]), *args[5:]
    )
    for want, *got in zip(plain, register, shared, routed):
        for tensor in got:
            assert torch.equal(tensor.cpu(), want)


def test_wide_band_runs_the_shared_kernel(cuda_device):
    """No routed band reaches the shared-memory kernel past the new
    widest any more (the cluster kernel takes every 128-word tile up to
    16384 words, past the shared kernel's limit): its entry point runs a
    2176-word band directly, equal to the plain version, and the register
    kernels refuse that band."""
    args = band_args(np.random.default_rng(640), 2176, cuda_device, count=24)
    before = k1_counts()
    got = cuda_myers_banded.myers_banded_shared(*args)
    assert k1_counts() == (*before[:3], before[3] + 1)
    plain = cuda_myers_banded.myers_banded_plain(
        *(t.cpu() for t in args[:5]), *args[5:]
    )
    for g, w in zip(got, plain):
        assert torch.equal(g.cpu(), w)
    for kernel in (cuda_myers_banded.myers_banded_register,
                   cuda_myers_banded.myers_banded_wide):
        with pytest.raises(ValueError):
            kernel(*args)


# the task counts the multi-warp kernels are held to their plain versions
# at: one task, a launch of a few, a full one (pass E's timing shape)
WIDE_TASKS = (1, 7, 64)


def wide_band_args(rng, band_words, device, tasks):
    """`tasks` K1 tasks at band_words: deep bands of up to 1500 columns
    whose rows reach every warp from the first column (deep_band_cases)
    and band_cases' shape in turn, tlen 0 and 1 among a launch of more
    than two."""
    deep = cuda_myers_banded.deep_band_cases(rng, -(-tasks // 2), band_words,
                                             1500)
    more = band_cases(rng, tasks // 2, band_words)
    patterns = [p for pair in zip(deep[0], more[0]) for p in pair]
    texts = [t for pair in zip(deep[1], more[1]) for t in pair]
    budgets = [b for pair in zip(deep[2], more[2]) for b in pair]
    if len(patterns) < tasks:
        patterns.append(deep[0][-1])
        texts.append(deep[1][-1])
        budgets.append(deep[2][-1])
    txt, tlen = pad(texts)
    if tasks > 2:
        tlen[0], tlen[1] = 0, 1
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, np.asarray(budgets), band_words, device
    )
    return (*operands, band_words, num_text)


@pytest.mark.parametrize("band_words", [128, 256, 384,
                                        *cuda_myers_banded.WIDE_BAND_WORDS])
def test_banded_wide_kernel_matches_plain(cuda_device, band_words):
    """K1's multi-warp kernel through its explicit entry at one to three
    words a lane (128-384 words) and at every routed 128-word tile
    (640-2048), at 1, 7 and 64 tasks: equal to the plain version, one
    launch counted each."""
    rng = np.random.default_rng(band_words + 4)
    for tasks in WIDE_TASKS:
        args = wide_band_args(rng, band_words, cuda_device, tasks)
        before = k1_counts()
        got = cuda_myers_banded.myers_banded_wide(*args)
        assert k1_counts() == (before[0], before[1] + 1, *before[2:])
        # the plain version on the card (on the host a 2048-word band takes
        # seconds per case)
        plain = cuda_myers_banded.myers_banded_plain(*args)
        for g, w in zip(got, plain):
            assert torch.equal(g, w), (band_words, tasks)


@pytest.mark.parametrize("band_words", cuda_myers_banded.WIDE_BAND_WORDS)
def test_wide_band_runs_the_multi_warp_kernel(cuda_device, band_words):
    """myers_banded sends every 128-word tile from 640 to 2048 words to the
    multi-warp kernel (counts from 0: one wide launch, no other), equal to
    the plain version and to the shared-memory kernel."""
    args = band_args(np.random.default_rng(band_words + 5), band_words,
                     cuda_device, count=24)
    zero_k1_counts()
    got = cuda_myers_banded.myers_banded(*args)
    assert k1_counts() == (0, 1, 0, 0)
    shared = cuda_myers_banded.myers_banded_shared(*args)
    plain = cuda_myers_banded.myers_banded_plain(*args)
    for g, s, w in zip(got, shared, plain):
        assert torch.equal(g, w) and torch.equal(s, w)


@pytest.mark.parametrize("max_m", [33, 257])
def test_small_kernel_matches_plain(cuda_device, max_m):
    rng = np.random.default_rng(max_m)
    patterns, texts = cases(rng, 300, 1, max_m, garbage_every=5)
    pat, plen = pad(patterns)
    txt, tlen = pad(texts)
    launches = cuda_myers.LAUNCHES
    got = myers_small_host(pat, plen, txt, tlen, cuda_device)
    assert cuda_myers.LAUNCHES == launches + 1
    np.testing.assert_array_equal(got, myers_small_host(pat, plen, txt, tlen, CPU))


@pytest.mark.parametrize("max_m", [600, 5000])
def test_large_kernel_matches_plain(cuda_device, max_m):
    rng = np.random.default_rng(max_m)
    patterns, texts = cases(rng, 40, 257, max_m, garbage_every=7)
    pat, plen = pad(patterns)
    txt, tlen = pad(texts)
    launches = cuda_myers_large.launches()
    got = myers_large_host(pat, plen, txt, tlen, cuda_device)
    assert cuda_myers_large.launches() == launches + 1
    np.testing.assert_array_equal(got, myers_large_host(pat, plen, txt, tlen, CPU))


@pytest.mark.parametrize("words", sorted(cuda_myers.LANES_FOR_WORDS))
def test_small_kernel_every_instance_matches_plain(cuda_device, words):
    """K2 at each word count W (its instance of LANES_FOR_WORDS[W] lanes
    per task), tasks of 1..W words in one launch: equal to the plain
    version, one launch counted."""
    args = full_myers_operands(np.random.default_rng(words), 75, words,
                               True, cuda_device)
    launches = cuda_myers.LAUNCHES
    got = cuda_myers.myers_small_cuda(*args)
    assert cuda_myers.LAUNCHES == launches + 1
    want = cuda_myers.myers_small_plain(*(t.cpu() for t in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def k3_counts():
    return (cuda_myers_large.REGISTER_LAUNCHES,
            cuda_myers_large.CLUSTER_LAUNCHES,
            cuda_myers_large.SHARED_LAUNCHES)


def zero_k3_counts():
    cuda_myers_large.REGISTER_LAUNCHES = 0
    cuda_myers_large.CLUSTER_LAUNCHES = 0
    cuda_myers_large.SHARED_LAUNCHES = 0


@pytest.mark.parametrize("words", cuda_myers_large.REGISTER_WORDS)
def test_large_register_kernel_matches_plain_and_shared(cuda_device, words):
    """K3's register kernel at each instance, tasks of 1 to words / 32
    groups in one launch: equal to the plain version and the shared-memory
    kernel, and myers_large routes the width to it."""
    args = full_myers_operands(np.random.default_rng(words + 3), 12, words,
                               False, cuda_device)
    before = k3_counts()
    register = cuda_myers_large.myers_large_register(*args)
    shared = cuda_myers_large.myers_large_shared(*args)
    routed = cuda_myers_large.myers_large(*args)
    assert k3_counts() == (before[0] + 2, before[1], before[2] + 1)
    want = cuda_myers_large.myers_large_plain(*(t.cpu() for t in args))
    for w, *got in zip(want, register, shared, routed):
        for tensor in got:
            assert torch.equal(tensor.cpu(), w)


def test_wide_large_runs_the_shared_kernel(cuda_device):
    """No routed width reaches the shared-memory kernel (the cluster
    kernel takes every Wp past 512 words up to 16384, past the shared
    kernel's limit): its entry point runs 2080 pattern words directly,
    equal to the plain version, and the register kernel refuses them."""
    args = full_myers_operands(np.random.default_rng(640), 6, 2080, False,
                               cuda_device, max_chars=3000)
    before = k3_counts()
    got = cuda_myers_large.myers_large_shared(*args)
    assert k3_counts() == (*before[:2], before[2] + 1)
    want = cuda_myers_large.myers_large_plain(*(t.cpu() for t in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    with pytest.raises(ValueError):
        cuda_myers_large.myers_large_register(*args)


@pytest.mark.parametrize("words", range(544, 2049, 32))
def test_large_wide_kernel_matches_plain(cuda_device, words):
    """K3 at every Wp from 544 to 2048 words (past the register kernel's
    widest: the cluster kernel, on its pick of blocks for the launch's
    tasks) at 1, 7 and 64 tasks spread from one group to the width's last,
    texts cut to 2000 columns: through myers_large from zeroed counts, one
    cluster launch each, equal to the plain version on the card."""
    rng = np.random.default_rng(words + 9)
    for tasks in WIDE_TASKS:
        # one task: the widest of four (the first three are m == 0, tlen 0
        # and tlen 1)
        args = full_myers_operands(rng, max(tasks, 4), words, False,
                                   cuda_device, spread=True,
                                   max_columns=2000)
        if tasks == 1:
            args = tuple(a[3:] for a in args)
        zero_k3_counts()
        got = cuda_myers_large.myers_large(*args)
        assert k3_counts() == (0, 1, 0)
        want = cuda_myers_large.myers_large_plain(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (words, tasks)


@pytest.mark.parametrize("words", [544, 1280, 2048])
def test_wide_large_runs_the_multi_warp_kernel(cuda_device, words):
    """myers_large sends 544, 1280 or 2048 pattern words to the cluster
    kernel (counts from 0: one cluster launch, no other; no one-block
    multi-warp K3 is left), equal to the shared-memory kernel on the same
    operands, and the card holds a cluster of each pick."""
    args = full_myers_operands(np.random.default_rng(words + 11), 8, words,
                               False, cuda_device, max_chars=4000)
    zero_k3_counts()
    cuda_myers_large.CLUSTER_WIDTHS.clear()
    got = cuda_myers_large.myers_large(*args)
    assert k3_counts() == (0, 1, 0)
    assert cuda_myers_large.CLUSTER_WIDTHS == {words: 1}
    shared = cuda_myers_large.myers_large_shared(*args)
    for g, s in zip(got, shared):
        assert torch.equal(g.cpu(), s.cpu())
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for tasks in (1, 7, 64, 264):
        blocks = cuda_myers_large.cluster_blocks(words, tasks, sms)
        assert cuda_myers_large.cluster_max_clusters(cuda_device, words,
                                                     blocks) > 0


def test_a_cluster_the_card_refuses_raises(cuda_device):
    """A cluster the kernel's entry refuses (nine blocks: past the
    portable eight; for K1u a one-block cluster of a 4096-word band's 32
    warps) raises a RuntimeError naming the entry, with no launch counted
    and nothing else run in its place; asking the card for such a shape's
    clusters raises too."""
    args = short_full_args(np.random.default_rng(9), 1280, cuda_device)
    zero_k3_counts()
    with pytest.raises(RuntimeError, match="floxer_myers_large_cluster"):
        cuda_myers_large._launch_cuda("floxer_myers_large_cluster", *args, 9)
    assert k3_counts() == (0, 0, 0)
    with pytest.raises(RuntimeError, match="max_clusters"):
        cuda_myers_large.cluster_max_clusters(cuda_device, 1280, 9)
    band = deep_band_args(np.random.default_rng(4096), 4096, cuda_device)
    zero_k1_counts()
    with pytest.raises(RuntimeError, match="floxer_myers_banded_cluster"):
        cuda_myers_banded._launch_cuda("floxer_myers_banded_cluster", *band,
                                       1)
    assert k1_counts() == (0, 0, 0, 0)


# the cluster kernels' sweep (K1u, K3u): every width chip_smoke.py's sweep
# holds them to the plain version at, the widest included
CLUSTER_SWEEP = (2176, 3200, 4096, 6528, 8192, 16384)


def deep_band_args(rng, band_words, device):
    """Two tasks of ~2000 columns whose pattern rows fill the band from the
    first column (deep_band_cases), two of band_cases' shape, and two
    whose tlen is 0 and 1."""
    patterns, texts, budgets = cuda_myers_banded.deep_band_cases(
        rng, 4, band_words, 2000)
    more = band_cases(rng, 2, band_words)
    patterns, texts = patterns + more[0], texts + more[1]
    budgets = np.concatenate([budgets, more[2]])
    txt, tlen = pad(texts)
    tlen[0], tlen[1] = 0, 1
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, budgets, band_words, device
    )
    return (*operands, band_words, num_text)


@pytest.mark.parametrize("band_words", CLUSTER_SWEEP)
def test_banded_cluster_kernel_matches_plain(cuda_device, band_words):
    """K1u (csrc/myers_banded_cluster.cu) at every width of the sweep, on
    its pick of the cluster: equal to the plain version on the card, one
    cluster launch counted."""
    args = deep_band_args(np.random.default_rng(band_words + 21), band_words,
                          cuda_device)
    before = k1_counts()
    got = cuda_myers_banded.myers_banded_cluster(*args)
    assert k1_counts() == (*before[:2], before[2] + 1, before[3])
    plain = cuda_myers_banded.myers_banded_plain(*args)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("band_words,blocks", [
    (256, 2), (384, 2), (1024, 1), (1024, 4), (2048, 1), (2048, 2),
    (2176, 3), (4096, 8), (6528, 5),
])
def test_banded_cluster_sizes_match_plain(cuda_device, band_words, blocks):
    """K1u on a cluster of `blocks` blocks, a spare warp idle where the
    warps do not divide evenly, the one-block cluster included: equal to
    the plain version and to the multi-warp kernel where it takes the
    band."""
    args = deep_band_args(np.random.default_rng(band_words + blocks),
                          band_words, cuda_device)
    got = cuda_myers_banded.myers_banded_cluster(*args, blocks=blocks)
    plain = cuda_myers_banded.myers_banded_plain(*args)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)
    if band_words <= cuda_myers_banded.WIDE_MAX_WORDS:
        for g, w in zip(cuda_myers_banded.myers_banded_wide(*args), plain):
            assert torch.equal(g, w)


@pytest.mark.parametrize("band_words,kernel", [
    (2048, (0, 1, 0, 0)), (2176, (0, 0, 1, 0)), (8192, (0, 0, 1, 0)),
])
def test_band_routing_from_zeroed_counts(cuda_device, band_words, kernel):
    """myers_banded from zeroed counts: 2176 and 8192 band words take the
    cluster kernel, 2048 still the multi-warp one; one launch, equal to
    the plain version; CLUSTER_WIDTHS counts the cluster launch's width."""
    args = deep_band_args(np.random.default_rng(band_words + 2), band_words,
                          cuda_device)
    zero_k1_counts()
    cuda_myers_banded.CLUSTER_WIDTHS.clear()
    got = cuda_myers_banded.myers_banded(*args)
    assert k1_counts() == kernel
    assert cuda_myers_banded.CLUSTER_WIDTHS == (
        {band_words: 1} if kernel[2] else {})
    for g, w in zip(got, cuda_myers_banded.myers_banded_plain(*args)):
        assert torch.equal(g, w)


def test_f3_shared_kernel_past_its_memory_and_the_widest_band(cuda_device):
    """F3: the shared-memory kernel's nine arrays of a 6528-word band
    (235,008 bytes) pass the card's 232,448 bytes of shared memory a
    block, so its launch is refused and raises; myers_banded runs that
    band on the cluster kernel, equal to the plain version; past the
    widest band any kernel takes (16384 words) it raises a ValueError
    naming the width, with no launch and no fallback."""
    rng = np.random.default_rng(6528)
    patterns, texts, budgets = band_cases(rng, 2, 6528)
    txt, tlen = pad(texts)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, budgets, 6528, cuda_device
    )
    args = (*operands, 6528, num_text)
    before = k1_counts()
    with pytest.raises(RuntimeError, match="floxer_myers_banded"):
        cuda_myers_banded.myers_banded_shared(*args)
    assert k1_counts() == before
    zero_k1_counts()
    got = cuda_myers_banded.myers_banded(*args)
    assert k1_counts() == (0, 0, 1, 0)
    for g, w in zip(got, cuda_myers_banded.myers_banded_plain(*args)):
        assert torch.equal(g, w)
    widest = cuda_myers_banded.CLUSTER_MAX_WORDS
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, budgets, widest + 128, cuda_device
    )
    zero_k1_counts()
    with pytest.raises(ValueError, match=f"{widest + 128} words"):
        cuda_myers_banded.myers_banded(*operands, widest + 128, num_text)
    assert k1_counts() == (0, 0, 0, 0)


def short_full_args(rng, words, device):
    """Six K3 tasks spread from one group to the width's last, each text
    cut to 2000 columns (m == 0, tlen 0 and 1, chars 6..15 among them)."""
    return full_myers_operands(rng, 6, words, False, device, spread=True,
                               max_columns=2000)


@pytest.mark.parametrize("words", CLUSTER_SWEEP)
def test_large_cluster_kernel_matches_plain(cuda_device, words):
    """K3u (csrc/myers_large_cluster.cu) at every width of the sweep, on its
    pick of the cluster: equal to the plain version on the card, one
    cluster launch counted."""
    args = short_full_args(np.random.default_rng(words + 31), words,
                           cuda_device)
    before = k3_counts()
    got = cuda_myers_large.myers_large_cluster(*args)
    assert k3_counts() == (before[0], before[1] + 1, before[2])
    want = cuda_myers_large.myers_large_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("words,blocks", [
    (544, 2), (1280, 1), (1280, 3), (2048, 2), (3200, 4), (8192, 8),
])
def test_large_cluster_sizes_match_plain(cuda_device, words, blocks):
    """K3u on a cluster of `blocks` blocks (warps that do not divide evenly
    and the one-block cluster included): equal to the plain version."""
    args = short_full_args(np.random.default_rng(words + blocks), words,
                           cuda_device)
    got = cuda_myers_large.myers_large_cluster(*args, blocks=blocks)
    for g, w in zip(got, cuda_myers_large.myers_large_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("words,kernel", [
    (2048, (0, 1, 0)), (2176, (0, 1, 0)), (8192, (0, 1, 0)),
])
def test_large_routing_from_zeroed_counts(cuda_device, words, kernel):
    """myers_large from zeroed counts: 2048, 2176 and 8192 pattern words
    take the cluster kernel; past the widest (16384) it raises a
    ValueError naming the width."""
    args = short_full_args(np.random.default_rng(words + 5), words,
                           cuda_device)
    zero_k3_counts()
    got = cuda_myers_large.myers_large(*args)
    assert k3_counts() == kernel
    for g, w in zip(got, cuda_myers_large.myers_large_plain(*args)):
        assert torch.equal(g, w)
    wider = cuda_myers_large.CLUSTER_WORDS + 32
    peq = torch.zeros((6, 6, wider), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match=f"{wider} words"):
        cuda_myers_large.myers_large(peq, *args[1:])


def traceback_tasks(rng, count, length, error_rate):
    """Root-like traceback tasks: a window, a mutated slice of it as the
    pattern, (end_col, distance) from the native full Myers engine."""
    from floxer_tpu_torch.native import native_myers_distance_batch

    windows, patterns = [], []
    for _ in range(count):
        window = rng.integers(1, 5, size=length + length // 8).astype(np.uint8)
        start = int(rng.integers(0, length // 16))
        pattern = window[start : start + length].copy()
        for pos in rng.integers(0, length, size=int(length * error_rate)):
            pattern[pos] = 1 + (pattern[pos] % 4)
        pattern = np.delete(pattern, rng.integers(0, length, size=length // 100))
        windows.append(window)
        patterns.append(pattern)
    dist, end = native_myers_distance_batch(windows, patterns, num_threads=4)
    return [
        (w, p, int(e), int(d))
        for w, p, e, d in zip(windows, patterns, end, dist)
    ]


@pytest.mark.parametrize("length,error_rate", [(600, 0.04), (5000, 0.12)])
def test_traceback_kernel_matches_plain(cuda_device, length, error_rate):
    """K4 at two band widths (~100 and ~1300 cells): one launch for the
    batch, the card's CIGARs equal the plain version's and the host
    traceback's."""
    from floxer_tpu_torch.ops import dp_reference
    from floxer_tpu_torch.ops import traceback_device

    rng = np.random.default_rng(length)
    tasks = traceback_tasks(rng, 12, length, error_rate)
    traceback_device.LAUNCHES = 0
    got = traceback_device.banded_cigar_traceback_device_batch(tasks, cuda_device)
    assert traceback_device.LAUNCHES == 1
    want = traceback_device.banded_cigar_traceback_device_batch(tasks, CPU)
    assert got == want
    for t, task in enumerate(tasks):
        assert got[t] == dp_reference.banded_cigar_traceback(*task), t


def k4_outputs(tasks, device, layout=None):
    from floxer_tpu_torch.ops import traceback_device

    batch = traceback_device.pack_batch(tasks, layout)
    out = traceback_device.banded_traceback(
        torch.from_numpy(batch.windows).to(device),
        torch.from_numpy(batch.patterns).to(device),
        torch.from_numpy(batch.table).to(device), batch,
    )
    return [t.cpu() for t in out]


@pytest.mark.parametrize("layout", [(8, False), (16, False), (32, False),
                                    (64, True), (96, True), (128, True)])
def test_traceback_mixed_widths_one_launch(cuda_device, layout):
    """A batch of mixed band widths (half = 0 to ~1000 cells, an empty
    pattern) in one launch of each K4 layout: ops, counts and begins equal
    the plain version's."""
    from floxer_tpu_torch.ops import traceback_device

    rng = np.random.default_rng(17)
    tasks = (traceback_tasks(rng, 3, 300, 0.02)
             + traceback_tasks(rng, 3, 2500, 0.1)
             + traceback_tasks(rng, 2, 900, 0.2))
    window = tasks[0][0]
    tasks.append((window, window[10:60].copy(), 60, 0))
    tasks.append((window, np.zeros(0, dtype=np.uint8), 33, 0))
    layout = traceback_device.Layout(*layout)
    traceback_device.LAUNCHES = 0
    got = k4_outputs(tasks, cuda_device, layout)
    assert traceback_device.LAUNCHES == 1
    want = k4_outputs(tasks, CPU, layout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def wide_task(half):
    """A random pattern against a window: a band of about 2 half cells."""
    from floxer_tpu_torch.native import native_myers_distance_batch

    rng = np.random.default_rng(half)
    window = rng.integers(1, 5, size=3 * half).astype(np.uint8)
    pattern = rng.integers(1, 5, size=2 * half + 300).astype(np.uint8)
    dist, end = native_myers_distance_batch([window], [pattern], num_threads=1)
    return window, pattern, int(end[0]), int(dist[0])


@pytest.mark.parametrize("half", [2100, 4500, 9000])
def test_traceback_wide_bands_match_native(cuda_device, half):
    """Bands past the 8-cell register layout (4096 cells), past the
    16-cell one (8192) and past the 32-cell one (16384, 64 shared-row
    cells a thread): K4 equals the native host traceback."""
    from floxer_tpu_torch.ops import dp_reference
    from floxer_tpu_torch.ops import traceback_device

    task = wide_task(half)
    layout = traceback_device.choose_layout(traceback_device.band_width(task[3]))
    got = traceback_device.banded_cigar_traceback_device_batch([task], cuda_device)
    assert got[0] == dp_reference.banded_cigar_traceback(*task)
    assert layout.cells == (8 if task[3] <= 2047 else 16 if task[3] <= 4095
                            else 32 if task[3] <= 8191 else 64)
    assert layout.shared_row == (task[3] > 8191)


def test_traceback_mixed_layouts_one_launch_match_native(cuda_device):
    """Tasks of every width class in one batch: one launch, each block in
    its task's own layout, every CIGAR equal to the native traceback."""
    from floxer_tpu_torch.ops import dp_reference
    from floxer_tpu_torch.ops import traceback_device

    rng = np.random.default_rng(23)
    tasks = (traceback_tasks(rng, 3, 2500, 0.1)
             + [wide_task(2600), wide_task(4400), wide_task(8800)]
             + traceback_tasks(rng, 2, 600, 0.04))
    batch = traceback_device.pack_batch(tasks)
    assert set(batch.layouts()) == {"reg8", "reg16", "reg32", "shared64"}
    traceback_device.LAUNCHES = 0
    got = traceback_device.banded_cigar_traceback_device_batch(tasks, cuda_device)
    assert traceback_device.LAUNCHES == 1
    for t, task in enumerate(tasks):
        assert got[t] == dp_reference.banded_cigar_traceback(*task), t


def test_traceback_wrapper_refuses_cpu_kernel_and_bad_operands(cuda_device):
    """No fallback: mixed devices and wrong dtypes raise."""
    from floxer_tpu_torch.ops import traceback_device

    rng = np.random.default_rng(3)
    batch = traceback_device.pack_batch(traceback_tasks(rng, 2, 300, 0.02))
    with pytest.raises(ValueError, match="patterns"):
        traceback_device.banded_traceback(
            torch.from_numpy(batch.windows).to(cuda_device),
            torch.from_numpy(batch.patterns),
            torch.from_numpy(batch.table).to(cuda_device), batch,
        )


def test_fused_wave_on_card_matches_cpu(cuda_device):
    """One multi-stage wave through all three kernels, on the card and
    through the plain versions: identical (distance, end) per task."""
    rng = np.random.default_rng(11)
    refs = [rng.integers(1, 5, size=30_000).astype(np.uint8)]
    origins = [int(s) for s in rng.integers(1000, 23_000, size=8)]
    reads = [refs[0][s : s + 6000].copy() for s in origins]
    for read in reads:
        for pos in rng.integers(0, 6000, size=200):
            read[pos] = 1 + (read[pos] % 4)
    batches = [
        FusedBatch(ResidentBank(refs, device), ResidentBank(reads, device))
        for device in (cuda_device, CPU)
    ]
    refs_out = []
    for walk, origin in enumerate(origins):
        # half the walks verify at their origin (alive through every
        # level), half against a random window (they die early)
        start = origin if walk % 2 else int(rng.integers(0, 23_000))
        for length in (100, 700, 6000):  # small, large, banded
            budget = length // 12
            task = (
                walk, max(0, start - budget), length + 2 * budget + 1,
                batches[0].query_bank.base(walk), length, budget,
            )
            refs_out.append(tuple(b.add_task(*task) for b in batches))
    kinds = {kind for stage in batches[0].stages for kind in stage}
    assert kinds == {"small", "large", "banded"}
    got, want = (b.run() for b in batches)
    for on_card, on_cpu in refs_out:
        assert got[on_card] == want[on_cpu]


def test_engine_device_matches_host_engine(cuda_device, tmp_path):
    """The CLI's --engine device on the card writes the host engine's SAM
    and the reference e2e expectations hold."""
    def args(name, extra=()):
        return [
            "--reference", str(DATA / "reference.fasta"),
            "--queries", str(DATA / "queries.fastq"),
            "--output", str(tmp_path / name),
            "--query-errors", "2", "--seed-errors", "1",
            "--extra-verification-ratio", "2", "--interval-optimization",
            *extra,
        ]

    host = parse_and_validate(args("host.sam"))
    assert pipeline.run(host, use_device=False) == 0
    device = parse_and_validate(args("device.sam", ["--engine", "device"]))
    assert pipeline.run(device) == 0
    assert (tmp_path / "device.sam").read_bytes() == (
        tmp_path / "host.sam"
    ).read_bytes()
    check_output_records(parse_sam(tmp_path / "device.sam"))


@pytest.fixture(scope="module")
def simulated(tmp_path_factory):
    """A 300 kb genome and 8 reads of 5 kb at 7% error."""
    from floxer_tpu_torch.tools.simulated_dataset import main as simulate

    workdir = tmp_path_factory.mktemp("simulated")
    assert simulate([
        "create", "-g", str(workdir / "genome.fasta"),
        "-r", str(workdir / "reads.fastq"), "-c", "300000", "-n", "1",
        "-l", "5000", "-m", "8", "-e", "0.07", "-s", "11",
    ]) == 0
    return workdir


@pytest.mark.parametrize(
    "env_name,kernel",
    [("FLOXER_TPU_LEGACY_VERIFY", "K1"), ("FLOXER_TPU_DEVICE_TRACEBACK", "K4")],
)
def test_engine_device_mode_matches_host_engine(
    cuda_device, simulated, tmp_path, monkeypatch, env_name, kernel
):
    """--engine device through the legacy object path (the bucketed
    batcher) or with device tracebacks (K4) writes the host engine's SAM
    and launches the mode's kernel."""
    def args(name, extra=()):
        return [
            "--reference", str(simulated / "genome.fasta"),
            "--queries", str(simulated / "reads.fastq"),
            "--output", str(tmp_path / name),
            "-p", "0.08", "--interval-optimization", *extra,
        ]

    assert pipeline.run(parse_and_validate(args("host.sam")), use_device=False) == 0
    monkeypatch.setenv(env_name, "1")
    before = pipeline.kernel_launches()
    device = parse_and_validate(args("device.sam", ["--engine", "device"]))
    assert pipeline.run(device) == 0
    assert pipeline.kernel_launches()[kernel] > before[kernel]
    assert (tmp_path / "device.sam").read_bytes() == (
        tmp_path / "host.sam"
    ).read_bytes()


# the research scripts' kernels K5-K8 (floxer_tpu_torch.scripts) at the
# scripts' 32 rows and 256 band words (K5 also at 128 and 384), on 512
# text columns
SCRIPT_TEXT = 512


@pytest.mark.parametrize("band_words", ablate_banded_kernel.CUDA_BAND_WORDS)
@pytest.mark.parametrize("variant", ablate_banded_kernel.VARIANTS)
def test_ablation_kernel_matches_plain(cuda_device, variant, band_words):
    """K5: each variant equals its plain version at each band width it is
    built for; r4 also equals full."""
    operands = ablate_banded_kernel.device_operands(
        ablate_banded_kernel.script_inputs(SCRIPT_TEXT, band_words),
        cuda_device,
    )
    launches = ablate_banded_kernel.LAUNCHES
    got = ablate_banded_kernel.ablate_banded(*operands, variant)
    assert ablate_banded_kernel.LAUNCHES == launches + 1
    want = ablate_banded_kernel.ablate_banded_plain(*operands, variant)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    if variant == "r4":
        full = ablate_banded_kernel.ablate_banded(*operands, "full")
        for g, f in zip(got, full):
            assert torch.equal(g.cpu(), f.cpu())


@pytest.mark.parametrize("band_words", [128, 256, 384])
def test_ablation_full_ends_where_k1_ends(cuda_device, band_words):
    """K5 runs K1's register column (csrc/myers_banded_column.cuh's
    column_reg): on K1's operands K5 `full` ends every task at K1's end
    column."""
    rng = np.random.default_rng(band_words + 1)
    patterns, texts = cases(rng, 96, 60, 2000)
    budgets = np.asarray([max(1, len(p) // 10) for p in patterns])
    txt, tlen = pad(texts)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, budgets, band_words, cuda_device
    )
    _, k1_end = cuda_myers_banded.myers_banded(*operands, band_words, num_text)
    launches = ablate_banded_kernel.LAUNCHES
    _, k5_end = ablate_banded_kernel.ablate_banded(
        *ablate_banded_kernel.from_banded_operands(*operands), "full"
    )
    assert ablate_banded_kernel.LAUNCHES == launches + 1
    assert torch.equal(k5_end.cpu(), k1_end.cpu())
    assert bool((k1_end > 0).all())


def test_ablation_kernel_refuses_other_widths(cuda_device):
    """K5 is built at 128, 256 and 384 band words only: another width
    raises and launches nothing, on the card too."""
    for band_words in (64, 512):
        operands = ablate_banded_kernel.device_operands(
            ablate_banded_kernel.script_inputs(64, band_words), cuda_device
        )
        launches = ablate_banded_kernel.LAUNCHES
        with pytest.raises(ValueError, match="128, 256, 384"):
            ablate_banded_kernel.ablate_banded(*operands, "full")
        assert ablate_banded_kernel.LAUNCHES == launches


def scripts_instances(usage, kernel, params):
    """{template arguments: ptxas usage} of one kernel of the scripts'
    build, its mangled int template arguments read by `params` fields."""
    import re

    pattern = kernel + "".join([r"ILi(\d+)E"] + [r"Li(\d+)E"] * (params - 1))
    found = {}
    for name, entry in usage.items():
        match = re.search(pattern, name)
        if match:
            found[tuple(map(int, match.groups()))] = (name, entry)
    return found


def test_scripts_kernels_registers_and_loops(cuda_device):
    """ptxas -v of the scripts' build: K5's 27 instances (9 variants x R =
    4, 8, 12), K6's 3, K7's 8 and K8's 4 keep no stack frame and spill
    nothing; K7 holds its carried arrays in registers, so carry=14 takes at
    least 80 more registers than carry=3, and its column loop at least 2
    more instructions for each added array word (11 arrays x 8 words); K6
    and K8 keep no static shared memory and hold one column loop of at
    least the work their function names on a lane's 8 words (K6 `empty`
    8 adds, `elementwise` 8 x 20 x 3, `rolls` 12 shuffles and 8 adds; K8
    16 adds and 8 predicated xors a condition), which a loop that folds
    words falls below."""
    from floxer_tpu_torch.ops import _build

    _build.SCRIPTS.load()
    usage = _build.SCRIPTS.ptxas_usage()
    k5 = scripts_instances(usage, "ablate_banded_kernel", 2)
    k6 = scripts_instances(usage, "column_loop_kernel", 1)
    k7 = scripts_instances(usage, "carry_scaling_kernel", 3)
    k8 = scripts_instances(usage, "bcast_kernel", 1)
    assert len(k5) == 27 and {r for r, _ in k5} == {4, 8, 12}
    assert sorted(k6) == [(0,), (1,), (2,)]
    assert sorted(k7) == sorted(microbench_carry_scaling.CONFIGS)
    assert sorted(k8) == [(b,) for b in microbench_carry_scaling.BCASTS]
    instances = [*k5.values(), *k6.values(), *k7.values(), *k8.values()]
    for name, entry in instances:
        assert entry.get("stack", 1) == 0, (name, entry)
        assert entry.get("spill_stores", 1) == 0, (name, entry)
        assert entry.get("spill_loads", 1) == 0, (name, entry)
    assert (k7[(14, 0, 0)][1]["registers"]
            - k7[(3, 0, 0)][1]["registers"]) >= 80
    loops = _build.sass_loops(_build.SCRIPTS.sass())
    few, many = (loops[k7[(c, 0, 0)][0]] for c in (3, 14))
    assert len(few) == len(many) == 1
    assert many[0] - few[0] >= 2 * 11 * 8
    floors = [(k6[(0,)], 8), (k6[(1,)], 8 * 20 * 3), (k6[(2,)], 12 + 8)]
    floors += [(k8[(b,)], 2 * 8 + 8 * b)
               for b in microbench_carry_scaling.BCASTS]
    for (name, entry), floor in floors:
        assert entry.get("shared", 0) == 0, (name, entry)
        assert len(loops[name]) == 1 and loops[name][0] >= floor, (
            name, loops[name], floor)


@pytest.mark.parametrize("variant", microbench_column_loop.VARIANTS)
def test_column_loop_kernel_matches_plain(cuda_device, variant):
    texts = torch.from_numpy(microbench_column_loop.script_texts(SCRIPT_TEXT))
    texts = texts.to(cuda_device)
    launches = microbench_column_loop.LAUNCHES
    got = microbench_column_loop.column_loop(texts, variant)
    assert microbench_column_loop.LAUNCHES == launches + 1
    want = microbench_column_loop.column_loop_plain(texts, variant)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("config", microbench_carry_scaling.CONFIGS)
def test_carry_scaling_kernel_matches_plain(cuda_device, config):
    texts = torch.from_numpy(microbench_column_loop.script_texts(SCRIPT_TEXT))
    texts = texts.to(cuda_device)
    launches = microbench_carry_scaling.CARRY_LAUNCHES
    got = microbench_carry_scaling.carry_scaling(texts, *config)
    assert microbench_carry_scaling.CARRY_LAUNCHES == launches + 1
    want = microbench_carry_scaling.carry_scaling_plain(texts, *config)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("n_bcast", microbench_carry_scaling.BCASTS)
def test_bcast_kernel_matches_plain(cuda_device, n_bcast):
    texts = torch.from_numpy(microbench_column_loop.script_texts(SCRIPT_TEXT))
    texts = texts.to(cuda_device)
    jstar = torch.from_numpy(microbench_carry_scaling.script_jstar(SCRIPT_TEXT))
    jstar = jstar.to(cuda_device)
    launches = microbench_carry_scaling.BCAST_LAUNCHES
    got = microbench_carry_scaling.bcast(texts, jstar, n_bcast)
    assert microbench_carry_scaling.BCAST_LAUNCHES == launches + 1
    want = microbench_carry_scaling.bcast_plain(texts, jstar, n_bcast)
    assert torch.equal(got.cpu(), want.cpu())


# ---- the device search: K9, K9x, K9l (csrc/fm_index.cu) and K10
# (csrc/workqueue_search.cu) against their plain versions on the card


@pytest.fixture(scope="module")
def search_index():
    """A two-sequence index (one with N's) and its sequences."""
    from floxer_tpu_torch.index.fmindex import FmIndex

    rng = np.random.default_rng(17)
    sequences = [
        rng.integers(1, 5, size=30_000).astype(np.uint8),
        rng.integers(1, 6, size=9_000).astype(np.uint8),
    ]
    return FmIndex(sequences), sequences


def device_index_of(host, device, layout):
    from floxer_tpu_torch.index.device_index import DeviceIndex

    index = DeviceIndex.from_host(host, device,
                                  force_planes=layout == "planes")
    assert (index.rank_rows is None) == (layout == "planes")
    return index


@pytest.mark.parametrize("layout", ["combined", "planes"])
def test_fm_index_kernels_match_plain(cuda_device, search_index, layout):
    """K9 (both directions), K9x (left and right) and K9l equal their plain
    versions on the same card tensors, every block boundary included."""
    from floxer_tpu_torch.ops import cuda_fm_index as k9

    host, _ = search_index
    index = device_index_of(host, cuda_device, layout)
    rng = np.random.default_rng(9)
    n = host.n
    positions = torch.from_numpy(np.concatenate([
        rng.integers(0, n + 1, size=50_000), np.arange(0, n + 1, 128),
        [0, 1, 31, 32, 33, 127, 129, n],
    ]).astype(np.int32)).to(cuda_device)
    for single in (index.fwd, index.rev):
        operands = (single.rank_rows, single.block_offset, single.occ,
                    single.planes)
        got = k9.fm_rank_cuda(positions, *operands)
        assert torch.equal(got, k9.fm_rank_plain(positions, *operands))
    lb = rng.integers(0, n, size=20_000)
    lb_rev = rng.integers(0, n, size=20_000)
    length = np.minimum(rng.integers(0, 3000, size=20_000),
                        n - np.maximum(lb, lb_rev))
    cursors = [torch.from_numpy(a.astype(np.int32)).to(cuda_device)
               for a in (lb, lb_rev, length)]
    for left in (True, False):
        got = k9.fm_extend_cuda(index, *cursors, left=left)
        want = k9.fm_extend_plain(index, *cursors, left=left)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    rows = torch.from_numpy(
        rng.integers(0, n, size=50_000).astype(np.int32)
    ).to(cuda_device)
    got = k9.fm_locate_cuda(index, rows, index.sampling_rate)
    want = k9.fm_locate_plain(index, rows, index.sampling_rate)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    seq_ids, offsets = (t.cpu().numpy() for t in got)
    for i in range(0, 50_000, 997):
        assert host.locate(int(rows[i])) == (seq_ids[i], offsets[i])


def group_cursors(host, sequences, kind, count, rng):
    """K9x's two cursor kinds, int32 [3, count] on the CPU: random ones
    (the first of length 0, the second ending at n, lengths up to 2999
    clipped to fit) or search cursors (tools/fm_bench.search_cursors of
    the text's own slices, some mutated, tiled to count)."""
    from floxer_tpu_torch.tools.fm_bench import search_cursors

    n = host.n
    if kind == "random":
        lb = rng.integers(0, n, size=count)
        lb_rev = rng.integers(0, n, size=count)
        length = np.minimum(rng.integers(0, 3000, size=count),
                            n - np.maximum(lb, lb_rev))
        length[0] = 0
        if count > 1:
            length[1] = n - max(lb[1], lb_rev[1])
        return np.stack([lb, lb_rev, length]).astype(np.int32)
    patterns = []
    for i in range(400):
        source = sequences[i % 2]
        k = int(rng.integers(12, 41))
        start = int(rng.integers(0, len(source) - k))
        pattern = source[start:start + k].copy()
        if i % 3 == 0:
            pattern[int(rng.integers(0, k))] = int(rng.integers(1, 5))
        patterns.append(pattern)
    cursors = search_cursors(host, patterns, limit=count, seed=5)
    copies = -(-count // cursors.shape[1])
    return np.tile(cursors, (1, copies))[:, :count].astype(np.int32)


@pytest.mark.parametrize("layout", ["combined", "planes"])
@pytest.mark.parametrize("batch", [1, 3, 4097, 1 << 16])
def test_rank_and_extension_kernels_match_plain(cuda_device, search_index,
                                                layout, batch):
    """K9 and K9x (a warp's rows staged 8 lanes a row in the combined
    layout, 8 lanes a query in the planes layout) against their plain
    versions at B queries (a part of one warp, of one block, and many
    blocks), each launch counted: K9 at positions 0 and n and seeded ones in both
    directions; K9x left and right on random cursors (length 0 and an end
    at n among them) and on search cursors, most inside one block."""
    from floxer_tpu_torch.ops import cuda_fm_index as k9

    host, sequences = search_index
    index = device_index_of(host, cuda_device, layout)
    rng = np.random.default_rng(batch)
    n = host.n
    positions = rng.integers(0, n + 1, size=batch)
    positions[0], positions[-1] = 0, n
    batches = [positions] + ([np.array([0])] if batch == 1 else [])
    for values in batches:
        tensor = torch.from_numpy(values.astype(np.int32)).to(cuda_device)
        for single in (index.fwd, index.rev):
            operands = (single.rank_rows, single.block_offset, single.occ,
                        single.planes)
            before = k9.RANK_LAUNCHES
            got = k9.fm_rank_cuda(tensor, *operands)
            assert k9.RANK_LAUNCHES == before + 1
            assert torch.equal(got, k9.fm_rank_plain(tensor, *operands))
    for kind in ("random", "search"):
        cursors = [torch.from_numpy(a).to(cuda_device) for a in
                   group_cursors(host, sequences, kind, batch, rng)]
        for left in (True, False):
            before = k9.EXTEND_LAUNCHES
            got = k9.fm_extend_cuda(index, *cursors, left=left)
            assert k9.EXTEND_LAUNCHES == before + 1
            want = k9.fm_extend_plain(index, *cursors, left=left)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_group_kernels_refuse_a_misaligned_table(cuda_device, search_index):
    """K9's and K9x's lanes load 16-byte pieces: a table that starts off
    a 16-byte boundary raises, and nothing launches."""
    from floxer_tpu_torch.ops import cuda_fm_index as k9

    host, _ = search_index
    index = device_index_of(host, cuda_device, "combined")
    rows = index.rank_rows
    flat = torch.empty(rows.numel() + 1, dtype=torch.int32,
                       device=cuda_device)
    shifted = flat[1:].view(rows.shape)
    shifted.copy_(rows)
    positions = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    before = (k9.RANK_LAUNCHES, k9.EXTEND_LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        k9.fm_rank_cuda(positions, shifted, 0)
    index.fwd.rank_rows = shifted
    with pytest.raises(ValueError, match="16-byte"):
        k9.fm_extend_cuda(index, positions, positions, positions, left=True)
    assert (k9.RANK_LAUNCHES, k9.EXTEND_LAUNCHES) == before


def search_chunk(sequences, seed=23, count=300):
    """Mutated slices of the indexed text as seeds of mixed error and
    length classes, plus a homopolymer: (padded, seed_class, tables,
    max_errors)."""
    from floxer_tpu_torch.schemes import expand_scheme
    from floxer_tpu_torch.search_device import SchemeTables

    rng = np.random.default_rng(seed)
    seeds = []
    for i in range(count):
        k = i % 4
        length = int(rng.integers(12, 41))
        source = sequences[i % 2]
        start = int(rng.integers(0, len(source) - length))
        pattern = source[start:start + length].copy()
        for _ in range(int(rng.integers(0, k + 1))):
            pos = int(rng.integers(0, length))
            pattern[pos] = 1 + (pattern[pos] % 4)
        seeds.append((k, pattern))
    seeds.append((2, np.full(14, 2, dtype=np.uint8)))
    pairs = sorted({(k, len(p)) for k, p in seeds})
    pad_len = -(-max(len(p) for _, p in seeds) // 8) * 8
    padded = np.zeros((len(seeds) + 20, pad_len), dtype=np.int32)
    tables = SchemeTables.from_length_classes(
        [expand_scheme(k, length) for k, length in pairs]
    )
    seed_class = np.full(padded.shape[0], tables.dead_class, dtype=np.int32)
    for i, (k, p) in enumerate(seeds):
        padded[i, :len(p)] = p
        seed_class[i] = pairs.index((k, len(p)))
    return padded, seed_class, tables, 3


@pytest.mark.parametrize("layout,budget", [
    pytest.param("combined", None, id="combined"),
    pytest.param("planes", None, id="planes"),
    pytest.param("combined", 1, id="combined-budget1"),
    pytest.param("planes", 2, id="planes-budget2"),
])
def test_workqueue_kernel_matches_plain(cuda_device, search_index, layout,
                                        budget):
    """K10 through workqueue_runner: exactly one launch, no overflow, rows
    equal to the plain version's (run on the same card tensors) once
    sorted, and the same node count; at the kernel's budget and at 1 and
    2 nodes a unit (every branching node spills to the work list), with
    the same largest tree."""
    from floxer_tpu_torch import search_queue
    from floxer_tpu_torch.ops import cuda_search_queue as k10

    host, sequences = search_index
    index = device_index_of(host, cuda_device, layout)
    padded, seed_class, tables, max_errors = search_chunk(sequences)
    kw = search_queue.key_words_needed(padded.shape[1], max_errors)
    operands = [torch.from_numpy(a).to(cuda_device)
                for a in (padded, seed_class, tables.fused())]
    frames = search_queue.frames_needed(padded.shape[1], max_errors)
    whole = k10.workqueue_search_cuda(
        index, *operands, tables.num_searches, tables.num_parts, 1 << 16, kw,
        frames, 1 << 20,
    )
    assert whole.spilled == 0 and not whole.overflow
    # a spill, one at most every `budget` nodes, moves at most budget + 1
    # entries: at a budget of 1 or 2 at most twice the nodes
    entries = None if budget is None else 2 * whole.nodes
    budget = k10.BUDGET if budget is None else budget
    before, spill_before = k10.LAUNCHES, k10.SPILL_LAUNCHES
    rows, overflow = search_queue.workqueue_runner(
        index, padded, seed_class, tables, 1 << 16, padded.shape[1],
        max_errors, budget=budget, list_capacity=entries,
    )
    # one launch a generation: the roots', then one a list of spilled
    # entries
    assert not overflow
    assert k10.LAUNCHES - before == 1 + k10.SPILL_LAUNCHES - spill_before
    run = k10.workqueue_search_cuda(
        index, *operands, tables.num_searches, tables.num_parts, 1 << 16, kw,
        frames, budget, entries,
    )
    assert run.largest_tree == whole.largest_tree
    if budget <= 2:
        assert run.launches > 2
        assert run.nodes <= budget * (padded.shape[0] * tables.num_searches
                                      + run.spilled)
    init = padded.shape[0] * tables.num_searches
    quantum = 1 << 12
    plain = search_queue.workqueue_search_plain(
        index, *operands, tables.num_searches, tables.num_parts, quantum,
        3 * quantum, 2 * init + 4 * quantum,
        1 << 16, kw, 1 << 16,
    )
    assert not plain.overflow and not run.overflow
    want = search_queue.sort_reports(
        plain.reports[:plain.num_reports].cpu().numpy()
    )
    assert want.shape[0] > 1000
    assert np.array_equal(rows, want)
    assert np.array_equal(search_queue.sort_reports(
        run.reports[:run.num_reports].cpu().numpy()), want)
    assert run.nodes == plain.nodes and 0 < run.largest_tree <= run.nodes


def test_workqueue_kernel_flags_overflow(cuda_device, search_index):
    """A report capacity below the reports, a key too short for the paths
    and a work list too short for the spilled entries each set K10's
    overflow; the runner retries a list overflow at 4x and gets the
    rows."""
    from floxer_tpu_torch import search_queue
    from floxer_tpu_torch.ops import cuda_search_queue as k10

    host, sequences = search_index
    index = device_index_of(host, cuda_device, "combined")
    padded, seed_class, tables, max_errors = search_chunk(sequences, 5, 40)
    operands = [torch.from_numpy(a).to(cuda_device)
                for a in (padded, seed_class, tables.fused())]
    frames = search_queue.frames_needed(padded.shape[1], max_errors)
    kw = search_queue.key_words_needed(padded.shape[1], max_errors)
    full = k10.workqueue_search_cuda(index, *operands, tables.num_searches,
                                     tables.num_parts, 1 << 16, kw, frames)
    assert not full.overflow and full.num_reports > 10
    small = k10.workqueue_search_cuda(index, *operands, tables.num_searches,
                                      tables.num_parts, 10, kw, frames)
    assert small.overflow and small.num_reports == 10
    short_key = k10.workqueue_search_cuda(
        index, *operands, tables.num_searches, tables.num_parts, 1 << 16, 1,
        frames,
    )
    assert short_key.overflow
    # work lists a quarter of the most entries one generation spills at a
    # budget of 1 overflow; the runner's retry at 4x gives the full rows
    spilling = k10.workqueue_search_cuda(
        index, *operands, tables.num_searches, tables.num_parts, 1 << 16, kw,
        frames, 1, 2 * full.nodes,
    )
    assert not spilling.overflow and spilling.list_peak > 4
    quarter = -(-spilling.list_peak // 4)
    small = k10.workqueue_search_cuda(
        index, *operands, tables.num_searches, tables.num_parts, 1 << 16, kw,
        frames, 1, quarter,
    )
    assert small.overflow
    retries = search_queue.RETRIES
    rows, overflow = search_queue.workqueue_runner(
        index, padded, seed_class, tables, 1 << 16, padded.shape[1],
        max_errors, budget=1, list_capacity=quarter,
    )
    assert not overflow and search_queue.RETRIES == retries + 1
    assert np.array_equal(rows, search_queue.sort_reports(
        full.reports[:full.num_reports].cpu().numpy()))


@pytest.mark.parametrize("layout", ["combined", "planes"])
def test_locate_kernel_every_row_and_block_edges(cuda_device, search_index,
                                                 layout):
    """K9l, whose SA samples come through the sampled-row plane, equals
    its plain version (the search over sampled_rows) on every row of the
    39 kb index and of a 300-row one, and on the rows beside the plane's
    block edges (127, 128, n - 1 and every multiple of 128 with its
    neighbours), in one launch each."""
    from floxer_tpu_torch.index.fmindex import FmIndex
    from floxer_tpu_torch.ops import cuda_fm_index as k9

    host, _ = search_index
    small = FmIndex([np.random.default_rng(5).integers(1, 5, 300)
                     .astype(np.uint8)])
    for index_host in (host, small):
        index = device_index_of(index_host, cuda_device, layout)
        n = index_host.n
        blocks = np.arange(0, n, 128)
        edges = np.unique(np.concatenate([
            [0, 127, 128, n - 1], blocks, blocks - 1, blocks + 1,
        ]))
        edges = edges[(edges >= 0) & (edges < n)]
        for rows in (np.arange(n), edges):
            rows = torch.from_numpy(rows.astype(np.int32)).to(cuda_device)
            before = k9.LOCATE_LAUNCHES
            got = k9.fm_locate_cuda(index, rows, index.sampling_rate)
            assert k9.LOCATE_LAUNCHES == before + 1
            want = k9.fm_locate_plain(index, rows, index.sampling_rate)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_locates_refuse_an_index_without_the_plane(cuda_device,
                                                   search_index):
    """K9l and K12 read the SA samples through the sampled-row plane only:
    an index without it (or with a plane of the wrong shape) is refused,
    with no launch, and no search runs in its place."""
    import dataclasses

    from floxer_tpu_torch.ops import cuda_fm_index as k9
    from floxer_tpu_torch.ops import cuda_select as k12

    host, _ = search_index
    index = device_index_of(host, cuda_device, "combined")
    rows = torch.arange(64, dtype=torch.int32, device=cuda_device)
    vector = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    for bad in (dataclasses.replace(index, sample_plane=None),
                dataclasses.replace(index,
                                    sample_plane=index.sample_plane[1:])):
        before = (k9.LOCATE_LAUNCHES, k12.LAUNCHES)
        with pytest.raises(ValueError, match="sample"):
            k9.fm_locate_cuda(bad, rows, bad.sampling_rate)
        with pytest.raises(ValueError, match="sample"):
            k12.select_anchors_cuda(bad, vector, vector, vector, vector,
                                    vector, vector[:2], vector[:1],
                                    vector[:1], 500, 9, 0, 0, True)
        assert (k9.LOCATE_LAUNCHES, k12.LAUNCHES) == before


def test_search_wrappers_refuse_cpu_operands(cuda_device, search_index):
    """No fallback: each CUDA entry raises on CPU tensors."""
    from floxer_tpu_torch.ops import cuda_fm_index as k9
    from floxer_tpu_torch.ops import cuda_search_queue as k10

    host, sequences = search_index
    index = device_index_of(host, CPU, "combined")
    vector = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k9.fm_rank_cuda(vector, index.rank_rows)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k9.fm_extend_cuda(index, vector, vector, vector, left=True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k9.fm_locate_cuda(index, vector, 4)
    padded, seed_class, tables, _ = search_chunk(sequences, 3, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k10.workqueue_search_cuda(
            index, torch.from_numpy(padded), torch.from_numpy(seed_class),
            torch.from_numpy(tables.fused()), tables.num_searches,
            tables.num_parts, 1 << 12, 6, 50,
        )
    from floxer_tpu_torch.ops import cuda_frontier as k11
    from floxer_tpu_torch.ops import cuda_select as k12

    with pytest.raises(ValueError, match="CUDA kernel"):
        k11.frontier_search_cuda(
            index, torch.from_numpy(padded[None]),
            torch.from_numpy(seed_class[None]),
            torch.from_numpy(tables.fused()), tables.num_searches,
            tables.num_parts, 1 << 12, 1 << 10, 50,
        )
    with pytest.raises(ValueError, match="CUDA kernel"):
        k12.select_anchors_cuda(index, vector, vector, vector, vector, vector,
                                vector[:2], vector[:1], vector[:1], 500, 9, 0,
                                0, True)


def test_search_kernels_ptxas_no_spill_no_stack(cuda_device):
    """ptxas -v of the aligner's build: K9 and K9x (a kernel each for the
    combined and the planes layout), K9l, K10, K11 (its instances over
    the index and over the shards), K12, K13 and K13l keep no stack frame
    and spill nothing."""
    from floxer_tpu_torch.ops import _build

    _build.ALIGNER.load()
    usage = _build.ALIGNER.ptxas_usage()
    for kernel, instances in (
        ("fm_rank_kernel", 1), ("fm_extend_kernel", 1),
        ("fm_rank_group_kernel", 1), ("fm_extend_group_kernel", 1),
        ("fm_locate_kernel", 1), ("workqueue_kernel", 1),
        ("frontier_kernel", 2), ("select_kernel", 1),
        ("fm_sharded_rank_kernel", 1), ("fm_sharded_locate_kernel", 1),
    ):
        names = [name for name in usage if kernel in name]
        assert len(names) == instances, (kernel, names)
        for name in names:
            found = usage[name]
            assert found.get("stack", 1) == 0, (name, found)
            assert found.get("spill_stores", 1) == 0, (name, found)
            assert found.get("spill_loads", 1) == 0, (name, found)


@pytest.mark.parametrize("engine", ["batched", "device"])
def test_device_search_cli_matches_host_search(cuda_device, simulated,
                                               tmp_path, engine):
    """--device-search on the card writes the host search's SAM, with one
    K10 search a chunk's dispatch (a second after an overflow), each one
    launch a generation (K10's SPILL_LAUNCHES count those past the
    first), counted after the search warmup's own launches."""
    from floxer_tpu_torch import search_queue
    from floxer_tpu_torch.search_device import DeviceSearcher

    def args(name, extra=()):
        return [
            "--reference", str(simulated / "genome.fasta"),
            "--queries", str(simulated / "reads.fastq"),
            "--output", str(tmp_path / name),
            "-p", "0.08", "--interval-optimization", *extra,
        ]

    assert pipeline.run(parse_and_validate(args("host.sam")),
                        use_device=False) == 0
    from floxer_tpu_torch.ops import cuda_search_queue as k10

    pipeline.start_device_warmup(cuda_device, device_search=True)
    pipeline.join_device_warmup()
    before = pipeline.kernel_launches()["K10"]
    dispatches = DeviceSearcher._chunk_dispatches
    retries = search_queue.RETRIES
    spills = k10.SPILL_LAUNCHES
    cli = parse_and_validate(
        args("device.sam", ["--engine", engine, "--device-search"])
    )
    assert pipeline.run(cli) == 0
    dispatches = DeviceSearcher._chunk_dispatches - dispatches
    assert dispatches > 0
    assert pipeline.kernel_launches()["K10"] - before == (
        dispatches + search_queue.RETRIES - retries
        + k10.SPILL_LAUNCHES - spills
    )
    assert (tmp_path / "device.sam").read_bytes() == (
        tmp_path / "host.sam"
    ).read_bytes()


# ---- the per-query frontier search (K11, csrc/frontier_search.cu) and
# device select (K12, csrc/select_anchors.cu) against their plain versions


def frontier_blocks(sequences, blocks=3, seed=31):
    """search_chunk's seeds cut into blocks of 256 (the legacy loop's
    block), the last padded with dead-class seeds: (patterns int32 [F,
    256, L], classes int32 [F, 256], tables, max_iterations)."""
    padded, seed_class, tables, max_errors = search_chunk(
        sequences, seed, 256 * blocks - 40
    )
    F = -(-padded.shape[0] // 256)
    patterns = np.zeros((F * 256, padded.shape[1]), dtype=np.int32)
    patterns[:padded.shape[0]] = padded
    classes = np.full(F * 256, tables.dead_class, dtype=np.int32)
    classes[:padded.shape[0]] = seed_class
    max_iterations = (padded.shape[1] + max_errors + 2 * tables.num_parts
                      + 2)
    return (patterns.reshape(F, 256, -1), classes.reshape(F, 256), tables,
            max_iterations)


def frontier_against_plain(index, patterns, classes, tables, capacity,
                           reports, max_iterations, cluster=None):
    """K11 on F frontiers (one launch, clusters of `cluster` blocks or the
    wrapper's pick) against frontier_search_plain on the same card
    tensors, frontier by frontier: reports, count, overflow, iterations
    and expanded states equal. Returns the kernel's batch."""
    from floxer_tpu_torch.ops import cuda_frontier as k11
    from floxer_tpu_torch.ops.frontier import frontier_search_plain

    device = index.device
    operands = [torch.from_numpy(a).to(device)
                for a in (patterns, classes, tables.fused())]
    before = k11.LAUNCHES
    got = k11.frontier_search_cuda(index, *operands, tables.num_searches,
                                   tables.num_parts, capacity, reports,
                                   max_iterations, cluster)
    torch.cuda.synchronize()
    assert k11.LAUNCHES == before + 1
    for f in range(patterns.shape[0]):
        stats = {}
        want = frontier_search_plain(
            index, operands[0][f], operands[1][f], operands[2],
            tables.num_searches, tables.num_parts, capacity, reports,
            max_iterations, stats,
        )
        assert int(got.num_reports[f]) == want[1]
        assert torch.equal(got.reports[f], want[0])
        assert torch.equal(got.overflow[f], want[2])
        assert int(got.iterations[f]) == stats["iterations"]
        assert int(got.expanded[f]) == stats["expanded"]
    return got


@pytest.mark.parametrize("layout,cluster", [
    pytest.param("combined", None, id="combined"),
    pytest.param("planes", None, id="planes"),
] + [
    pytest.param("combined", cluster, id=f"combined-cluster{cluster}")
    for cluster in (1, 2, 4, 8, 16)
])
def test_frontier_kernel_matches_plain(cuda_device, search_index, layout,
                                       cluster):
    """K11 on three 256-seed blocks at the legacy loop's capacities
    (32768 states, 8192 reports), on one of them alone, and on one
    per-query bucket (16384 and 4096), equals the plain version, report
    order included: at the wrapper's pick of the cluster and at every
    cluster size the kernel takes (16 blocks only where the card places
    such a cluster; elsewhere the launch raises)."""
    from floxer_tpu_torch.ops import cuda_frontier as k11

    host, sequences = search_index
    index = device_index_of(host, cuda_device, layout)
    patterns, classes, tables, max_iterations = frontier_blocks(sequences)
    if cluster is not None and k11.max_clusters(cuda_device, cluster,
                                                False) < 1:
        with pytest.raises(RuntimeError, match="launch failed"):
            frontier_against_plain(index, patterns, classes, tables,
                                   1 << 15, 1 << 13, max_iterations, cluster)
        return
    got = frontier_against_plain(index, patterns, classes, tables, 1 << 15,
                                 1 << 13, max_iterations, cluster)
    assert not got.overflow.any() and int(got.num_reports.min()) > 100
    got = frontier_against_plain(index, patterns[:1], classes[:1], tables,
                                 1 << 15, 1 << 13, max_iterations, cluster)
    assert not got.overflow.any()
    got = frontier_against_plain(index, patterns[:1, :16], classes[:1, :16],
                                 tables, 1 << 14, 1 << 12, max_iterations,
                                 cluster)
    assert not got.overflow.any()


@pytest.mark.parametrize("cluster", [None, 2, 8])
def test_frontier_kernel_flags_overflow(cuda_device, search_index, cluster):
    """A frontier capacity below the states (2048 and 1100 states: with
    clusters of 2 and 8 blocks the cut falls inside a round's later
    blocks), and a report capacity below the reports, each set K11's
    overflow on every seed of its block as the plain version does, and
    the truncated frontier still reports."""
    host, sequences = search_index
    index = device_index_of(host, cuda_device, "combined")
    patterns, classes, tables, max_iterations = frontier_blocks(
        sequences, 2, 7
    )
    for capacity in (2048, 1100):
        states = frontier_against_plain(index, patterns, classes, tables,
                                        capacity, 1 << 13, max_iterations,
                                        cluster)
        assert states.overflow.all()
    reports = frontier_against_plain(index, patterns, classes, tables,
                                     1 << 15, 64, max_iterations, cluster)
    assert reports.overflow.all() and int(reports.num_reports.min()) == 64
    start = frontier_against_plain(index, patterns, classes, tables, 256,
                                   1 << 13, max_iterations, cluster)
    assert start.overflow.all() and int(start.iterations.max()) == 0


def select_groups(host, sequences, seed=41, count=120):
    """Real anchor groups of mutated seeds (and two repetitive ones) by
    the host DFS: (groups [G, 4], group_starts, totals, statuses)."""
    from floxer_tpu_torch.search_host import search_seed_groups

    rng = np.random.default_rng(seed)
    rows, totals = [], []
    patterns = []
    for i in range(count):
        source = sequences[i % 2]
        length = int(rng.integers(10, 16))
        start = int(rng.integers(0, len(source) - length))
        pattern = source[start:start + length].copy()
        pattern[int(rng.integers(0, length))] = 1 + int(rng.integers(0, 4))
        patterns.append((pattern, 1 + i % 2))
    patterns.append((np.full(10, 1, dtype=np.uint8), 2))
    patterns.append((np.array([1, 2, 3, 4] * 3, dtype=np.uint8), 1))
    for gid, (pattern, k) in enumerate(patterns):
        groups, total, _ = search_seed_groups(host, pattern, k, 1 << 30)
        totals.append(total)
        rows.extend((gid, g.num_errors, g.cursor.lb, g.cursor.length,
                     g.cursor.lb_rev) for g in groups)
    rows.sort()
    groups = np.array([(lb, lbr, ln, er) for _, er, lb, ln, lbr in rows],
                      dtype=np.int64).reshape(-1, 4)
    S = len(patterns)
    starts = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(np.bincount([r[0] for r in rows], minlength=S),
              out=starts[1:])
    statuses = np.zeros(S, dtype=np.int64)
    statuses[::17] = 2
    statuses[5::17] = 1
    return groups, starts, np.asarray(totals, dtype=np.int64), statuses


def edge_select_groups(n, seed=43, hard_cap=500):
    """Seeds at K12's edges, their groups at random SA rows below n - 300
    (so a row past a group's stays in the text): (groups [G, 4], group
    starts, totals, statuses, the seeds whose totals are their groups'
    rows and whose counts are positive, as the search's are). In order: a
    seed with no groups; one emission (E = 1); 60 groups of one row; three
    groups of 30, 20 and 25 rows (E = soft_cap after many rounds); a
    total past the hard cap; an overflow status; a total past its groups'
    rows (3 + 2 of 20); one group of one row in a total of 5 (E = 1 under
    round robin, 5 otherwise); a group of no rows before one of 4; and two
    groups of 2 rows beside an aborted status."""
    rng = np.random.default_rng(seed)
    counts_of = [[], [1], [1] * 60, [30, 20, 25], [2, 3], [2, 2], [3, 2],
                 [1], [0, 4], [2, 2]]
    totals = [3, 1, 60, 75, hard_cap + 1000, 4, 20, 5, 4, 4]
    statuses = [0, 0, 0, 0, 0, 2, 0, 0, 0, 1]
    consistent = [1, 2, 3, 5, 9]
    groups = []
    for counts in counts_of:
        for count in counts:
            groups.append((int(rng.integers(0, n - 300)), 0, count,
                           int(rng.integers(0, 3))))
    starts = np.zeros(len(counts_of) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in counts_of], out=starts[1:])
    return (np.asarray(groups, dtype=np.int64).reshape(-1, 4), starts,
            np.asarray(totals, dtype=np.int64),
            np.asarray(statuses, dtype=np.int64), consistent)


@pytest.mark.parametrize("erase", [True, False])
@pytest.mark.parametrize("choice_code", [0, 1, 2])
def test_select_kernel_matches_plain(cuda_device, search_index, choice_code,
                                     erase):
    """K12 against select_plain on the same card tensors, under each
    choice code, at the default caps (rows in shared memory) and at a
    soft cap of 200 (rows in global scratch), equal in every anchor row
    and count, on real groups and on the edge seeds (edge_select_groups,
    three times over, so a warp holds seeds of every kind); one launch
    each."""
    from floxer_tpu_torch import search_select_device as ssd
    from floxer_tpu_torch.ops import cuda_select as k12

    host, sequences = search_index
    index = device_index_of(host, cuda_device, "combined")
    edge = edge_select_groups(host.n)[:4]
    edge_groups = np.concatenate([edge[0]] * 3)
    edge_starts = np.concatenate(
        [[0], *(edge[1][1:] + k * edge[1][-1] for k in range(3))])
    batches = {
        "real": select_groups(host, sequences),
        "edge": (edge_groups, edge_starts, np.tile(edge[2], 3),
                 np.tile(edge[3], 3)),
    }

    def t(array):
        return torch.from_numpy(
            np.ascontiguousarray(array, dtype=np.int32)).to(cuda_device)

    for name, (groups, starts, totals, statuses) in batches.items():
        S = len(totals)
        gid = np.repeat(np.arange(S), np.diff(starts))
        for order_code, hard_cap, soft_cap in ((0, 500, 50), (1, 60, 7),
                                               (0, 500, 200)):
            perm = ssd.group_order(groups, starts, order_code)
            args = (index, t(groups[:, 0]), t(groups[:, 2]),
                    t(groups[:, 3]), t(gid), t(perm), t(starts), t(totals),
                    t(statuses), hard_cap, soft_cap, order_code,
                    choice_code, erase)
            before = k12.LAUNCHES
            got = k12.select_anchors_cuda(*args)
            torch.cuda.synchronize()
            assert k12.LAUNCHES == before + 1
            assert (k12.shared_bytes(soft_cap) == 0) == (soft_cap == 200)
            want = ssd.select_plain(*args)
            assert torch.equal(got[1], want[1]), name
            assert torch.equal(got[0], want[0]), name
            if name == "real":
                assert int(got[1][:, 1].sum()) > S
            if hard_cap == 60 and choice_code != 2:
                assert bool((got[1][:, 0] & 4).any())


@pytest.mark.parametrize("branch", [
    "reference", "FLOXER_TPU_DEVICE_SELECT",
    "FLOXER_TPU_SEARCH_NO_CHUNK_FUSE", "FLOXER_TPU_NO_NATIVE_SELECT",
])
def test_device_search_branches_match_host_search(cuda_device, simulated,
                                                  tmp_path, monkeypatch,
                                                  branch):
    """--device-search on the card through each branch of the reference
    writes the host search's SAM: --engine reference (the per-query
    frontier, K11), device select (K12, one launch a chunk), the legacy
    block loop (K11) and the per-query frontier without the native select
    (K11)."""
    from floxer_tpu_torch.ops import cuda_frontier as k11
    from floxer_tpu_torch.ops import cuda_select as k12

    def args(name, extra=()):
        return [
            "--reference", str(simulated / "genome.fasta"),
            "--queries", str(simulated / "reads.fastq"),
            "--output", str(tmp_path / name),
            "-p", "0.08", "--interval-optimization", *extra,
        ]

    assert pipeline.run(parse_and_validate(args("host.sam")),
                        use_device=False) == 0
    pipeline.start_device_warmup(cuda_device, device_search=True)
    pipeline.join_device_warmup()
    engine = "reference" if branch == "reference" else "batched"
    if branch != "reference":
        monkeypatch.setenv(branch, "1")
    before = (k11.LAUNCHES, k12.LAUNCHES)
    cli = parse_and_validate(
        args("device.sam", ["--engine", engine, "--device-search"])
    )
    assert pipeline.run(cli) == 0
    launched = (k11.LAUNCHES - before[0], k12.LAUNCHES - before[1])
    if branch == "FLOXER_TPU_DEVICE_SELECT":
        assert launched[0] == 0 and launched[1] > 0
    else:
        assert launched[0] > 0 and launched[1] == 0
    assert (tmp_path / "device.sam").read_bytes() == (
        tmp_path / "host.sam"
    ).read_bytes()


# ---- the row-sharded index: K13 (rank), K13l (locate) (csrc/fm_sharded.cu)
# and K11 over the shard tables, against their plain versions and the
# unsharded kernels


@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_sharded_kernels_match_plain_and_unsharded(cuda_device, search_index,
                                                   num_shards):
    """K13 (both directions, every position) and K13l (every row) equal
    their plain versions on the same card tensors and K9's and K9l's
    results; at 8 shards of the 39 kb index none is empty, and a second
    index of 300 rows leaves its last shards empty."""
    from floxer_tpu_torch.index import device_index as di
    from floxer_tpu_torch.index.fmindex import FmIndex
    from floxer_tpu_torch.ops import cuda_sharded as k13

    host, _ = search_index
    small = FmIndex([np.random.default_rng(3).integers(1, 5, 300)
                     .astype(np.uint8)])
    for index_host in (host, small):
        index = di.ShardedDeviceIndex.from_host(index_host, num_shards,
                                                cuda_device)
        flat = di.DeviceIndex.from_host(index_host, cuda_device)
        positions = torch.arange(index_host.n + 1, dtype=torch.int32,
                                 device=cuda_device)
        for single, flat_single in ((index.fwd, flat.fwd),
                                    (index.rev, flat.rev)):
            args = (single.rank_rows, single.block_offset,
                    single.shard_starts, single.shard_lengths)
            before = k13.RANK_LAUNCHES
            got = k13.fm_sharded_rank_cuda(positions, *args,
                                           single.shard_before)
            assert k13.RANK_LAUNCHES == before + 1
            assert torch.equal(got, k13.fm_sharded_rank_plain(positions,
                                                              *args))
            assert torch.equal(got, di.rank_all(flat_single, positions))
        rows = positions[:-1]
        before = k13.LOCATE_LAUNCHES
        got = k13.fm_sharded_locate_cuda(index, rows, index.sampling_rate)
        assert k13.LOCATE_LAUNCHES == before + 1
        want = k13.fm_sharded_locate_plain(index, rows, index.sampling_rate)
        flat_want = di.locate_batch(flat, rows)
        for g, w, f in zip(got, want, flat_want):
            assert torch.equal(g, w) and torch.equal(g, f)


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
def test_sharded_rank_owner_edges(cuda_device, search_index, num_shards):
    """K13 ranks only the shard that owns each position and adds the
    earlier shards' totals: equal to its plain version (every shard's
    clamped rank, summed in int64) at -1, 0, each shard's start and end
    and their neighbours, n, n + 1, the int32 extremes and seeded
    positions, in both directions, on the 39 kb index and on a 247-row
    one whose last shards are empty at 3 and 4 shards; without the
    totals it is refused."""
    from floxer_tpu_torch.index import device_index as di
    from floxer_tpu_torch.index.fmindex import FmIndex
    from floxer_tpu_torch.ops import cuda_sharded as k13

    host, _ = search_index
    rng = np.random.default_rng(47)
    small = FmIndex([rng.integers(1, 5, 200).astype(np.uint8),
                     rng.integers(1, 6, 45).astype(np.uint8)])
    for index_host in (host, small):
        index = di.ShardedDeviceIndex.from_host(index_host, num_shards,
                                                cuda_device)
        n = index_host.n
        edges = {-1, 0, n, n + 1, -2**31, 2**31 - 1}
        for start, length in zip(index.fwd.shard_starts.tolist(),
                                 index.fwd.shard_lengths.tolist()):
            edges |= {start - 1, start, start + 1, start + length,
                      start + length + 1}
        positions = torch.from_numpy(np.concatenate([
            np.array(sorted(edges), dtype=np.int64),
            rng.integers(-3, n + 4, size=20_000),
        ]).astype(np.int32)).to(cuda_device)
        for single in (index.fwd, index.rev):
            args = (single.rank_rows, single.block_offset,
                    single.shard_starts, single.shard_lengths)
            got = k13.fm_sharded_rank_cuda(positions, *args,
                                           single.shard_before)
            assert torch.equal(got, k13.fm_sharded_rank_plain(positions,
                                                              *args))
        with pytest.raises(ValueError, match="shard_before"):
            k13.fm_sharded_rank_cuda(positions, *args)


@pytest.mark.parametrize("num_shards,cluster", [
    pytest.param(2, None, id="2"),
    pytest.param(4, None, id="4"),
    pytest.param(2, 8, id="2-cluster8"),
    pytest.param(4, 2, id="4-cluster2"),
])
def test_sharded_frontier_kernel_matches_plain_and_unsharded(
    cuda_device, search_index, num_shards, cluster
):
    """K11 over the shard tables on three 256-seed blocks equals its plain
    version (frontier_against_plain) and the unsharded K11: reports in
    order, counts, overflow, iterations and expanded states, at the
    wrapper's pick of the cluster and at clusters of 8 and 2 blocks."""
    from floxer_tpu_torch.index import device_index as di
    from floxer_tpu_torch.ops import cuda_frontier as k11

    host, sequences = search_index
    index = di.ShardedDeviceIndex.from_host(host, num_shards, cuda_device)
    patterns, classes, tables, max_iterations = frontier_blocks(sequences)
    operands = [torch.from_numpy(a).to(cuda_device)
                for a in (patterns, classes, tables.fused())]
    before = k11.SHARDED_LAUNCHES
    got = k11.frontier_search_cuda(index, *operands, tables.num_searches,
                                   tables.num_parts, 1 << 15, 1 << 13,
                                   max_iterations, cluster)
    torch.cuda.synchronize()
    assert k11.SHARDED_LAUNCHES == before + 1
    flat = frontier_against_plain(device_index_of(host, cuda_device,
                                                  "combined"),
                                  patterns, classes, tables, 1 << 15,
                                  1 << 13, max_iterations)
    for field in ("reports", "num_reports", "overflow", "iterations",
                  "expanded"):
        assert torch.equal(getattr(got, field), getattr(flat, field)), field
    from floxer_tpu_torch.ops.frontier import frontier_search_plain

    for f in range(patterns.shape[0]):
        stats = {}
        want = frontier_search_plain(
            index, operands[0][f], operands[1][f], operands[2],
            tables.num_searches, tables.num_parts, 1 << 15, 1 << 13,
            max_iterations, stats,
        )
        assert int(got.num_reports[f]) == want[1]
        assert torch.equal(got.reports[f], want[0])
        assert torch.equal(got.overflow[f], want[2])
        assert int(got.expanded[f]) == stats["expanded"]


@pytest.mark.parametrize("engine", ["batched", "reference"])
def test_sharded_cli_matches_host_search(cuda_device, simulated, tmp_path,
                                         engine):
    """--index-shards 2 on the card writes the host search's SAM: under
    the batched engine the legacy block loop on K11 over the shards (no
    K10), under --engine reference the per-query frontier on it."""
    def args(name, extra=()):
        return [
            "--reference", str(simulated / "genome.fasta"),
            "--queries", str(simulated / "reads.fastq"),
            "--output", str(tmp_path / name),
            "-p", "0.08", "--interval-optimization", *extra,
        ]

    assert pipeline.run(parse_and_validate(args("host.sam")),
                        use_device=False) == 0
    pipeline.start_device_warmup(cuda_device, device_search=True)
    pipeline.join_device_warmup()
    before = pipeline.kernel_launches()
    cli = parse_and_validate(
        args("sharded.sam", ["--engine", engine, "--index-shards", "2"])
    )
    assert pipeline.run(cli) == 0
    after = pipeline.kernel_launches()
    assert after["K11s"] > before["K11s"]
    assert after["K11"] == before["K11"]
    assert after["K10"] == before["K10"]
    assert (tmp_path / "sharded.sam").read_bytes() == (
        tmp_path / "host.sam"
    ).read_bytes()


def test_platform_cpu_launches_no_kernel(cuda_device, simulated, tmp_path,
                                         monkeypatch):
    """FLOXER_TPU_PLATFORM=cpu on a machine with the card (fault F2,
    repaired): --engine batched keeps every wave on the host, launches no
    kernel and writes the host engine's SAM."""
    def args(name, extra=()):
        return [
            "--reference", str(simulated / "genome.fasta"),
            "--queries", str(simulated / "reads.fastq"),
            "--output", str(tmp_path / name),
            "-p", "0.08", "--interval-optimization", *extra,
        ]

    assert pipeline.run(parse_and_validate(args("host.sam")),
                        use_device=False) == 0
    monkeypatch.setenv("FLOXER_TPU_PLATFORM", "cpu")
    before = pipeline.kernel_launches()
    cli = parse_and_validate(args("cpu.sam", ["--engine", "batched"]))
    assert pipeline.run(cli) == 0
    assert pipeline.kernel_launches() == before
    assert (tmp_path / "cpu.sam").read_bytes() == (
        tmp_path / "host.sam"
    ).read_bytes()
