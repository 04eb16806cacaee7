"""The port's device anchor selection (floxer_tpu_torch.search_select_device:
select_plain, K12's plain version, through device_select_from_groups_batch)
against the port's native select and the reference's _select_kernel (XLA on
the CPU).

On real FM-index groups (the reference's tests/test_select_device.py
fixture: unique, mutated, repetitive and junk seeds, an empty seed, the
hard cap excluding some), select_plain and emulate_k12, a numpy mirror of
K12's per-seed warp program (csrc/select_anchors.cu), must give the native
select's counts and written anchor rows exactly (integer equality) under
all 18 configurations (3 group orders x 3 choices x erase or not) at three
cap pairs, with the incoming status bits, and the reference's
_select_kernel on four of them (its jit is slow on the CPU).
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from floxer_tpu.index.device_index import DeviceIndex as RefDeviceIndex
from floxer_tpu.index.fmindex import FmIndex as RefFmIndex
from floxer_tpu.search_select_device import (
    device_select_from_groups_batch as ref_device_select,
)
from floxer_tpu_torch import search_select_device as ssd
from floxer_tpu_torch.index.device_index import DeviceIndex, locate_batch
from floxer_tpu_torch.index.fmindex import FmIndex
from floxer_tpu_torch.native import native_select_from_groups_batch
from floxer_tpu_torch.ops import cuda_select
from floxer_tpu_torch.search_host import search_seed_groups

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
CAPS = [(500, 9), (40, 7), (500, 50)]
I32MAX = 2**31 - 1


@pytest.fixture(scope="module")
def fixture():
    """The reference test's groups, made with the port's host index:
    (host index, device index, groups [G, 4], group_starts, totals, the
    sequences)."""
    rng = np.random.default_rng(23)
    base = rng.integers(1, 5, size=2000).astype(np.uint8)
    motif = base[100:112].copy()
    sequences = []
    for _ in range(2):
        seq = rng.integers(1, 5, size=1500).astype(np.uint8)
        for _ in range(20):
            at = int(rng.integers(0, len(seq) - len(motif)))
            seq[at:at + len(motif)] = motif
        sequences.append(seq)
    sequences.append(base)
    host = FmIndex(sequences)

    seeds = []
    for trial in range(10):
        src = sequences[trial % len(sequences)]
        start = int(rng.integers(0, len(src) - 12))
        pattern = src[start:start + 12].copy()
        if trial % 3 == 1:
            pattern[int(rng.integers(0, 12))] = 1 + int(rng.integers(0, 4))
        seeds.append((pattern, 1 + trial % 2))
    seeds.append((motif.copy(), 2))  # repetitive: many groups
    seeds.append((np.full(12, 1, dtype=np.uint8), 2))  # homopolymer
    seeds.append((np.array([1, 2, 3, 4] * 3, dtype=np.uint8), 0))

    rows = []
    totals = np.zeros(len(seeds) + 1, dtype=np.int64)  # +1 empty seed
    for gid, (pattern, k) in enumerate(seeds):
        groups, total, aborted = search_seed_groups(
            host, pattern, k, 1 << 30, allow_native=False
        )
        assert not aborted
        totals[gid] = total
        for g in groups:
            rows.append((gid, g.num_errors, g.cursor.lb, g.cursor.length,
                         g.cursor.lb_rev))
    num_seeds = len(seeds) + 1
    rows.sort()  # canonical (gid, errors, lb, len), as the reference's
    groups = np.array(
        [(lb, lbr, ln, er) for _, er, lb, ln, lbr in rows], dtype=np.int64
    ).reshape(-1, 4)
    gid_of_group = np.array([r[0] for r in rows], dtype=np.int64)
    group_starts = np.zeros(num_seeds + 1, dtype=np.int64)
    np.cumsum(np.bincount(gid_of_group, minlength=num_seeds),
              out=group_starts[1:])
    return {
        "host": host, "device": DeviceIndex.from_host(host, CPU),
        "planes": DeviceIndex.from_host(host, CPU, force_planes=True),
        "groups": groups, "group_starts": group_starts, "totals": totals,
        "sequences": sequences,
    }


def emulate_k12(index, groups, group_starts, totals, statuses, hard_cap,
                soft_cap, order_code, choice_code, erase):
    """K12 (csrc/select_anchors.cu) in numpy, one seed (a warp) at a time:
    the seed's first soft_cap groups in the host order, each emission's
    round or group counted over the soft_cap columns, the locate of the
    valid ones (the others take ref INT32_MAX), each emission's rank among
    the keys, lane 0's sweep with its marks and its compaction. Returns
    (anchors int64 [S, soft_cap, 3], counts int64 [S, 5])."""
    CAP = soft_cap
    S = len(totals)
    perm = ssd.group_order(groups, group_starts, order_code)
    totals = np.minimum(totals, I32MAX)
    anchors = np.zeros((S, CAP, 3), dtype=np.int64)
    counts = np.zeros((S, 5), dtype=np.int64)
    for s in range(S):
        total = int(totals[s])
        excluded = total > hard_cap and choice_code != 2
        status = int(statuses[s]) | (4 if excluded else 0)
        kept_raw = min(total, CAP) if (status & 6) == 0 else 0
        first, last = int(group_starts[s]), int(group_starts[s + 1])
        d_lb = np.zeros(CAP, dtype=np.int64)
        d_cnt = np.zeros(CAP, dtype=np.int64)
        d_err = np.zeros(CAP, dtype=np.int64)
        for c in range(min(CAP, last - first)):
            g = perm[first + c]
            d_lb[c], d_cnt[c], d_err[c] = groups[g, 0], groups[g, 2], groups[g, 3]
        row = np.zeros(CAP, dtype=np.int64)
        em_err = np.zeros(CAP, dtype=np.int64)
        valid = np.zeros(CAP, dtype=bool)
        if choice_code == 0:
            n_r = np.array([(d_cnt > r).sum() for r in range(CAP)])
            aux = np.cumsum(n_r) - n_r
            for e in range(CAP):
                r = int((aux <= e).sum()) - 1
                k = e - aux[r]
                seen, got, pick_lb, pick_err = 0, False, 0, 0
                for c in range(CAP):
                    if d_cnt[c] > r:
                        seen += 1
                        if seen == k + 1:
                            got, pick_lb, pick_err = True, d_lb[c], d_err[c]
                row[e], em_err[e] = pick_lb + r, pick_err
                valid[e] = got and e < kept_raw
        else:
            aux = np.cumsum(d_cnt) - d_cnt
            for e in range(CAP):
                g = int(((aux <= e) & (d_cnt > 0)).sum()) - 1
                g_cl = min(max(g, 0), CAP - 1)
                row[e] = d_lb[g_cl] + e - aux[g_cl]
                em_err[e] = d_err[g_cl]
                valid[e] = g >= 0 and e < kept_raw
        ref = np.full(CAP, I32MAX, dtype=np.int64)
        pos = np.zeros(CAP, dtype=np.int64)
        chosen = np.flatnonzero(valid)
        if chosen.size:
            seq, at = locate_batch(index, torch.from_numpy(
                row[chosen].astype(np.int32)))
            ref[chosen], pos[chosen] = seq.numpy(), at.numpy()

        def less(a, b):
            if ref[a] != ref[b]:
                return ref[a] < ref[b]
            if erase and pos[a] != pos[b]:
                return pos[a] < pos[b]
            return a < b

        order = np.zeros(CAP, dtype=np.int64)
        for e in range(CAP):
            order[sum(less(f, e) for f in range(CAP))] = e
        if erase:
            mark = np.zeros(CAP, dtype=bool)
            p_ref, p_pos, p_err, p_idx, p_live = -1, 0, 0, 0, False
            for c in range(CAP):
                a = order[c]
                same = bool(valid[a]) and p_live and ref[a] == p_ref
                d = abs(p_pos - pos[a])
                piv = same and p_err <= em_err[a] and d <= em_err[a] - p_err
                a_dom = same and em_err[a] <= p_err and d <= p_err - em_err[a]
                mark[c] |= piv
                if same and not piv and a_dom:
                    mark[p_idx] = True
                if (valid[a] and not same) or (same and not piv):
                    p_ref, p_pos, p_err, p_idx = ref[a], pos[a], em_err[a], c
                p_live = p_live or bool(valid[a])
            written = 0
            for c in range(CAP):
                a = order[c]
                if valid[a] and not mark[c]:
                    anchors[s, written] = (ref[a], pos[a], em_err[a])
                    written += 1
        else:
            for c in range(CAP):
                a = order[c]
                if valid[a]:
                    anchors[s, c] = (ref[a], pos[a], em_err[a])
            written = kept_raw
        counts[s] = (status, written, kept_raw, written, total)
    return anchors, counts


def assert_same_selection(got, want, label):
    """Equal counts, and equal anchor rows where written (the native
    select leaves the tail of each seed's rows unwritten)."""
    g_anchors, g_counts = got
    w_anchors, w_counts = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(g_counts, w_counts, err_msg=label)
    for s in range(w_counts.shape[0]):
        nw = int(w_counts[s, 1])
        np.testing.assert_array_equal(g_anchors[s, :nw], w_anchors[s, :nw],
                                      err_msg=f"{label} seed {s}")


def statuses_of(fixture):
    statuses = np.zeros(len(fixture["totals"]), dtype=np.int64)
    statuses[0] = 2  # overflow: skipped
    statuses[3] = 1  # aborted: selected as usual
    return statuses


@pytest.mark.parametrize("erase", [False, True])
@pytest.mark.parametrize("choice_code", [0, 1, 2])
@pytest.mark.parametrize("order_code", [0, 1, 2])
def test_select_matches_native(fixture, order_code, choice_code, erase):
    """select_plain (through device_select_from_groups_batch) and
    emulate_k12 against the native select, at three cap pairs."""
    statuses = statuses_of(fixture)
    args = (fixture["groups"], fixture["group_starts"], fixture["totals"],
            statuses)
    for hard_cap, soft_cap in CAPS:
        label = (f"caps={hard_cap}/{soft_cap} order={order_code} "
                 f"choice={choice_code} erase={erase}")
        want = native_select_from_groups_batch(
            fixture["host"], *args, hard_cap, soft_cap, order_code,
            choice_code, erase,
        )
        got = ssd.device_select_from_groups_batch(
            fixture["device"], *args, hard_cap, soft_cap, order_code,
            choice_code, erase,
        )
        assert_same_selection(got, want, label)
        emulated = emulate_k12(fixture["device"], *args, hard_cap, soft_cap,
                               order_code, choice_code, erase)
        assert_same_selection(emulated, want, f"emulate_k12 {label}")
        if hard_cap == 40 and choice_code != 2:
            assert (got[1][:, 0] & 4).any(), "the hard cap excluded no seed"


def test_status_bits_and_planes_layout(fixture):
    """An overflow status skips its seed entirely and is kept; the planes
    rank layout selects the same anchors."""
    statuses = statuses_of(fixture)
    args = (fixture["groups"], fixture["group_starts"], fixture["totals"],
            statuses, 500, 9, 0, 0, True)
    want = native_select_from_groups_batch(fixture["host"], *args)
    got = ssd.device_select_from_groups_batch(fixture["planes"], *args)
    assert_same_selection(got, want, "planes")
    assert got[1][0, 0] & 2 and got[1][0, 1] == 0 and got[1][3, 0] == 1


@pytest.mark.parametrize("config", [(0, 0, True), (1, 1, False),
                                    (2, 2, True), (0, 2, False)])
def test_select_matches_reference_select_kernel(fixture, config):
    """The reference's _select_kernel (through its
    device_select_from_groups_batch) on four configurations."""
    order_code, choice_code, erase = config
    ref_host = RefFmIndex(fixture["sequences"])
    ref_device = RefDeviceIndex.from_host(ref_host)
    statuses = statuses_of(fixture)
    args = (fixture["groups"], fixture["group_starts"], fixture["totals"],
            statuses, 40, 7, order_code, choice_code, erase)
    want = ref_device_select(ref_device, *args)
    got = ssd.device_select_from_groups_batch(fixture["device"], *args)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_select_plain_takes_the_reference_arguments(fixture):
    """select_plain on its own arguments (the reference kernel's): int32
    anchors [S, soft_cap, 3] and counts [S, 5]; an empty batch gives empty
    results."""
    groups, starts = fixture["groups"], fixture["group_starts"]
    S, G = len(fixture["totals"]), groups.shape[0]
    gid = np.repeat(np.arange(S), np.diff(starts))

    def t(array):
        return torch.from_numpy(np.ascontiguousarray(array, dtype=np.int32))

    anchors, counts = ssd.select_plain(
        fixture["device"], t(groups[:, 0]), t(groups[:, 2]), t(groups[:, 3]),
        t(gid), t(np.arange(G)), t(starts), t(fixture["totals"]),
        t(np.zeros(S)), 500, 9, 2, 0, True,
    )
    assert anchors.shape == (S, 9, 3) and anchors.dtype == torch.int32
    assert counts.shape == (S, 5) and counts.dtype == torch.int32
    empty = ssd.device_select_from_groups_batch(
        fixture["device"], np.zeros((0, 4), np.int64), np.zeros(1, np.int64),
        np.zeros(0, np.int64), np.zeros(0, np.int64), 500, 9, 0, 0, True,
    )
    assert empty[0].shape == (0, 9, 3) and empty[1].shape == (0, 5)


def test_cuda_wrapper_refuses_cpu_operands(fixture):
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_select.select_anchors_cuda(
            fixture["device"], z, z, z, z, z, torch.zeros(2, dtype=torch.int32),
            z, z, 500, 9, 0, 0, True,
        )


@pytest.mark.parametrize("soft_cap", [1, 50, 139, 140, 500])
def test_rows_go_to_global_scratch_past_shared_memory(soft_cap):
    """A block's 8 seeds keep 11 arrays of soft_cap in shared memory up
    to 48 KB (soft_cap <= 139), else in global scratch."""
    smem = cuda_select.shared_bytes(soft_cap)
    fits = soft_cap <= 139
    assert (smem > 0) == fits
    if fits:
        assert smem == cuda_select.WARPS * cuda_select.ARRAYS * soft_cap * 4
    source = (ROOT / cuda_select.SOURCE).read_text()
    assert int(re.search(r"constexpr int kWarps = (\d+);",
                         source).group(1)) == cuda_select.WARPS
    arrays = re.search(r"enum \{ (aLb.*?)kArrays \};", source, re.S)
    assert len(re.findall(r"a[A-Z]\w*", arrays.group(1))) == \
        cuda_select.ARRAYS


def test_group_order_is_the_native_order(fixture):
    """Every configuration's permutation keeps each seed's groups inside
    its segment (the kernel reads a seed's groups from group_starts)."""
    groups, starts = fixture["groups"], fixture["group_starts"]
    for order_code in range(3):
        perm = ssd.group_order(groups, starts, order_code)
        for s in range(len(starts) - 1):
            a, b = starts[s], starts[s + 1]
            assert sorted(perm[a:b].tolist()) == list(range(a, b))
    assert list(itertools.chain(ssd.group_order(groups, starts, 2))) == \
        list(range(groups.shape[0]))
