"""The port's device anchor selection (floxer_tpu_torch.search_select_device:
select_plain, K12's plain version, through device_select_from_groups_batch)
against the port's native select and the reference's _select_kernel (XLA on
the CPU).

On real FM-index groups (the reference's tests/test_select_device.py
fixture: unique, mutated, repetitive and junk seeds, an empty seed, the
hard cap excluding some), select_plain and emulate_k12, a numpy mirror of
K12's warp program (csrc/select_anchors.cu: a lane a seed of at most one
valid emission, the warp for each larger one), must give the native
select's counts and written anchor rows exactly (integer equality) under
all 18 configurations (3 group orders x 3 choices x erase or not) at three
cap pairs, with the incoming status bits, emulate_k12 every slot of
select_plain's, and the reference's _select_kernel on four of them (its
jit is slow on the CPU). Seeds at the kernel's edges (no groups, one
emission, more groups than the soft cap, many rounds, the caps and
statuses, totals past their groups' rows, a group of no rows) are held to
select_plain, to the native select where it emits the same rows, and to
the reference's _select_kernel on three configurations.
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
from test_torch_cuda import edge_select_groups

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
    """K12 (csrc/select_anchors.cu) in numpy, a warp (32 seeds) at a time
    on its own schedule: the warp's zeros over its anchor rows; each
    lane's status, caps and counts row, and its seed's emission count E
    told apart as the kernel scans its groups (0, 1, or at least 2); the
    batch of max(64, soft_cap) emissions, first each E = 1 seed's one
    (round robin: the first group that counts a row; the others: column
    0), then each larger seed's, expanded by the warp (round robin by
    ballot rounds over chunks of 32 live columns, full_groups by a warp
    scan of the capped row prefix and an upper bound per emission) while
    it fits, else into the next batch; each batch's locates, then its E = 1
    seeds' anchors by their lanes and each larger seed's rank of each key
    among its E, lane 0's sweep with its retroactive marks and the ballot
    compaction. Every slot starts as -1, so a slot the kernel would not
    write shows. Returns (anchors int64 [S, soft_cap, 3], counts int64
    [S, 5])."""
    CAP = soft_cap
    size = max(64, CAP)
    S = len(totals)
    perm = ssd.group_order(groups, group_starts, order_code)
    totals = np.minimum(totals, I32MAX)
    lb_of, cnt_of, err_of = groups[:, 0], groups[:, 2], groups[:, 3]
    anchors = np.full((S, CAP, 3), -1, dtype=np.int64)
    counts = np.full((S, 5), -1, dtype=np.int64)
    lanes = np.arange(32)

    def expand(first, live, kept_raw):
        """A large seed's E and its emissions (SA rows, errors)."""
        cols = perm[first:first + live]
        d_lb, d_cnt, d_err = lb_of[cols], cnt_of[cols], err_of[cols]
        if choice_code == 0:
            rows_here = np.zeros(32, dtype=np.int64)
            for c in range(live):
                rows_here[c % 32] = min(
                    rows_here[c % 32] + min(max(d_cnt[c], 0), CAP), CAP)
            E = min(kept_raw, int(rows_here.sum()))
            em_row = np.zeros(E, dtype=np.int64)
            em_err = np.zeros(E, dtype=np.int64)
            base, r = 0, 0
            while base < E:
                for c0 in range(0, live, 32):
                    c = c0 + lanes
                    take = (c < live) & (np.where(
                        c < live, d_cnt[np.minimum(c, live - 1)], 0) > r)
                    e = base + np.cumsum(take) - take
                    for lane in np.flatnonzero(take & (e < E)):
                        em_row[e[lane]] = d_lb[c[lane]] + r
                        em_err[e[lane]] = d_err[c[lane]]
                    base += int(take.sum())
                r += 1
            return E, em_row, em_err
        E = kept_raw
        aux = np.zeros(live, dtype=np.int64)
        col = np.zeros(live, dtype=np.int64)
        carry = counting = 0
        for c0 in range(0, live, 32):
            c = c0 + lanes
            n = np.where(c < live, d_cnt[np.minimum(c, live - 1)], 0)
            n = np.clip(n, 0, CAP)
            inclusive = np.cumsum(n)
            nonzero = n > 0
            here = c < live
            aux[c[here]] = (carry + inclusive - n)[here]
            col[c[here]] = (counting + np.cumsum(nonzero) - 1)[here]
            carry = min(carry + int(inclusive[-1]), CAP)
            counting += int(nonzero.sum())
        em_row = np.zeros(E, dtype=np.int64)
        em_err = np.zeros(E, dtype=np.int64)
        for e in range(E):
            g = int(col[int(np.searchsorted(aux, e, side="right")) - 1])
            em_row[e], em_err[e] = d_lb[g] + e - aux[g], d_err[g]
        return E, em_row, em_err

    def finish(ref, pos, em_err, kept_raw, out):
        """A located large seed's order, sweep and output: the anchors
        written."""
        E = ref.shape[0]
        order = np.zeros(E, dtype=np.int64)
        for e in range(E):
            if erase:
                less = ((ref < ref[e]) | ((ref == ref[e]) & (pos < pos[e]))
                        | ((ref == ref[e]) & (pos == pos[e])
                           & (np.arange(E) < e)))
            else:
                less = (ref < ref[e]) | ((ref == ref[e])
                                         & (np.arange(E) < e))
            order[int(less.sum())] = e
        if not erase:
            for c in range(E):
                a = order[c]
                out[c] = (ref[a], pos[a], em_err[a])
            return kept_raw
        mark = np.zeros(E, dtype=bool)
        p_ref, p_pos, p_err, p_idx, p_live = -1, 0, 0, 0, False
        for c in range(E):  # lane 0
            a = order[c]
            same = p_live and ref[a] == p_ref
            d = abs(p_pos - pos[a])
            piv = same and p_err <= em_err[a] and d <= em_err[a] - p_err
            a_dom = same and em_err[a] <= p_err and d <= p_err - em_err[a]
            mark[c] |= piv
            if same and not piv and a_dom:
                mark[p_idx] = True
            if not same or not piv:
                p_ref, p_pos, p_err, p_idx = ref[a], pos[a], em_err[a], c
            p_live = True
        written = 0
        for c0 in range(0, E, 32):
            c = c0 + lanes
            keep = (c < E) & ~mark[np.minimum(c, E - 1)]
            slot = written + np.cumsum(keep) - keep
            for lane in np.flatnonzero(keep):
                a = order[c[lane]]
                out[slot[lane]] = (ref[a], pos[a], em_err[a])
            written += int(keep.sum())
        return written

    for first_seed in range(0, S, 32):
        seeds = min(32, S - first_seed)
        anchors[first_seed:first_seed + seeds] = 0
        head = []
        for lane in range(seeds):
            seed = first_seed + lane
            total = int(totals[seed])
            excluded = total > hard_cap and choice_code != 2
            status = int(statuses[seed]) | (4 if excluded else 0)
            kept_raw = min(total, CAP) if (status & 6) == 0 else 0
            first = int(group_starts[seed])
            live = min(int(group_starts[seed + 1]) - first, CAP)
            counting_col, large = -1, False
            if kept_raw > 0:
                for c in range(live):
                    n = cnt_of[perm[first + c]]
                    if n <= 0:
                        continue
                    if counting_col >= 0:
                        large = True
                        break
                    counting_col = c
                    if kept_raw == 1:
                        break
                    if choice_code != 0 or n >= 2:
                        large = True
                        break
            written = (counting_col >= 0) if erase else kept_raw
            counts[seed] = (status, written, kept_raw, written, total)
            head.append((seed, kept_raw, first, live, counting_col, large))
        # the first batch: the E = 1 seeds' emissions, in lane order
        em_rows, em_errs, batch = [], [], []
        for seed, kept_raw, first, live, counting_col, large in head:
            if counting_col >= 0 and not large:
                g = perm[first + (counting_col if choice_code == 0 else 0)]
                batch.append((seed, len(em_rows), 1, kept_raw))
                em_rows.append(lb_of[g])
                em_errs.append(err_of[g])
        pending = [h for h in head if h[5]]
        while True:
            while pending:
                seed, kept_raw, first, live, _, _ = pending[0]
                E, rows, errs = expand(first, live, kept_raw)
                if len(em_rows) + E > size:
                    break
                batch.append((seed, len(em_rows), E, kept_raw))
                em_rows.extend(rows)
                em_errs.extend(errs)
                pending.pop(0)
            seq, at = locate_batch(index, torch.from_numpy(
                np.asarray(em_rows, dtype=np.int32).reshape(-1)))
            ref = seq.numpy().astype(np.int64)
            pos = at.numpy().astype(np.int64)
            em_err = np.asarray(em_errs, dtype=np.int64).reshape(-1)
            for seed, off, E, kept_raw in batch:
                if E == 1:
                    anchors[seed, 0] = (ref[off], pos[off], em_err[off])
            for seed, off, E, kept_raw in batch:
                if E >= 2:
                    part = slice(off, off + E)
                    written = finish(ref[part], pos[part], em_err[part],
                                     kept_raw, anchors[seed])
                    if erase:
                        counts[seed, 1] = counts[seed, 3] = written
            if not pending:
                break
            em_rows, em_errs, batch = [], [], []
    return anchors, counts


def assert_equal_selection(got, want, label):
    """Every anchor slot and count equal (K12 and select_plain write the
    whole [S, soft_cap, 3], zeros past a seed's anchors)."""
    np.testing.assert_array_equal(got[1], np.asarray(want[1]), err_msg=label)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]), err_msg=label)


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
        assert_equal_selection(emulated, got, f"emulate_k12 {label}")
        if hard_cap == 40 and choice_code != 2:
            assert (got[1][:, 0] & 4).any(), "the hard cap excluded no seed"


def seeds_subset(groups, starts, totals, statuses, keep):
    """The batch of only the seeds `keep` (their groups, in order)."""
    rows = np.concatenate([np.arange(starts[s], starts[s + 1])
                           for s in keep]).astype(np.int64)
    sizes = np.diff(starts)[keep]
    sub_starts = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(sizes, out=sub_starts[1:])
    return groups[rows], sub_starts, totals[keep], statuses[keep]


@pytest.mark.parametrize("erase", [False, True])
@pytest.mark.parametrize("choice_code", [0, 1, 2])
def test_select_edge_seeds(fixture, choice_code, erase):
    """Seeds at K12's edges (test_torch_cuda.edge_select_groups: no groups,
    E = 1, 60 groups, many rounds, the hard cap, an overflow, a total past
    its groups' rows, a group of no rows) under every group order at the
    three cap pairs: emulate_k12 equals select_plain in every slot, and
    both equal the native select on the seeds whose totals are their
    groups' rows (the native select emits only real rows)."""
    host = fixture["host"]
    groups, starts, totals, statuses, consistent = edge_select_groups(host.n)
    for (hard_cap, soft_cap), order_code in itertools.product(CAPS,
                                                              range(3)):
        caps = (hard_cap, soft_cap, order_code, choice_code, erase)
        label = f"caps={hard_cap}/{soft_cap} order={order_code}"
        plain = ssd.device_select_from_groups_batch(
            fixture["device"], groups, starts, totals, statuses, *caps)
        emulated = emulate_k12(fixture["device"], groups, starts, totals,
                               statuses, *caps)
        assert_equal_selection(emulated, plain, label)
        sub = seeds_subset(groups, starts, totals, statuses, consistent)
        want = native_select_from_groups_batch(host, *sub, *caps)
        assert_same_selection(
            (plain[0][consistent], plain[1][consistent]), want, label)
        emitted = plain[1][:, 1]
        if erase is False:
            assert emitted[1] == 1 and emitted[0] == min(3, soft_cap)
        if soft_cap == 50 and choice_code == 0 and hard_cap == 500:
            assert plain[1][3, 2] == 50  # many rounds, E = soft_cap


@pytest.mark.parametrize("config", [(2, 0, True), (0, 1, False),
                                    (2, 2, True)])
def test_edge_seeds_match_reference_select_kernel(fixture, config):
    """select_plain (K12's plain version) on the edge seeds equals the
    reference's _select_kernel, which defines its formulas past the native
    select's (a total past its groups' rows, a group of no rows)."""
    order_code, choice_code, erase = config
    ref_device = RefDeviceIndex.from_host(RefFmIndex(fixture["sequences"]))
    groups, starts, totals, statuses, _ = edge_select_groups(
        fixture["host"].n)
    args = (groups, starts, totals, statuses, 500, 50, order_code,
            choice_code, erase)
    want = ref_device_select(ref_device, *args)
    got = ssd.device_select_from_groups_batch(fixture["device"], *args)
    assert_equal_selection(got, want, f"config {config}")


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
    """A block's 8 warps keep their rows in shared memory up to 48 KB (the
    expanded seed's 5 arrays of soft_cap and the batch's 6 of
    max(64, soft_cap): soft_cap <= 139), else in global scratch; the
    constants are the kernel's."""
    smem = cuda_select.shared_bytes(soft_cap)
    fits = soft_cap <= 139
    assert (smem > 0) == fits
    words = 5 * soft_cap + 6 * max(64, soft_cap)
    assert cuda_select.warp_words(soft_cap) == words
    if fits:
        assert smem == cuda_select.WARPS * words * 4
    source = (ROOT / cuda_select.SOURCE).read_text()
    assert int(re.search(r"constexpr int kWarps = (\d+);",
                         source).group(1)) == cuda_select.WARPS
    assert int(re.search(r"constexpr int kBatchMin = (\d+);",
                         source).group(1)) == cuda_select.BATCH_MIN
    for first, last, count in (("cLb", "kColumnArrays",
                                cuda_select.COLUMN_ARRAYS),
                               ("bRow", "kBatchArrays",
                                cuda_select.BATCH_ARRAYS)):
        arrays = re.search(rf"enum \{{ ({first}.*?){last} \}};", source,
                           re.S)
        assert len(re.findall(r"[cb][A-Z]\w*", arrays.group(1))) == count


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
