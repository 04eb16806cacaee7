"""K1's multi-warp kernel (csrc/myers_banded_wide.cu) as a numpy mirror of
its schedule, held to myers_banded_plain and to the reference's numpy
banded function.

The kernel's warps meet through a ring of shared-memory slots, one a
column, each with an mbarrier of one arrival a warp: a warp publishes its
word and arrives, does what needs no other warp, then waits on the slot
and reads the words of the warps below it and of the warp above it. Every
sliding column but the last writes the next column's state already slid
(the merged slide). The mirror runs the warps one half-column at a time
in an order of its choosing (`order`: the lowest warp that can go on
first, the highest first, or in turns), so a warp runs as far ahead of the
others as the waits let it; it models the barriers' phases as
try_wait.parity sees them and raises on a read before its producer's
arrival, on a word overwritten before every reader took it, and on a
barrier two phases ahead of a waiter, so a race in the schedule shows on
the CPU. Each comparison of (distance, end) is exact.
"""

import numpy as np
import pytest
import torch

from floxer_tpu.ops.device_dp import pad_batch
from floxer_tpu.ops.myers_banded import myers_banded_np
from floxer_tpu_torch.ops import cuda_myers_banded

CPU = torch.device("cpu")
MASK = 0xFFFFFFFF
LANES = np.arange(32, dtype=np.int64)
TOP = 1 << 31


class ScheduleError(AssertionError):
    """A read, write or wait the kernel's protocol does not order."""


def ballot(bits):
    """Per-lane 0/1 bits [..., 32] -> the warp's ballot masks [...]."""
    return (bits.astype(np.int64) << LANES).sum(-1)


def head_bits(vp, vn, p0, p1, p2, am):
    """The bit 0 of each array, packed as csrc/myers_banded_column.cuh's
    head_bits (bit 0 VP, 1 VN, 2-4 the char planes, 5 AM)."""
    return ((vp & 1) | ((vn & 1) << 1) | ((p0 & 1) << 2) | ((p1 & 1) << 3)
            | ((p2 & 1) << 4) | ((am & 1) << 5))


def slide(x, entering):
    """Each lane's words one bit toward word 0, bit 0 of `entering` [...,
    32] entering at the top of the lane's last word."""
    nxt = np.concatenate([x[..., 1:] & 1, (entering & 1)[..., None]], -1)
    return (x >> 1) | (nxt << 31)


class WideExchange:
    """The kernel's schedule on K1's operands (numpy, as myers_banded
    takes them) at `warps` warps of 32 lanes with R words each, through a
    ring of `ring` slots; tasks run together, each masked to its own
    columns."""

    def __init__(self, args, warps, R, ring=2):
        vp0, planes0, texts, stream, scalars, band_words, _ = args
        assert band_words == 32 * warps * R
        self.W, self.R, self.D = warps, R, ring
        T = vp0.shape[0]
        shape = (T, warps, 32, R)

        def unsigned(a):
            return a.astype(np.int64) & MASK

        self.vp = unsigned(vp0).reshape(shape)
        self.vn = np.zeros(shape, dtype=np.int64)
        self.planes = [unsigned(planes0[:, i]).reshape(shape)
                       for i in range(4)]
        self.texts, self.stream = unsigned(texts), unsigned(stream)
        sc = scalars.astype(np.int64)
        self.tlen, self.jstar, self.topshift = sc[:, 0], sc[:, 1], sc[:, 2]
        self.mfrozen = (sc[:, 3] != 0).astype(np.int64)
        m, k = sc[:, 4], sc[:, 5]
        self.num_chars = self.texts.shape[1] * 8
        self.last_col = np.minimum(self.tlen - 1, self.num_chars)
        self.slide_end = np.minimum(self.jstar, self.last_col)
        self.s_bot, self.s_m, self.best = k.copy(), m.copy(), m.copy()
        self.best_end = np.zeros(T, dtype=np.int64)
        # lane 31's head: the initial word 0 of the warp above
        self.head = np.zeros((T, warps), dtype=np.int64)
        self.head[:, :-1] = head_bits(
            self.vp[:, 1:, 0, 0], 0, *(p[:, 1:, 0, 0] for p in self.planes))
        # the ring: each slot's word of each warp, the column it holds, the
        # readers that took it, and each barrier's completed phases
        self.words = np.zeros((ring, warps, T), dtype=np.int64)
        self.tag = np.full((ring, warps), -1)
        self.taken = [[set() for _ in range(warps)] for _ in range(ring)]
        self.phases = np.zeros(ring, dtype=np.int64)
        self.arrived = np.zeros(ring, dtype=np.int64)
        self.col = np.ones(warps, dtype=np.int64)  # each warp's next column
        self.pending = [None] * warps
        # the first sliding column's slide runs alone
        sliding = self.slide_end >= 1
        for w in range(warps):
            head = (1 | ((self.char(self.stream, 0) & 7) << 2)
                    if w == warps - 1 else self.head[:, w])
            self.slide_warp(w, head, sliding)

    def char(self, packed, j):
        """Char j of every task's nibble-packed row [T] (0 past its end)."""
        j = np.minimum(j, self.num_chars - 1)
        return (packed[:, j >> 3] >> (4 * (j & 7))) & 0xF

    def state(self, w):
        return [self.vp[:, w], self.vn[:, w], *(p[:, w] for p in self.planes)]

    def set_state(self, w, arrays, where):
        where = where[:, None, None]
        for target, new in zip([self.vp, self.vn, *self.planes], arrays):
            target[:, w] = np.where(where, new, target[:, w])

    def slide_warp(self, w, head, where):
        """The band slide at the start of a column of warp w (lane 31
        taking `head`), for the tasks in `where`."""
        old = self.state(w)
        nxt = np.roll(head_bits(*(x[..., 0] for x in old)), -1, axis=1)
        nxt[:, 31] = head
        self.set_state(w, [slide(x, nxt >> shift)
                           for shift, x in enumerate(old)], where)

    def readers(self, w):
        """The warps that read warp w's word: those above it (the carry
        lookahead, and the top bits for the one above) and the one below
        (the slide's bits)."""
        return set(range(w + 1, self.W)) | ({w - 1} if w > 0 else set())

    def sources(self, w):
        """The warps whose words warp w reads."""
        return list(range(w)) + ([w + 1] if w + 1 < self.W else [])

    def done(self, w):
        return self.col[w] > int(self.last_col.max(initial=0))

    # ---- the two halves of a warp's column: publish, then wait and finish

    def publish(self, w):
        W, R = self.W, self.R
        col = int(self.col[w])
        j = col - 1
        live = col <= self.last_col
        sliding = live & (col <= self.slide_end)
        merged_mode = live & (col < self.slide_end)
        vp, vn, p0, p1, p2, am = self.state(w)
        tch = self.char(self.texts, j)[:, None, None]
        x = [np.where((tch & bit) != 0, 0, MASK) for bit in (1, 2, 4)]
        eq = ((p0 ^ x[0]) & (p1 ^ x[1]) & (p2 ^ x[2])) | am
        xv = eq | vn
        a = eq & vp
        t = (a + vp) & MASK
        words = np.arange(R, dtype=np.int64)
        gen_run = (((a + vp) >> 32) << words).sum(-1)
        prop_run = ((t == MASK).astype(np.int64) << words).sum(-1)
        any_run = gen_run | prop_run
        gm = ballot(((any_run + gen_run) >> R) != 0)
        pm = ballot(prop_run == (1 << R) - 1)
        any_ = gm | pm
        runs = [
            (any_run + gen_run
             + ((((any_ + gm + c) ^ any_ ^ gm) & MASK)[:, None] >> LANES & 1))
            ^ any_run ^ gen_run
            for c in (0, 1)
        ]
        bits0 = ((xv[..., 0] & 1) << 2) | (head_bits(
            0, 0, p0[..., 0], p1[..., 0], p2[..., 0], am[..., 0]) << 1)
        tops = 0
        for c, at in ((0, 7), (1, 9)):
            carry = (runs[c][:, 31] >> (R - 1)) & 1
            xh = ((((t[:, 31, R - 1] + carry) & MASK) ^ vp[:, 31, R - 1])
                  | eq[:, 31, R - 1])
            ph = vn[:, 31, R - 1] | ((xh | vp[:, 31, R - 1]) ^ MASK)
            mh = vp[:, 31, R - 1] & xh
            tops = tops | (((ph >> 31) | ((mh >> 31) << 1)) << at)
        word = (((any_ + gm) >> 32) | ((pm == MASK).astype(np.int64) << 1)
                | bits0[:, 0] | np.where(merged_mode, 0, tops))
        # lane 31 stores into the column's slot, then arrives
        slot = j % self.D
        if self.tag[slot, w] >= 0 and self.taken[slot][w] != self.readers(w):
            raise ScheduleError(
                f"warp {w} overwrites slot {slot} (column {j}) before warps "
                f"{sorted(self.readers(w) - self.taken[slot][w])} read column "
                f"{self.tag[slot, w]}")
        self.words[slot, w] = word
        self.tag[slot, w] = j
        self.taken[slot][w] = set()
        self.arrived[slot] += 1
        if self.arrived[slot] == W:
            self.arrived[slot] = 0
            self.phases[slot] += 1
        self.pending[w] = dict(eq=eq, xv=xv, t=t, runs=runs, bits0=bits0,
                               live=live, sliding=sliding,
                               merged_mode=merged_mode)

    def ready(self, w):
        """Whether the slot's barrier has completed the phase of warp w's
        column, as try_wait.parity sees it (raising where the parity
        passes on another phase)."""
        j = int(self.col[w]) - 1
        slot, phase = j % self.D, j // self.D
        completed = self.phases[slot]
        if completed > phase + 1:
            raise ScheduleError(
                f"slot {slot}'s barrier is two phases ahead of warp {w} at "
                f"column {j}")
        if (completed & 1) != (phase & 1) and completed != phase + 1:
            raise ScheduleError(
                f"warp {w} at column {j} passes slot {slot}'s barrier "
                f"before its arrivals ({completed} phases completed)")
        return (completed & 1) != (phase & 1)

    def finish(self, w):
        W, R = self.W, self.R
        col = int(self.col[w])
        j = col - 1
        slot = j % self.D
        got = {}
        for source in self.sources(w):
            if self.tag[slot, source] != j:
                raise ScheduleError(
                    f"warp {w} reads warp {source}'s word of column "
                    f"{self.tag[slot, source]} for column {j}")
            got[source] = self.words[slot, source]
            self.taken[slot][source].add(w)
        p = self.pending[w]
        live, sliding, merged_mode = p["live"], p["sliding"], p["merged_mode"]
        T = live.shape[0]
        zero = np.zeros(T, dtype=np.int64)
        gw = sum(((got[s] & 1) << s for s in range(w)), zero)
        pw = sum((((got[s] >> 1) & 1) << s for s in range(w)), zero)
        aw = gw | pw
        carries = ((aw + gw) ^ aw ^ gw) & MASK
        cin = (carries >> w) & 1
        above = got.get(w + 1, zero)
        runs = np.where(cin[:, None] != 0, p["runs"][1], p["runs"][0])
        vp, vn, p0, p1, p2, am = self.state(w)
        eq, xv, t = p["eq"], p["xv"], p["t"]
        carry = (runs[..., None] >> np.arange(R)) & 1
        xh = (((t + carry) & MASK) ^ vp) | eq
        ph, mh = vn | ((xh | vp) ^ MASK), vp & xh
        top = (ph[..., R - 1] >> 31) | ((mh[..., R - 1] >> 31) << 1)
        # the merged slide: Xv and the planes slid, lane 31 taking the warp
        # above's bits (the top warp's: the next pattern char, its Vp 1)
        enter = np.roll(p["bits0"], -1, axis=1)
        enter[:, 31] = (above if w + 1 < W
                        else (self.char(self.stream, j + 1) & 7) << 3)
        xvs = slide(xv, enter >> 2)
        merged = [mh | ((xvs | ph) ^ MASK), ph & xvs,
                  *(slide(x, enter >> shift)
                    for shift, x in zip((3, 4, 5, 6), (p0, p1, p2, am)))]
        if w == W - 1:
            merged[0][:, 31, R - 1] |= TOP
            merged[1][:, 31, R - 1] &= ~TOP & MASK
        # the horizontal shift: lane 0 takes the warp below's top bits for
        # the carry into it (warp 0 the pessimistic delta)
        pessim = np.where(sliding, col >= self.topshift,
                          self.mfrozen).astype(np.int64)
        if w > 0:
            cin_below = (carries >> (w - 1)) & 1
            below = (got[w - 1] >> np.where(cin_below != 0, 9, 7)) & 3
        else:
            below = pessim
        hcarry = np.roll(top, 1, axis=1)
        hcarry[:, 0] = below
        ph_sh = ((ph << 1) & MASK) | np.concatenate(
            [(hcarry & 1)[..., None], ph[..., :-1] >> 31], -1)
        mh_sh = ((mh << 1) & MASK) | np.concatenate(
            [(hcarry >> 1)[..., None], mh[..., :-1] >> 31], -1)
        fixed = [mh_sh | ((xv | ph_sh) ^ MASK), ph_sh & xv, p0, p1, p2, am]
        self.set_state(w, merged, merged_mode)
        self.set_state(w, fixed, live & ~merged_mode)
        if w == W - 1:
            self.score(col, live, sliding, top[:, 31])
        self.pending[w] = None
        self.col[w] += 1

    def score(self, col, live, sliding, top31):
        """The top warp's lane 31: the scores at the band bottom."""
        d = (top31 & 1) - (top31 >> 1)
        frozen = live & ~sliding
        self.s_bot = np.where(sliding, self.s_bot + 1 + d, self.s_bot)
        self.s_m = np.where(frozen, self.s_m + d, self.s_m)
        improves = frozen & (self.s_m <= self.best)
        self.best = np.where(improves, self.s_m, self.best)
        self.best_end = np.where(improves, col, self.best_end)
        turn = ((col == self.slide_end) & (self.slide_end >= 1)
                & (self.slide_end == self.jstar))
        self.s_m = np.where(turn, self.s_bot, self.s_m)
        improves = turn & (self.s_m <= self.best)
        self.best = np.where(improves, self.s_m, self.best)
        self.best_end = np.where(improves, self.jstar, self.best_end)

    def step(self, w) -> bool:
        """One half-column of warp w; False where it must wait."""
        if self.done(w):
            return False
        if self.pending[w] is None:
            self.publish(w)
            return True
        if not self.ready(w):
            return False
        self.finish(w)
        return True

    def run(self, order="low"):
        """Every warp to its last column: `order` "low" steps the lowest
        warp that can go on, "high" the highest, "turns" each warp in
        turn. Returns (dist, end) per task."""
        warps = list(range(self.W))
        if order == "high":
            warps.reverse()
        while not all(self.done(w) for w in warps):
            if order == "turns":
                moved = [self.step(w) for w in warps]
            else:
                moved = [next((True for w in warps if self.step(w)), False)]
            if not any(moved):
                raise ScheduleError("every warp waits: the schedule deadlocks")
        return self.best, self.best_end


def wide_cases(band_words, deep, seed, columns=300):
    """Seeded K1 operands at band_words (band_cases, or deep_band_cases
    whose rows reach every warp from the first column) with texts cut to
    `columns` chars, tlen 0 and 1 and chars 6..15 among the tasks; with
    the patterns, texts and budgets."""
    rng = np.random.default_rng(band_words + 7 * seed + deep)
    if deep:
        patterns, texts, budgets = cuda_myers_banded.deep_band_cases(
            rng, 6, band_words, columns)
    else:
        patterns, texts, budgets = cuda_myers_banded.band_cases(
            rng, 6, band_words)
    texts = [t[:columns].copy() for t in texts]
    texts[3][::5] = 9
    txt, tlen = pad_batch(texts)
    operands, num_text = cuda_myers_banded.banded_operands(
        patterns, txt, tlen, budgets, band_words, CPU)
    operands[4][0, cuda_myers_banded.COL_TLEN] = 0
    operands[4][1, cuda_myers_banded.COL_TLEN] = 1
    return operands, num_text, (patterns, texts, budgets)


def mirror(operands, num_text, band_words, order, warps=4, ring=2):
    """The mirror's (dist, end) at `warps` warps of band_words / (32
    warps) words a lane (the kernel's entry runs 4)."""
    args = (*(t.numpy() for t in operands), band_words, num_text)
    return WideExchange(args, warps, band_words // (32 * warps),
                        ring).run(order)


@pytest.mark.parametrize("band_words,deep,order,columns", [
    (640, False, "low", 160), (640, True, "high", 240),
    (1024, True, "low", 240), (1024, False, "turns", 160),
    (2048, True, "high", 100),
])
def test_wide_exchange_mirror_equals_plain_and_reference(band_words, deep,
                                                         order, columns):
    """The routed schedule (4 warps of band_words / 128 words a lane, a
    slot barrier of 4 arrivals a column, the merged slide) at 640, 1024
    and 2048 band words, each warp as far ahead as its waits let it: no read before
    its producer's arrival, no slot overwritten before its readers took
    it, and (dist, end) equal to myers_banded_plain and, on every task of
    at least two columns and no char 6..15, to the reference's
    myers_banded_np at the same band store (exact within the budget; past
    it both say so)."""
    operands, num_text, (patterns, texts, budgets) = wide_cases(
        band_words, deep, 0, columns)
    want = cuda_myers_banded.myers_banded_plain(*operands, band_words,
                                                num_text)
    got = mirror(operands, num_text, band_words, order)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    for i in range(2, len(patterns)):
        if (texts[i] >= 6).any():
            continue  # the reference's numpy function reads chars 6..15
            # otherwise than its kernel (the plain version follows the
            # kernel, tests/test_torch_kernels.py)
        budget = int(budgets[i])
        reference = myers_banded_np(patterns[i], texts[i], budget,
                                    b_store=32 * band_words)
        got_i = (int(want[0][i]), int(want[1][i]))
        # the reference is exact within the budget, and past it only says
        # so (its module's contract)
        if min(got_i[0], reference[0]) <= budget:
            assert got_i == reference
        else:
            assert got_i[0] > budget and reference[0] > budget


def test_a_one_slot_ring_races():
    """The ring needs a slot for each of two columns: with one slot the
    lowest warp, run as far ahead as its wait lets it, publishes its next
    word over one the warps above have not read, and the mirror raises;
    with the kernel's two it does not."""
    operands, num_text, _ = wide_cases(1024, True, 2, columns=60)
    with pytest.raises(ScheduleError):
        mirror(operands, num_text, 1024, "low", ring=1)
    got = mirror(operands, num_text, 1024, "low")
    want = cuda_myers_banded.myers_banded_plain(*operands, 1024, num_text)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_the_kernel_ring_and_warps_are_the_mirrors():
    """csrc/myers_banded_wide.cu's ring (kRing) is the mirror's two slots,
    its entry's warps (kWarps) the mirror's four, and a tile of its band
    (kTileWords) a word a lane of those warps."""
    from pathlib import Path
    import re

    source = (Path(__file__).resolve().parent.parent / "floxer_tpu_torch"
              / "csrc" / "myers_banded_wide.cu").read_text()

    def constant(name):
        return int(re.search(rf"^constexpr int {name} = (\d+);$", source,
                             re.M).group(1))

    assert constant("kRing") == 2
    assert constant("kWarps") == 4
    assert re.search(r"^constexpr int kTileWords = 32 \* kWarps;$", source,
                     re.M)
