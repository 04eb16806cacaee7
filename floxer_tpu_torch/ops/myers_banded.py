# Copied from floxer_tpu/ops/myers_banded.py; relative imports resolve to this package's copies.
"""Banded sliding-window Myers bit-parallel semi-global edit distance.

The speed-of-light formulation for PEX verification tasks (node query
against an anchor-centered reference window, alignment.cpp:88-96 semantics):
instead of carrying Myers state for all m pattern rows (ops/myers.py,
ops/pallas_myers_large.py), carry only a BAND of rows that slides down one
row per text column.

Why this is exact, not approximate: a verification window is constructed so
the pattern must align end-to-end inside it (verification.cpp:157-184),
which means any alignment path with at most `budget` errors starts at text
column j0 <= n - m + budget and drifts at most `budget` diagonals from its
start. All such paths live within diagonals d = j - i in
[-budget, n - m + budget]. The band stores exactly those B = n - m +
2*budget + 1 rows per column (plus padding). Cells outside the band are
approximated PESSIMISTICALLY (boundary deltas +1, i.e. values only ever
overestimated), so:

  - if the true full-DP distance is <= budget, its optimal paths (and all
    ties) lie inside the band and the banded result — distance AND
    rightmost-minimal end column — equals the full result exactly;
  - if the true distance is > budget, the banded distance is >= the true
    distance, so the accept/reject decision agrees.

Downstream only ever reads (distance, end) when distance <= budget, so the
banded kernel is output-equivalent to the full kernel for the whole
pipeline.

State per column j (band-relative bit p in [0, B_store), absolute row
i = j + 1 + budget - (B_store - 1 - p)):
  - VP/VN vertical deltas, shifted right one bit per column with a
    pessimistic VP bit entering at the bottom (p = B_store - 1)
  - per-symbol Peq band masks, shifted right in lockstep with one bit
    injected at the bottom from the pattern char stream (the row entering
    the band at column j+1 is pattern row j+1+budget, so the injected bits
    are just the pattern chars consumed sequentially — no indexed gather)
  - S_bot: score at the band's bottom row (entering delta +1 per column +
    bottom horizontal delta), used once to seed
  - S_m: score at pattern row m, seeded from S_bot when row m enters the
    band bottom (at column m - budget) and updated via a row-m mask that
    shifts right with the band

The horizontal delta shifted into the top word is 0 while the top stored
row is still <= 0 (free-start region, exact) and +1 afterwards (pessimistic
boundary). Initial band content encodes column 0: rows <= 0 carry
Peq = all-ones / delta 0 (D = 0), rows 1..budget carry the pattern prefix
and delta +1 (D(i, 0) = i).

This module is the word-level numpy mirror used to pin the algorithm and
as the oracle for the Pallas TPU kernel (ops/pallas_myers_banded.py).
"""

from __future__ import annotations

import numpy as np

from ..alphabet import SIGMA

WORD = 32
MASK32 = np.uint32(0xFFFFFFFF)


def band_store_bits(m: int, n: int, budget: int, multiple: int = WORD) -> int:
    """Stored band width in bits: the exactness band n - m + 2*budget + 1,
    rounded up to a word multiple (extra rows sit above the band and only
    ever overestimate)."""
    nominal = (n - m) + 2 * budget + 1
    return -(-nominal // multiple) * multiple


def prepare_banded_task(
    pattern: np.ndarray, n: int, budget: int, b_store: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side per-task preparation.

    Returns (vp0_words, peq0_words [SIGMA, Bw], char_stream [n]):
      - vp0: initial vertical deltas at column 0 (top `budget` bits set for
        rows 1..budget; rows <= 0 flat)
      - peq0: initial per-symbol band bits (rows <= 0 all-ones, rows
        1..budget = pattern prefix)
      - char_stream[j]: the pattern char entering the band at column j+1
        (= pattern row j+1+budget, i.e. pattern[j + budget]), 255 past the
        pattern end (matches no symbol)
    """
    m = len(pattern)
    bw = b_store // WORD
    # band position p <-> absolute row i(p) at column 0: bottom row is
    # `budget`, so i = budget - (b_store - 1 - p)
    rows = np.arange(b_store) + budget - (b_store - 1)  # i(p) for p=0..B-1

    vp_bits = rows >= 1  # Delta_v = +1 for real rows, 0 for padding rows
    vp0 = np.zeros(bw, dtype=np.uint32)
    peq0 = np.zeros((SIGMA, bw), dtype=np.uint32)
    bitvals = (np.uint32(1) << (np.arange(b_store) % WORD).astype(np.uint32))
    for w in range(bw):
        sel = slice(w * WORD, (w + 1) * WORD)
        vp0[w] = np.bitwise_or.reduce(
            np.where(vp_bits[sel], bitvals[sel], 0).astype(np.uint32)
        )
        for s in range(SIGMA):
            in_band_rows = rows[sel]
            # rows <= 0: all symbols match (free start stays flat);
            # rows >= 1: pattern char (1-based row r = pattern[r-1])
            match = np.where(
                in_band_rows <= 0,
                True,
                np.where(
                    in_band_rows <= m,
                    np.take(
                        pattern,
                        np.clip(in_band_rows - 1, 0, m - 1),
                        mode="clip",
                    )
                    == s,
                    False,
                ),
            )
            peq0[s, w] = np.bitwise_or.reduce(
                np.where(match, bitvals[sel], 0).astype(np.uint32)
            )

    stream = np.full(n, 255, dtype=np.int64)
    first = np.arange(n) + budget  # pattern index for column j+1's new row
    valid = first < m
    stream[valid] = pattern[first[valid]]
    return vp0, peq0, stream


def _shift_right_one(words: np.ndarray, entering_bit: int) -> np.ndarray:
    """Band arrays shift one bit toward p=0 per column; `entering_bit` is
    injected at the top bit of the last word (p = B_store - 1)."""
    out = (words >> np.uint32(1)) | (
        np.concatenate([words[1:], [np.uint32(0)]]) << np.uint32(31)
    )
    if entering_bit:
        out[-1] |= np.uint32(1) << np.uint32(31)
    return out.astype(np.uint32)


def _add_words(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Multi-word add (little-endian words) with carry propagation."""
    out = np.zeros_like(a)
    carry = np.uint64(0)
    for w in range(len(a)):
        total = np.uint64(a[w]) + np.uint64(b[w]) + carry
        out[w] = np.uint32(total & np.uint64(0xFFFFFFFF))
        carry = total >> np.uint64(32)
    return out


def myers_banded_np(
    pattern: np.ndarray,
    text: np.ndarray,
    budget: int,
    b_store: int | None = None,
    text_len: int | None = None,
) -> tuple[int, int]:
    """Banded semi-global edit distance of `pattern` vs `text` windows.

    Returns (distance, end_col) with the pipeline's semantics: rightmost
    minimal end among columns 0..text_len-1. Exact whenever the full-DP
    distance is <= budget; otherwise returns a value > budget (possibly
    overestimated) — see module docstring.
    """
    m = len(pattern)
    n = len(text)
    tlen = n if text_len is None else text_len
    assert 0 < budget < m, "band requires 0 < budget < m"
    if b_store is None:
        b_store = band_store_bits(m, n, budget)
    bw = b_store // WORD

    vp, peq, stream = prepare_banded_task(pattern, n, budget, b_store)
    vn = np.zeros(bw, dtype=np.uint32)

    top_bit = np.uint32(1) << np.uint32(31)  # p = B_store-1 within last word
    s_bot = budget  # D(bottom row = budget, column 0)
    s_m = m
    best = m
    best_end = 0
    j_star = m - budget  # column where row m enters as the band bottom
    # column beyond which the top stored row is a real row (>= 1): entering
    # horizontal delta at p=0 becomes pessimistic +1
    top_real_after = b_store - 1 - budget

    m_mask = np.zeros(bw, dtype=np.uint32)

    for j in range(n):
        col = j + 1
        # band slides down one row: state shifts right; entering bottom row
        # (= col + budget, a row the previous column never stored) gets the
        # pessimistic vertical delta +1
        vp = _shift_right_one(vp, 1)
        vn = _shift_right_one(vn, 0)
        s_bot += 1
        ch = stream[j]
        for s in range(SIGMA):
            peq[s] = _shift_right_one(peq[s], 1 if ch == s else 0)
        m_mask = _shift_right_one(m_mask, 1 if col == j_star else 0)

        eq = peq[text[j]] if text[j] < SIGMA else np.zeros(bw, dtype=np.uint32)

        xv = eq | vn
        a = eq & vp
        t_sum = _add_words(a, vp)
        xh = (t_sum ^ vp) | eq
        ph = vn | (~(xh | vp) & MASK32)
        mh = vp & xh

        # score deltas BEFORE the horizontal shift: bottom/row-m bits of
        # ph/mh are the horizontal deltas at those rows
        ph_bot = int(ph[-1] & top_bit) != 0
        mh_bot = int(mh[-1] & top_bit) != 0
        s_bot += (1 if ph_bot else 0) - (1 if mh_bot else 0)
        if col == j_star:
            s_m = s_bot
        else:
            ph_m = bool(np.any(ph & m_mask))
            mh_m = bool(np.any(mh & m_mask))
            s_m += (1 if ph_m else 0) - (1 if mh_m else 0)

        # horizontal deltas shift down one row (toward higher p); the bit
        # entering at p=0 is the delta of the row above the stored top:
        # 0 while that row is <= 0 (free start, exact), else +1 (pessimism)
        ph_in = np.uint32(1) if col > top_real_after else np.uint32(0)
        ph_shifted = ((ph << np.uint32(1)) & MASK32) | np.concatenate(
            [[ph_in], ph[:-1] >> np.uint32(31)]
        ).astype(np.uint32)
        mh_shifted = ((mh << np.uint32(1)) & MASK32) | np.concatenate(
            [[np.uint32(0)], mh[:-1] >> np.uint32(31)]
        ).astype(np.uint32)

        vp = (mh_shifted | (~(xv | ph_shifted) & MASK32)).astype(np.uint32)
        vn = (ph_shifted & xv).astype(np.uint32)

        if col >= j_star and col < tlen and s_m <= best:
            best = s_m
            best_end = col

    return best, best_end
