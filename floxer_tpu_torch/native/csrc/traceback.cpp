// Banded CIGAR traceback from a device-reported (end column, distance).
//
// Native port of floxer_tpu.ops.dp_reference.banded_cigar_traceback: the
// band |j - i - (end_col - m)| <= distance around the optimal path's
// diagonal is recomputed with the same semi-global recurrence and the same
// tie preference (insertion, then diagonal, then deletion), so the emitted
// op sequence is byte-identical to the Python oracle. Used for accepted
// PEX roots only (verification.cpp:206-213) — one call per reported
// alignment.
//
// Two implementations:
//   - floxer_banded_traceback_scalar: the original O(m * band) scalar DP
//     with an explicit trace matrix (the semantics reference).
//   - the default entry point fills the band with Myers' bit-parallel
//     recurrence in 64-bit words (a sliding band that advances one row per
//     text column, pessimistic +1 deltas at the band boundary), stores the
//     per-column VP/VN/PH/MH delta bitmaps, and walks back by decoding
//     deltas. Inside the nominal band its cell values are sandwiched
//     between the true full-matrix values and the scalar band's values
//     (wider storage + finite boundary can only lower, both only ever
//     overestimate the truth), and every walk decision tests candidates
//     for equality with the known-true path value — a candidate achieving
//     the minimum is never inflated — so the decoded moves are identical
//     to the scalar walk, at ~1/20th of the fill cost. Any structural
//     surprise falls back to the scalar path.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
#define FLOXER_TB_AVX512 1
#endif

namespace {
constexpr int32_t BIG = 1 << 28;

// op codes: 0 '=', 1 'X', 2 'I' (consumes query), 3 'D' (consumes reference)
// trace codes: 0 diagonal, 1 up, 2 left
}  // namespace

extern "C" {

int floxer_banded_traceback_scalar(
    const uint8_t* ref, int64_t n, const uint8_t* query,
    int64_t m, int64_t end_col, int64_t distance,
    int64_t* out_begin, uint8_t* out_ops,
    int64_t max_ops, int64_t* out_num_ops) {
    int64_t const half = distance < 0 ? 0 : distance;
    int64_t const width = 2 * half + 1;
    int64_t const center = end_col - m;

    // dp over two rolling rows; full trace matrix for the walk-back
    std::vector<int32_t> prev(width, BIG), curr(width, BIG);
    std::vector<uint8_t> trace;
    trace.resize(static_cast<size_t>(m) * width);

    auto col_of = [&](int64_t i, int64_t d) { return i + center - half + d; };

    for (int64_t d = 0; d < width; d++) {
        int64_t const j = col_of(0, d);
        prev[d] = (j >= 0 && j <= n) ? 0 : BIG;  // free leading ref gaps
    }

    for (int64_t i = 1; i <= m; i++) {
        uint8_t* trace_row = trace.data() + static_cast<size_t>(i - 1) * width;
        int32_t left_val = BIG;  // dp[i][j-1] within this row
        for (int64_t d = 0; d < width; d++) {
            int64_t const j = col_of(i, d);
            if (j < 0 || j > n) {
                curr[d] = BIG;
                trace_row[d] = 0;
                left_val = BIG;
                continue;
            }
            // vertical: dp[i-1][j] = prev[d+1]
            int32_t const up = (d + 1 < width ? prev[d + 1] : BIG) + 1;
            // diagonal: dp[i-1][j-1] = prev[d]
            int32_t diag = BIG;
            if (j >= 1 && prev[d] < BIG) {
                diag = prev[d] + (ref[j - 1] != query[i - 1] ? 1 : 0);
            }
            int32_t const left = (j >= 1 ? left_val : BIG) + 1;
            // preference on ties: up (insertion), diagonal, left (deletion)
            int32_t best;
            uint8_t move;
            if (up <= diag && up <= left) {
                best = up;
                move = 1;
            } else if (diag <= left) {
                best = diag;
                move = 0;
            } else {
                best = left;
                move = 2;
            }
            curr[d] = best >= BIG ? BIG : best;
            trace_row[d] = move;
            left_val = curr[d];
        }
        std::swap(prev, curr);
    }

    // walk back from (m, end_col)
    {
        int64_t const d_end = end_col - col_of(m, 0);
        if (d_end < 0 || d_end >= width || prev[d_end] != distance) return 1;
    }

    int64_t i = m;
    int64_t j = end_col;
    int64_t num_ops = 0;
    std::vector<uint8_t> reversed_ops;
    reversed_ops.reserve(m + half + 1);
    while (i > 0) {
        int64_t const d = j - col_of(i, 0);
        if (d < 0 || d >= width) return 2;
        uint8_t const move = trace[static_cast<size_t>(i - 1) * width + d];
        if (move == 1) {
            reversed_ops.push_back(2);  // I
            i -= 1;
        } else if (move == 0) {
            reversed_ops.push_back(ref[j - 1] == query[i - 1] ? 0 : 1);
            i -= 1;
            j -= 1;
        } else {
            reversed_ops.push_back(3);  // D
            j -= 1;
        }
    }

    num_ops = static_cast<int64_t>(reversed_ops.size());
    if (num_ops > max_ops) return 3;
    for (int64_t k = 0; k < num_ops; k++)
        out_ops[k] = reversed_ops[num_ops - 1 - k];
    *out_begin = j;
    *out_num_ops = num_ops;
    return 0;
}

namespace {

// Myers bit-parallel banded fill + delta-decoding walk. Returns 0 on
// success, nonzero to request the scalar fallback.
int banded_traceback_myers(const uint8_t* ref, int64_t n, const uint8_t* query,
                           int64_t m, int64_t end_col, int64_t distance,
                           int64_t* out_begin, uint8_t* out_ops,
                           int64_t max_ops, int64_t* out_num_ops) {
    if (distance < 0 || end_col < 1 || end_col > n || m < 1) return 10;
    if (distance == 0) {
        // pure diagonal: verify and emit m matches
        if (end_col - m < 0 || m > max_ops) return 11;
        for (int64_t i = 0; i < m; i++) {
            if (ref[end_col - m + i] != query[i]) return 12;
            out_ops[i] = 0;
        }
        *out_begin = end_col - m;
        *out_num_ops = m;
        return 0;
    }

    int64_t const half = distance;
    int64_t const center = end_col - m;
    int64_t const b_nominal = 2 * half + 1;
    int64_t const W = (b_nominal + 63) / 64;
    int64_t const b_store = W * 64;
    int64_t const pad = b_store - b_nominal;  // extra rows ABOVE the band
    auto lo_of = [&](int64_t j) { return j - center - half - pad; };

    // per-symbol full Peq over virtual rows [i_min, m + half]
    int64_t const i_min = lo_of(0);
    int64_t const v_rows = (m + half) - i_min + 1;
    int64_t const vw = (v_rows + 63) / 64 + 2;  // +2: funnel overread slack
    std::vector<uint64_t> peq(static_cast<size_t>(6) * vw, 0);
    for (int64_t q = 0; q < v_rows; q++) {
        int64_t const i = i_min + q;
        if (i <= 0) {
            for (int s = 0; s < 6; s++)
                peq[static_cast<size_t>(s) * vw + q / 64] |=
                    uint64_t(1) << (q % 64);
        } else if (i <= m) {
            int const s = query[i - 1];
            peq[static_cast<size_t>(s) * vw + q / 64] |= uint64_t(1) << (q % 64);
        }
    }

    size_t const cols = static_cast<size_t>(end_col) + 1;
    // the four delta planes are the dominant memory cost (~32 MB at root
    // scale); a thread-local arena avoids the per-call zero-init + page
    // faults of fresh vectors (the walk-back only reads columns the fill
    // wrote, plus column 0, which is cleared explicitly below)
    static thread_local std::vector<uint64_t> arena;
    size_t const plane = cols * W;
    if (arena.size() < 4 * plane) arena.resize(4 * plane);
    uint64_t* const vp_col = arena.data();
    uint64_t* const vn_col = arena.data() + plane;
    uint64_t* const ph_col = arena.data() + 2 * plane;
    uint64_t* const mh_col = arena.data() + 3 * plane;
    std::memset(vp_col, 0, W * 8);
    std::memset(vn_col, 0, W * 8);
    std::memset(ph_col, 0, W * 8);
    std::memset(mh_col, 0, W * 8);

    std::vector<uint64_t> vp(W), vn(W, 0);
    for (int64_t p = 0; p < b_store; p++) {
        if (lo_of(0) + p >= 1) vp[p / 64] |= uint64_t(1) << (p % 64);
    }
    // column 0's vertical deltas (the walk's route via (i, j-1) can read
    // them at j == 1)
    std::memcpy(&vp_col[0], vp.data(), W * 8);

    uint64_t const BOT = uint64_t(1) << 63;  // p = b_store - 1, last word
    int64_t const j_star = end_col - half;  // row m reaches the band bottom
    int64_t const bottom0 = half - center;  // bottom row at column 0
    int64_t s_bot = bottom0 > 0 ? bottom0 : 0;
    int64_t s_m = 0;
    bool s_m_live = false;

#ifdef FLOXER_TB_AVX512
    if (W >= 16) {
        // vectorized column fill: identical bit patterns to the scalar loop
        // below (the walk-back consumes the same vp/vn/ph/mh columns).
        // State lives in zero-padded buffers with one guard word in front
        // (index 0) so cross-word neighbours are plain unaligned loads.
        int64_t const WV = (W + 7) / 8;
        int64_t const WP = WV * 8;
        std::vector<uint64_t> vp_b(WP + 9, 0), vn_b(WP + 9, 0),
            eq_b(WP + 9, 0), t_b(WP + 9, 0), ph_b(WP + 9, 0), mh_b(WP + 9, 0);
        uint64_t* vpd = vp_b.data() + 1;
        uint64_t* vnd = vn_b.data() + 1;
        uint64_t* eqd = eq_b.data() + 1;
        uint64_t* td = t_b.data() + 1;
        uint64_t* phd = ph_b.data() + 1;
        uint64_t* mhd = mh_b.data() + 1;
        std::memcpy(vpd, vp.data(), W * 8);

        // peq with slack so funnel loads beyond W stay in bounds
        std::vector<uint64_t> peq_pad(peq.size() + 16, 0);
        std::memcpy(peq_pad.data(), peq.data(), peq.size() * 8);

        __m512i const ones = _mm512_set1_epi64(-1);
        for (int64_t j = 1; j <= end_col; j++) {
            // band slide (>>1 across words, from higher words)
            for (int64_t v = 0; v < WV; v++) {
                __m512i cur = _mm512_loadu_si512(vpd + 8 * v);
                __m512i nxt = _mm512_loadu_si512(vpd + 8 * v + 1);
                _mm512_storeu_si512(
                    vpd + 8 * v,
                    _mm512_or_si512(_mm512_srli_epi64(cur, 1),
                                    _mm512_slli_epi64(nxt, 63)));
                cur = _mm512_loadu_si512(vnd + 8 * v);
                nxt = _mm512_loadu_si512(vnd + 8 * v + 1);
                _mm512_storeu_si512(
                    vnd + 8 * v,
                    _mm512_or_si512(_mm512_srli_epi64(cur, 1),
                                    _mm512_slli_epi64(nxt, 63)));
            }
            vpd[W - 1] |= BOT;
            vnd[W - 1] &= ~BOT;
            s_bot += 1;

            // Eq funnel shift out of the padded Peq
            {
                int const sym = ref[j - 1] < 6 ? ref[j - 1] : 5;
                uint64_t const* base =
                    peq_pad.data() + static_cast<size_t>(sym) * vw;
                int64_t const off = lo_of(j) - i_min;
                int64_t const k = off / 64;
                int const r = static_cast<int>(off % 64);
                if (r == 0) {
                    std::memcpy(eqd, base + k, W * 8);
                    for (int64_t w = W; w < WP; w++) eqd[w] = 0;
                } else {
                    for (int64_t v = 0; v < WV; v++) {
                        __m512i const a = _mm512_loadu_si512(base + k + 8 * v);
                        __m512i const b =
                            _mm512_loadu_si512(base + k + 8 * v + 1);
                        _mm512_storeu_si512(
                            eqd + 8 * v,
                            _mm512_or_si512(_mm512_srli_epi64(a, r),
                                            _mm512_slli_epi64(b, 64 - r)));
                    }
                    for (int64_t w = W; w < WP; w++) eqd[w] = 0;
                }
            }

            // t = (eq & vp) + vp with the carry chain resolved via the
            // generate/propagate mask-addition trick (g and p are disjoint)
            uint64_t g_mask = 0, p_mask = 0;
            for (int64_t v = 0; v < WV; v++) {
                __m512i const e = _mm512_loadu_si512(eqd + 8 * v);
                __m512i const p = _mm512_loadu_si512(vpd + 8 * v);
                __m512i const a = _mm512_and_si512(e, p);
                __m512i const t = _mm512_add_epi64(a, p);
                uint64_t const c = _mm512_cmplt_epu64_mask(t, a);
                uint64_t const pr = _mm512_cmpeq_epi64_mask(t, ones);
                g_mask |= c << (8 * v);
                p_mask |= pr << (8 * v);
                _mm512_storeu_si512(td + 8 * v, t);
            }
            {
                // ripple the generate/propagate masks with one integer
                // addition; flipped bits = limbs that receive a carry-in
                uint64_t const x = g_mask << 1;
                uint64_t const carries = p_mask ^ (p_mask + x);
                for (int64_t v = 0; v < WV; v++) {
                    __mmask8 const ci =
                        static_cast<__mmask8>(carries >> (8 * v));
                    __m512i const e = _mm512_loadu_si512(eqd + 8 * v);
                    __m512i const p = _mm512_loadu_si512(vpd + 8 * v);
                    __m512i const n = _mm512_loadu_si512(vnd + 8 * v);
                    __m512i t = _mm512_loadu_si512(td + 8 * v);
                    t = _mm512_mask_add_epi64(t, ci, t, _mm512_set1_epi64(1));
                    __m512i const xh =
                        _mm512_or_si512(_mm512_xor_si512(t, p), e);
                    // ph = vn | ~(xh | vp) ; mh = vp & xh ; xv = eq | vn
                    _mm512_storeu_si512(
                        phd + 8 * v,
                        _mm512_or_si512(
                            n, _mm512_andnot_si512(_mm512_or_si512(xh, p),
                                                   ones)));
                    _mm512_storeu_si512(mhd + 8 * v, _mm512_and_si512(p, xh));
                    _mm512_storeu_si512(eqd + 8 * v, _mm512_or_si512(e, n));
                }
                for (int64_t w = W; w < WP; w++) {
                    phd[w] = 0;
                    mhd[w] = 0;
                    eqd[w] = 0;
                }
            }

            // score tracking at the band bottom / row m
            {
                bool const ph_bot = (phd[W - 1] & BOT) != 0;
                bool const mh_bot = (mhd[W - 1] & BOT) != 0;
                s_bot += (ph_bot ? 1 : 0) - (mh_bot ? 1 : 0);
                if (j == j_star) {
                    s_m = s_bot;
                    s_m_live = true;
                } else if (s_m_live) {
                    int64_t const p_m = m - lo_of(j);
                    if (p_m < 0 || p_m >= b_store) return 13;
                    uint64_t const bit = uint64_t(1) << (p_m % 64);
                    s_m += ((phd[p_m / 64] & bit) ? 1 : 0) -
                           ((mhd[p_m / 64] & bit) ? 1 : 0);
                }
            }

            std::memcpy(&ph_col[static_cast<size_t>(j) * W], phd, W * 8);
            std::memcpy(&mh_col[static_cast<size_t>(j) * W], mhd, W * 8);

            // horizontal shift (<<1 across words) + new vertical deltas
            ph_b[0] = lo_of(j) >= 1 ? BOT : 0;  // boundary pessimism carry
            mh_b[0] = 0;
            for (int64_t v = 0; v < WV; v++) {
                __m512i const ph_c = _mm512_loadu_si512(phd + 8 * v);
                __m512i const ph_p = _mm512_loadu_si512(phd + 8 * v - 1);
                __m512i const mh_c = _mm512_loadu_si512(mhd + 8 * v);
                __m512i const mh_p = _mm512_loadu_si512(mhd + 8 * v - 1);
                __m512i const xv = _mm512_loadu_si512(eqd + 8 * v);
                __m512i const ph_sh =
                    _mm512_or_si512(_mm512_slli_epi64(ph_c, 1),
                                    _mm512_srli_epi64(ph_p, 63));
                __m512i const mh_sh =
                    _mm512_or_si512(_mm512_slli_epi64(mh_c, 1),
                                    _mm512_srli_epi64(mh_p, 63));
                __m512i const vp_n = _mm512_or_si512(
                    mh_sh,
                    _mm512_andnot_si512(_mm512_or_si512(xv, ph_sh), ones));
                __m512i const vn_n = _mm512_and_si512(ph_sh, xv);
                _mm512_storeu_si512(vpd + 8 * v, vp_n);
                _mm512_storeu_si512(vnd + 8 * v, vn_n);
            }
            for (int64_t w = W; w < WP; w++) {
                vpd[w] = 0;
                vnd[w] = 0;
            }
            std::memcpy(&vp_col[static_cast<size_t>(j) * W], vpd, W * 8);
            std::memcpy(&vn_col[static_cast<size_t>(j) * W], vnd, W * 8);
        }
        if (!s_m_live || s_m != distance) return 14;
        goto walkback;
    }
#endif
    {
    std::vector<uint64_t> eq(W), ph(W), mh(W);
    for (int64_t j = 1; j <= end_col; j++) {
        // band slides one row down: shift VP/VN toward p=0, pessimistic
        // VP bit entering at the bottom
        for (int64_t w = 0; w < W; w++) {
            uint64_t const nxt_vp = (w + 1 < W) ? vp[w + 1] : 0;
            uint64_t const nxt_vn = (w + 1 < W) ? vn[w + 1] : 0;
            vp[w] = (vp[w] >> 1) | (nxt_vp << 63);
            vn[w] = (vn[w] >> 1) | (nxt_vn << 63);
        }
        vp[W - 1] |= BOT;
        vn[W - 1] &= ~BOT;
        s_bot += 1;

        // Eq via funnel shift out of the full Peq of this text symbol
        {
            int const sym = ref[j - 1] < 6 ? ref[j - 1] : 5;
            uint64_t const* base = peq.data() + static_cast<size_t>(sym) * vw;
            int64_t const off = lo_of(j) - i_min;
            int64_t const k = off / 64;
            int const r = static_cast<int>(off % 64);
            for (int64_t w = 0; w < W; w++) {
                uint64_t const a = base[k + w];
                uint64_t const b = base[k + w + 1];
                eq[w] = r == 0 ? a : ((a >> r) | (b << (64 - r)));
            }
        }

        // Myers column update with carry-rippled add
        uint64_t add_carry = 0;
        for (int64_t w = 0; w < W; w++) {
            uint64_t const x = eq[w] | vn[w];
            uint64_t const a = eq[w] & vp[w];
            uint64_t t = a + vp[w];
            uint64_t c1 = t < a;
            uint64_t s = t + add_carry;
            uint64_t c2 = s < t;
            add_carry = c1 | c2;
            uint64_t const xh = (s ^ vp[w]) | eq[w];
            ph[w] = vn[w] | ~(xh | vp[w]);
            mh[w] = vp[w] & xh;
            eq[w] = x;  // reuse eq[] to hold XV for the second pass
        }

        // score tracking at the band bottom / row m
        {
            uint64_t const ph_bot = (ph[W - 1] & BOT) != 0;
            uint64_t const mh_bot = (mh[W - 1] & BOT) != 0;
            s_bot += (ph_bot ? 1 : 0) - (mh_bot ? 1 : 0);
            if (j == j_star) {
                s_m = s_bot;
                s_m_live = true;
            } else if (s_m_live) {
                int64_t const p_m = m - lo_of(j);
                if (p_m < 0 || p_m >= b_store) return 13;
                uint64_t const bit = uint64_t(1) << (p_m % 64);
                s_m += ((ph[p_m / 64] & bit) ? 1 : 0) -
                       ((mh[p_m / 64] & bit) ? 1 : 0);
            }
        }

        // store Δh, then horizontal shift + new Δv
        std::memcpy(&ph_col[static_cast<size_t>(j) * W], ph.data(), W * 8);
        std::memcpy(&mh_col[static_cast<size_t>(j) * W], mh.data(), W * 8);
        uint64_t hp_carry = lo_of(j) >= 1 ? 1 : 0;  // boundary pessimism
        uint64_t hn_carry = 0;
        for (int64_t w = 0; w < W; w++) {
            uint64_t const ph_sh = (ph[w] << 1) | hp_carry;
            uint64_t const mh_sh = (mh[w] << 1) | hn_carry;
            hp_carry = ph[w] >> 63;
            hn_carry = mh[w] >> 63;
            uint64_t const xv = eq[w];
            vp[w] = mh_sh | ~(xv | ph_sh);
            vn[w] = ph_sh & xv;
        }
        std::memcpy(&vp_col[static_cast<size_t>(j) * W], vp.data(), W * 8);
        std::memcpy(&vn_col[static_cast<size_t>(j) * W], vn.data(), W * 8);
    }

    if (!s_m_live || s_m != distance) return 14;
    }

#ifdef FLOXER_TB_AVX512
walkback:
#endif
    // delta-decoding walk-back, identical decisions to the scalar trace
    auto bit_of = [&](const uint64_t* arr, int64_t j, int64_t p) {
        return (arr[static_cast<size_t>(j) * W + p / 64] >>
                (p % 64)) & uint64_t(1);
    };
    std::vector<uint8_t> reversed_ops;
    reversed_ops.reserve(m + half + 1);
    int64_t i = m, j = end_col, v = distance;
    while (i > 0) {
        if (j < 0) return 15;
        int64_t const p = i - lo_of(j);
        if (p < pad || p >= b_store) return 16;
        // insertion first: needs (i-1, j) inside the nominal band and an
        // exact up == v, i.e. a +1 vertical delta at (i, j)
        if (p - 1 >= pad && bit_of(vp_col, j, p)) {
            reversed_ops.push_back(2);
            i -= 1;
            v -= 1;
            continue;
        }
        if (j >= 1) {
            // D(i-1, j-1) via whichever neighbour is in the nominal band
            bool have_diag = false;
            int64_t diag_prev = 0;
            if (p - 1 >= pad) {
                int64_t const dv =
                    bit_of(vp_col, j, p) ? 1 : (bit_of(vn_col, j, p) ? -1 : 0);
                int64_t const up_val = v - dv;  // D(i-1, j)
                int64_t const dh = bit_of(ph_col, j, p - 1)
                                       ? 1
                                       : (bit_of(mh_col, j, p - 1) ? -1 : 0);
                diag_prev = up_val - dh;
                have_diag = true;
            } else if (p + 1 < b_store) {
                int64_t const dh =
                    bit_of(ph_col, j, p) ? 1 : (bit_of(mh_col, j, p) ? -1 : 0);
                int64_t const left_val = v - dh;  // D(i, j-1)
                int64_t const dv = bit_of(vp_col, j - 1, p + 1)
                                       ? 1
                                       : (bit_of(vn_col, j - 1, p + 1) ? -1 : 0);
                diag_prev = left_val - dv;
                have_diag = true;
            }
            if (have_diag) {
                int64_t const sub = ref[j - 1] != query[i - 1] ? 1 : 0;
                if (diag_prev + sub == v) {
                    reversed_ops.push_back(sub ? 1 : 0);
                    i -= 1;
                    j -= 1;
                    v = diag_prev;
                    continue;
                }
            }
            // deletion: needs (i, j-1) in band and left == v
            if (p + 1 < b_store && bit_of(ph_col, j, p)) {
                reversed_ops.push_back(3);
                j -= 1;
                v -= 1;
                continue;
            }
        }
        return 17;
    }

    int64_t const num_ops = static_cast<int64_t>(reversed_ops.size());
    if (num_ops > max_ops) return 3;
    for (int64_t k = 0; k < num_ops; k++)
        out_ops[k] = reversed_ops[num_ops - 1 - k];
    *out_begin = j;
    *out_num_ops = num_ops;
    return 0;
}

}  // namespace

int floxer_banded_traceback(const uint8_t* ref, int64_t n, const uint8_t* query,
                            int64_t m, int64_t end_col, int64_t distance,
                            int64_t* out_begin, uint8_t* out_ops,
                            int64_t max_ops, int64_t* out_num_ops) {
    int const status = banded_traceback_myers(
        ref, n, query, m, end_col, distance, out_begin, out_ops, max_ops,
        out_num_ops);
    if (status == 0 || status == 3) return status;
    return floxer_banded_traceback_scalar(
        ref, n, query, m, end_col, distance, out_begin, out_ops, max_ops,
        out_num_ops);
}

// Traceback + run-length encoding + CIGAR string formatting in one call:
// a 20 kb read carries ~22k ops / ~2k runs, and formatting those in Python
// costs more than the band fill itself (profiled; the SAM writer's
// f-string join dominated). scratch_ops is caller-provided (>= max_ops).
int floxer_banded_traceback_rle(
    const uint8_t* ref, int64_t n, const uint8_t* query,
    int64_t m, int64_t end_col, int64_t distance,
    int64_t* out_begin,
    uint8_t* scratch_ops, int64_t max_ops,
    int64_t* out_counts, uint8_t* out_op_chars, int64_t max_runs,
    int64_t* out_num_runs,
    uint8_t* out_str, int64_t max_str, int64_t* out_str_len) {
    int64_t num_ops = 0;
    int const status = floxer_banded_traceback(
        ref, n, query, m, end_col, distance, out_begin, scratch_ops, max_ops,
        &num_ops);
    if (status != 0) return status;
    static char const kOpChar[4] = {'=', 'X', 'I', 'D'};
    int64_t runs = 0;
    int64_t str_len = 0;
    int64_t i = 0;
    while (i < num_ops) {
        uint8_t const op = scratch_ops[i];
        int64_t j = i + 1;
        while (j < num_ops && scratch_ops[j] == op) j++;
        if (runs >= max_runs) return 4;
        int64_t const count = j - i;
        char const op_char = op < 4 ? kOpChar[op] : '?';
        out_counts[runs] = count;
        out_op_chars[runs] = static_cast<uint8_t>(op_char);
        char buf[24];
        int len = 0;
        {
            int64_t v = count;
            char tmp[24];
            int t = 0;
            do {
                tmp[t++] = static_cast<char>('0' + v % 10);
                v /= 10;
            } while (v);
            while (t) buf[len++] = tmp[--t];
        }
        if (str_len + len + 1 > max_str) return 4;
        std::memcpy(out_str + str_len, buf, static_cast<size_t>(len));
        str_len += len;
        out_str[str_len++] = static_cast<uint8_t>(op_char);
        runs++;
        i = j;
    }
    *out_num_runs = runs;
    *out_str_len = str_len;
    return 0;
}

}  // extern "C"
