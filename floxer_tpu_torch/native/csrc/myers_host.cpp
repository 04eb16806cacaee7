// Batched bit-parallel semi-global edit distance on the host.
//
// Native mirror of ops/dp_reference.semi_global_dp_matrix +
// _rightmost_argmin (the reference-pinned seqan3-compatible optimum:
// dp[0][j] = 0 free text prefix, query aligned end-to-end, optimum =
// rightmost minimal end column EXCLUDING the flush-with-window-end
// column). Used by the batch verifier's host fallback when no
// accelerator is present — Myers' multi-word bit-vector algorithm runs
// ~50-100x faster than the vectorized numpy DP at verification shapes.
//
// Build: compiled into libfloxer_native.so (Makefile NATIVE_SRCS).

#include <cstdint>
#include <algorithm>
#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kSigma = 8;  // rank alphabet 0..5 (+ padding headroom)

void one_task(
    const uint8_t* window, int64_t n,
    const uint8_t* pattern, int64_t m,
    int64_t* out_distance, int64_t* out_end,
    std::vector<uint64_t>& eq_scratch) {
    if (m <= 0) {
        *out_distance = 0;
        *out_end = 0;
        return;
    }
    int64_t const words = (m + 63) / 64;
    eq_scratch.assign(static_cast<size_t>(kSigma * words), 0);
    uint64_t* eq = eq_scratch.data();
    for (int64_t i = 0; i < m; i++) {
        int const symbol = pattern[i] & (kSigma - 1);
        eq[symbol * words + i / 64] |= uint64_t(1) << (i % 64);
    }

    std::vector<uint64_t> vp(static_cast<size_t>(words), ~uint64_t(0));
    std::vector<uint64_t> vn(static_cast<size_t>(words), 0);
    int64_t const msb_word = (m - 1) / 64;
    uint64_t const msb_mask = uint64_t(1) << ((m - 1) % 64);

    int64_t score = m;
    int64_t best = m;   // column 0: dp[m][0] = m
    int64_t best_end = 0;
    // eligible end columns are 0..n-1 (the flush column n is excluded),
    // so only the first n-1 text characters can improve the optimum
    for (int64_t j = 1; j < n; j++) {
        const uint64_t* eq_row = eq + (window[j - 1] & (kSigma - 1)) * words;
        uint64_t add_carry = 0, hp_carry = 0, hn_carry = 0;
        int64_t delta = 0;
        for (int64_t w = 0; w < words; w++) {
            uint64_t const eq_w = eq_row[w];
            uint64_t const vp_w = vp[w];
            uint64_t const vn_w = vn[w];
            uint64_t const a = eq_w & vp_w;
            uint64_t t = a + vp_w;
            uint64_t c1 = t < a;
            uint64_t const s = t + add_carry;
            c1 |= s < t;
            add_carry = c1;
            uint64_t const xh = (s ^ vp_w) | eq_w;
            uint64_t const xv = eq_w | vn_w;
            uint64_t ph = vn_w | ~(xh | vp_w);
            uint64_t mh = vp_w & xh;
            if (w == msb_word) {
                delta = int64_t((ph & msb_mask) != 0) -
                        int64_t((mh & msb_mask) != 0);
            }
            uint64_t const ph_out = ph >> 63;
            uint64_t const mh_out = mh >> 63;
            ph = (ph << 1) | hp_carry;
            mh = (mh << 1) | hn_carry;
            hp_carry = ph_out;
            hn_carry = mh_out;
            vp[w] = mh | ~(xv | ph);
            vn[w] = ph & xv;
        }
        score += delta;
        if (score <= best) {  // <= keeps the RIGHTMOST minimal column
            best = score;
            best_end = j;
        }
    }
    *out_distance = best;
    *out_end = best_end;
}

// Banded sliding-window variant: exact mirror of ops/myers_banded.py
// (myers_banded_np) with 64-bit words — carries only the exactness band of
// B = n - m + 2*budget + 1 rows. Output-equivalent to the full DP for
// every value the pipeline consumes (distance <= budget exact; otherwise
// the reject decision agrees; proof in the mirror's module docstring).
void one_task_banded(
    const uint8_t* window, int64_t n,
    const uint8_t* pattern, int64_t m,
    int64_t budget,
    int64_t* out_distance, int64_t* out_end,
    std::vector<uint64_t>& scratch) {
    constexpr int kRanks = 6;  // real alphabet ranks 0..5
    int64_t const b_nominal = (n - m) + 2 * budget + 1;
    int64_t const bw = (b_nominal + 63) / 64;
    int64_t const b_store = bw * 64;

    // scratch layout: vp | vn | m_mask | peq[kRanks]
    scratch.assign(static_cast<size_t>((3 + kRanks) * bw), 0);
    uint64_t* vp = scratch.data();
    uint64_t* vn = vp + bw;
    uint64_t* m_mask = vn + bw;
    uint64_t* peq = m_mask + bw;

    // initial band at column 0: band position p holds absolute row
    // i(p) = budget - (b_store - 1 - p); rows <= 0 are the free-start
    // padding (all-match, flat), rows 1..budget carry the pattern prefix
    for (int64_t p = 0; p < b_store; p++) {
        int64_t const row = p + budget - (b_store - 1);
        uint64_t const bit = uint64_t(1) << (p % 64);
        int64_t const w = p / 64;
        if (row >= 1) {
            vp[w] |= bit;
            if (row <= m) peq[(pattern[row - 1] % kRanks) * bw + w] |= bit;
        } else {
            for (int s = 0; s < kRanks; s++) peq[int64_t(s) * bw + w] |= bit;
        }
    }

    auto shift_right_one = [bw](uint64_t* words, int entering) {
        for (int64_t w = 0; w < bw - 1; w++) {
            words[w] = (words[w] >> 1) | (words[w + 1] << 63);
        }
        words[bw - 1] >>= 1;
        if (entering) words[bw - 1] |= uint64_t(1) << 63;
    };

    uint64_t const top_bit = uint64_t(1) << 63;
    int64_t s_bot = budget;
    int64_t s_m = m;
    int64_t best = m;
    int64_t best_end = 0;
    int64_t const j_star = m - budget;
    int64_t const top_real_after = b_store - 1 - budget;

    std::vector<uint64_t> xv_v(static_cast<size_t>(bw)),
        ph_v(static_cast<size_t>(bw)), mh_v(static_cast<size_t>(bw));
    uint64_t* xv = xv_v.data();
    uint64_t* ph = ph_v.data();
    uint64_t* mh = mh_v.data();

    for (int64_t j = 0; j < n; j++) {
        int64_t const col = j + 1;
        shift_right_one(vp, 1);
        shift_right_one(vn, 0);
        s_bot += 1;
        int64_t const enter_row = j + budget;  // pattern index of new row
        int const ch = enter_row < m ? pattern[enter_row] % kRanks : -1;
        for (int s = 0; s < kRanks; s++) {
            shift_right_one(peq + int64_t(s) * bw, ch == s);
        }
        shift_right_one(m_mask, col == j_star);

        int const tch = window[j] % kRanks;
        const uint64_t* eq = peq + int64_t(tch) * bw;

        uint64_t add_carry = 0;
        for (int64_t w = 0; w < bw; w++) {
            uint64_t const eq_w = eq[w];
            uint64_t const vp_w = vp[w];
            uint64_t const a = eq_w & vp_w;
            uint64_t t = a + vp_w;
            uint64_t c1 = t < a;
            uint64_t const s = t + add_carry;
            c1 |= s < t;
            add_carry = c1;
            uint64_t const xh = (s ^ vp_w) | eq_w;
            xv[w] = eq_w | vn[w];
            ph[w] = vn[w] | ~(xh | vp_w);
            mh[w] = vp_w & xh;
        }

        s_bot += int64_t((ph[bw - 1] & top_bit) != 0) -
                 int64_t((mh[bw - 1] & top_bit) != 0);
        if (col == j_star) {
            s_m = s_bot;
        } else {
            int ph_m = 0, mh_m = 0;
            for (int64_t w = 0; w < bw; w++) {
                ph_m |= (ph[w] & m_mask[w]) != 0;
                mh_m |= (mh[w] & m_mask[w]) != 0;
            }
            s_m += int64_t(ph_m) - int64_t(mh_m);
        }

        uint64_t ph_carry = col > top_real_after ? 1 : 0;
        uint64_t mh_carry = 0;
        for (int64_t w = 0; w < bw; w++) {
            uint64_t const ph_out = ph[w] >> 63;
            uint64_t const mh_out = mh[w] >> 63;
            uint64_t const ph_sh = (ph[w] << 1) | ph_carry;
            uint64_t const mh_sh = (mh[w] << 1) | mh_carry;
            ph_carry = ph_out;
            mh_carry = mh_out;
            vp[w] = mh_sh | ~(xv[w] | ph_sh);
            vn[w] = ph_sh & xv[w];
        }

        if (col >= j_star && col < n && s_m <= best) {
            best = s_m;
            best_end = col;
        }
    }
    *out_distance = best;
    *out_end = best_end;
}

// Lane-parallel banded variant: kLanes tasks advance together using GCC
// vector extensions (one AVX-512 vector of uint64 lanes per band word).
// Per-symbol Peq masks are replaced by the TPU kernel's bit-plane form —
// three char bit-planes plus an all-match plane, Eq = XNOR-reduce against
// the text char's bits — so the column body is purely elementwise over
// lane vectors (no per-lane gathers, fully vectorizable). The Myers ADD
// carry is per-lane data (lanewise compares), so the word loop stays
// serial but every op processes kLanes tasks.
constexpr int kLanes = 8;
typedef uint64_t v8 __attribute__((vector_size(kLanes * 8)));

struct BandedLaneBlock {
    std::vector<v8> vp, vn, mm, p0, p1, p2, am, xv, ph, mh;
    std::vector<uint8_t> text;    // [n_max][lane], 7 = matches nothing
    std::vector<uint8_t> stream;  // entering pattern chars, 7 = none
    int64_t j_star[kLanes];
    int64_t top_real_after[kLanes];
    int64_t n[kLanes];
    int64_t s_bot[kLanes];
    int64_t s_m[kLanes];
    int64_t best[kLanes];
    int64_t best_end[kLanes];
};

void banded_lane_block(
    const uint8_t* const* windows, const int64_t* ns,
    const uint8_t* const* patterns, const int64_t* ms,
    const int64_t* budgets, int num_lanes,
    int64_t* out_distance, int64_t* out_end,
    BandedLaneBlock& blk) {
    int64_t bw = 1;
    int64_t n_max = 0;
    for (int l = 0; l < num_lanes; l++) {
        int64_t const nominal = (ns[l] - ms[l]) + 2 * budgets[l] + 1;
        int64_t const w = (nominal + 63) / 64;
        bw = w > bw ? w : bw;
        n_max = ns[l] > n_max ? ns[l] : n_max;
    }
    // extra stored rows sit ABOVE the band and only overestimate — padding
    // every lane to the block-max band width preserves exactness
    int64_t const b_store = bw * 64;

    v8 const zero = {};
    blk.vp.assign(static_cast<size_t>(bw), zero);
    blk.vn.assign(static_cast<size_t>(bw), zero);
    blk.mm.assign(static_cast<size_t>(bw), zero);
    blk.p0.assign(static_cast<size_t>(bw), zero);
    blk.p1.assign(static_cast<size_t>(bw), zero);
    blk.p2.assign(static_cast<size_t>(bw), zero);
    blk.am.assign(static_cast<size_t>(bw), zero);
    blk.xv.assign(static_cast<size_t>(bw), zero);
    blk.ph.assign(static_cast<size_t>(bw), zero);
    blk.mh.assign(static_cast<size_t>(bw), zero);
    blk.text.assign(static_cast<size_t>(n_max * kLanes), 7);
    blk.stream.assign(static_cast<size_t>(n_max * kLanes), 7);

    v8* vp = blk.vp.data();
    v8* vn = blk.vn.data();
    v8* mm = blk.mm.data();
    v8* p0 = blk.p0.data();
    v8* p1 = blk.p1.data();
    v8* p2 = blk.p2.data();
    v8* am = blk.am.data();
    v8* xv = blk.xv.data();
    v8* ph = blk.ph.data();
    v8* mh = blk.mh.data();
    uint8_t* text = blk.text.data();
    uint8_t* stream = blk.stream.data();

    // padding lanes (num_lanes < kLanes) still flow through every per-lane
    // loop: give them inert scalars (never at-seed, never eligible)
    for (int l = 0; l < kLanes; l++) {
        blk.j_star[l] = INT64_MAX;
        blk.top_real_after[l] = 0;
        blk.n[l] = 0;
        blk.s_bot[l] = 0;
        blk.s_m[l] = 0;
        blk.best[l] = 0;
        blk.best_end[l] = 0;
    }
    for (int l = 0; l < num_lanes; l++) {
        int64_t const m = ms[l];
        int64_t const n = ns[l];
        int64_t const budget = budgets[l];
        const uint8_t* pattern = patterns[l];
        for (int64_t p = 0; p < b_store; p++) {
            int64_t const row = p + budget - (b_store - 1);
            uint64_t const bit = uint64_t(1) << (p % 64);
            int64_t const w = p / 64;
            if (row >= 1) {
                blk.vp[w][l] |= bit;
                if (row <= m) {
                    int const ch = pattern[row - 1] & 7;
                    if (ch & 1) blk.p0[w][l] |= bit;
                    if (ch & 2) blk.p1[w][l] |= bit;
                    if (ch & 4) blk.p2[w][l] |= bit;
                }
            } else {
                blk.am[w][l] |= bit;  // rows <= 0: all symbols match
            }
        }
        for (int64_t j = 0; j < n; j++) {
            text[j * kLanes + l] = windows[l][j] & 7;
            int64_t const enter_row = j + budget;
            // 7 (0b111) matches no rank 0..5 via the bit planes
            stream[j * kLanes + l] =
                enter_row < m ? (patterns[l][enter_row] & 7) : 7;
        }
        blk.j_star[l] = m - budget;
        blk.top_real_after[l] = b_store - 1 - budget;
        blk.n[l] = n;
        blk.s_bot[l] = budget;
        blk.s_m[l] = m;
        blk.best[l] = m;
        blk.best_end[l] = 0;
    }

    uint64_t const top_bit = uint64_t(1) << 63;
    v8 const ones = ~zero;

    for (int64_t j = 0; j < n_max; j++) {
        int64_t const col = j + 1;

        // per-lane text/stream char bit masks for this column
        v8 t0, t1, t2, tpad, e0, e1, e2, epad, emm;
        for (int l = 0; l < kLanes; l++) {
            int const tc = text[j * kLanes + l];
            t0[l] = tc & 1 ? ~uint64_t(0) : 0;
            t1[l] = tc & 2 ? ~uint64_t(0) : 0;
            t2[l] = tc & 4 ? ~uint64_t(0) : 0;
            tpad[l] = tc == 7 ? ~uint64_t(0) : 0;  // matches nothing
            int const pc = stream[j * kLanes + l];
            // pc == 7 (past the pattern end) keeps all three bits set:
            // plane code 0b111 matches no real text char 0..5
            e0[l] = pc & 1 ? top_bit : 0;
            e1[l] = pc & 2 ? top_bit : 0;
            e2[l] = pc & 4 ? top_bit : 0;
            epad[l] = 0;
            emm[l] = col == blk.j_star[l] ? top_bit : 0;
        }

        // band slide: every array shifts one bit toward p=0; entering bits
        // at the top of the last word
        for (int64_t w = 0; w < bw - 1; w++) {
            vp[w] = (vp[w] >> 1) | (vp[w + 1] << 63);
            vn[w] = (vn[w] >> 1) | (vn[w + 1] << 63);
            mm[w] = (mm[w] >> 1) | (mm[w + 1] << 63);
            p0[w] = (p0[w] >> 1) | (p0[w + 1] << 63);
            p1[w] = (p1[w] >> 1) | (p1[w + 1] << 63);
            p2[w] = (p2[w] >> 1) | (p2[w + 1] << 63);
            am[w] = (am[w] >> 1) | (am[w + 1] << 63);
        }
        {
            int64_t const w = bw - 1;
            v8 enter_vp;
            for (int l = 0; l < kLanes; l++) enter_vp[l] = top_bit;
            vp[w] = (vp[w] >> 1) | enter_vp;
            vn[w] = vn[w] >> 1;
            mm[w] = (mm[w] >> 1) | emm;
            p0[w] = (p0[w] >> 1) | e0;
            p1[w] = (p1[w] >> 1) | e1;
            p2[w] = (p2[w] >> 1) | e2;
            am[w] = (am[w] >> 1) | epad;
        }

        // Myers column update; Eq from bit planes (XNOR reduce), padding
        // text chars (7) match nothing
        v8 add_carry = zero;
        v8 ph_m_any = zero;
        v8 mh_m_any = zero;
        for (int64_t w = 0; w < bw; w++) {
            v8 const eq =
                (~((p0[w] ^ t0) | (p1[w] ^ t1) | (p2[w] ^ t2) | tpad)) |
                am[w];
            v8 const vp_w = vp[w];
            v8 const a = eq & vp_w;
            v8 const t = a + vp_w;
            v8 const s = t + add_carry;
            add_carry = ((v8)(t < a) | (v8)(s < t)) & 1;
            v8 const xh = (s ^ vp_w) | eq;
            xv[w] = eq | vn[w];
            ph[w] = vn[w] | ~(xh | vp_w);
            mh[w] = vp_w & xh;
            ph_m_any |= ph[w] & mm[w];
            mh_m_any |= mh[w] & mm[w];
        }

        // scores + eligibility (branchless per lane)
        v8 const ph_last = ph[bw - 1];
        v8 const mh_last = mh[bw - 1];
        for (int l = 0; l < kLanes; l++) {
            int64_t const d_bot = int64_t((ph_last[l] & top_bit) != 0) -
                                  int64_t((mh_last[l] & top_bit) != 0);
            blk.s_bot[l] += 1 + d_bot;  // entering bottom row delta +1
            bool const at_seed = col == blk.j_star[l];
            int64_t const d_m =
                int64_t(ph_m_any[l] != 0) - int64_t(mh_m_any[l] != 0);
            blk.s_m[l] = at_seed ? blk.s_bot[l] : blk.s_m[l] + d_m;
            bool const eligible = col >= blk.j_star[l] && col < blk.n[l];
            if (eligible && blk.s_m[l] <= blk.best[l]) {
                blk.best[l] = blk.s_m[l];
                blk.best_end[l] = col;
            }
        }

        // horizontal shift down one row
        v8 ph_carry, mh_carry = zero;
        for (int l = 0; l < kLanes; l++) {
            ph_carry[l] = col > blk.top_real_after[l] ? 1 : 0;
        }
        for (int64_t w = 0; w < bw; w++) {
            v8 const ph_out = ph[w] >> 63;
            v8 const mh_out = mh[w] >> 63;
            v8 const ph_sh = (ph[w] << 1) | ph_carry;
            v8 const mh_sh = (mh[w] << 1) | mh_carry;
            ph_carry = ph_out;
            mh_carry = mh_out;
            vp[w] = mh_sh | ~(xv[w] | ph_sh);
            vn[w] = ph_sh & xv[w];
        }
    }

    for (int l = 0; l < num_lanes; l++) {
        out_distance[l] = blk.best[l];
        out_end[l] = blk.best_end[l];
    }
}

}  // namespace

extern "C" {

int floxer_myers_distance_batch(
    const uint8_t* window_buffer, const int64_t* window_offsets,
    const int64_t* window_lengths,
    const uint8_t* pattern_buffer, const int64_t* pattern_offsets,
    const int64_t* pattern_lengths,
    const int64_t* budgets,  // -1 = unknown -> always full-state
    int64_t num_tasks,
    int64_t* out_distance, int64_t* out_end,
    int64_t num_threads) {
    if (num_tasks <= 0) return 0;
    if (num_threads < 1) num_threads = 1;
    if (num_threads > num_tasks) num_threads = num_tasks;

    // classify: banded tasks run lane-parallel in blocks of kLanes (grouped
    // by band width so block padding stays small), the rest full-state
    std::vector<int64_t> banded_ids, full_ids;
    banded_ids.reserve(static_cast<size_t>(num_tasks));
    for (int64_t t = 0; t < num_tasks; t++) {
        int64_t const m = pattern_lengths[t];
        int64_t const n = window_lengths[t];
        int64_t const budget = budgets ? budgets[t] : -1;
        bool banded = budget > 0 && budget < m && n >= m - budget;
        if (banded) {
            // banded wins when its band state is strictly narrower
            int64_t const bw_band = ((n - m) + 2 * budget + 1 + 63) / 64;
            int64_t const bw_full = (m + 63) / 64;
            banded = bw_band < bw_full;
        }
        (banded ? banded_ids : full_ids).push_back(t);
    }
    std::sort(
        banded_ids.begin(), banded_ids.end(),
        [&](int64_t a, int64_t b) {
            int64_t const wa =
                (window_lengths[a] - pattern_lengths[a]) + 2 * budgets[a];
            int64_t const wb =
                (window_lengths[b] - pattern_lengths[b]) + 2 * budgets[b];
            if (wa != wb) return wa < wb;
            return window_lengths[a] < window_lengths[b];
        });

    // job list: lane blocks first, then scalar full tasks
    struct Job {
        int64_t block_begin;  // into banded_ids, or -1
        int num_lanes;
        int64_t full_id;  // into tasks, or -1
    };
    std::vector<Job> jobs;
    for (size_t b = 0; b < banded_ids.size(); b += kLanes) {
        int const lanes = static_cast<int>(
            banded_ids.size() - b < kLanes ? banded_ids.size() - b : kLanes);
        jobs.push_back({static_cast<int64_t>(b), lanes, -1});
    }
    for (int64_t t : full_ids) jobs.push_back({-1, 0, t});

    std::atomic<int64_t> next_job{0};
    auto worker = [&]() {
        std::vector<uint64_t> eq_scratch;
        std::vector<uint64_t> band_scratch;
        BandedLaneBlock blk;
        for (;;) {
            int64_t const at = next_job.fetch_add(1);
            if (at >= static_cast<int64_t>(jobs.size())) break;
            Job const& job = jobs[static_cast<size_t>(at)];
            if (job.full_id >= 0) {
                int64_t const t = job.full_id;
                one_task(
                    window_buffer + window_offsets[t], window_lengths[t],
                    pattern_buffer + pattern_offsets[t], pattern_lengths[t],
                    out_distance + t, out_end + t, eq_scratch);
                continue;
            }
            if (job.num_lanes == 1) {
                int64_t const t = banded_ids[job.block_begin];
                one_task_banded(
                    window_buffer + window_offsets[t], window_lengths[t],
                    pattern_buffer + pattern_offsets[t], pattern_lengths[t],
                    budgets[t], out_distance + t, out_end + t, band_scratch);
                continue;
            }
            const uint8_t* wins[kLanes];
            const uint8_t* pats[kLanes];
            int64_t ns_l[kLanes], ms_l[kLanes], ks_l[kLanes];
            int64_t dist_l[kLanes], end_l[kLanes];
            for (int l = 0; l < job.num_lanes; l++) {
                int64_t const t = banded_ids[job.block_begin + l];
                wins[l] = window_buffer + window_offsets[t];
                pats[l] = pattern_buffer + pattern_offsets[t];
                ns_l[l] = window_lengths[t];
                ms_l[l] = pattern_lengths[t];
                ks_l[l] = budgets[t];
            }
            banded_lane_block(
                wins, ns_l, pats, ms_l, ks_l, job.num_lanes, dist_l, end_l,
                blk);
            for (int l = 0; l < job.num_lanes; l++) {
                int64_t const t = banded_ids[job.block_begin + l];
                out_distance[t] = dist_l[l];
                out_end[t] = end_l[l];
            }
        }
    };
    if (num_threads == 1) {
        worker();
        return 0;
    }
    std::vector<std::thread> threads;
    for (int64_t i = 0; i < num_threads; i++) threads.emplace_back(worker);
    for (auto& thread : threads) thread.join();
    return 0;
}

}  // extern "C"
