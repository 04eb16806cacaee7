// Native approximate seed search: bidirectional FM-index DFS over expanded
// search schemes.
//
// Exact port of floxer_tpu.search_host._run_scheme_search /
// search_seed_groups (which is itself the behavioral equivalent of
// fmindex-collection's search_ng21 as used in the reference's
// src/lib/search.cpp:173-188): identical branch order (match, substitutions
// over symbols 1..5, insertions 1..5, deletion), identical canonicalization
// (no insertion<->deletion adjacency), identical first-report dedup by
// (lb, len, errors) and identical early abort on the raw-anchor cap — so the
// reported groups are byte-identical to the Python oracle, in the same
// order.
//
// Build: compiled into libfloxer_native.so together with sais.cpp.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <thread>
#include <unordered_set>
#include <vector>

#include <atomic>

// debug accounting (floxer_search_stats): occ-scan call counts let the
// host attribute search time between rank scans and DFS overhead without
// a sampling profiler on the box. Opt-in via FLOXER_TPU_SEARCH_STATS —
// the contended fetch_adds cost ~3x on the threaded search when enabled,
// so never benchmark with the counters on.
static std::atomic<int64_t> g_occ_all_calls{0};
static std::atomic<int64_t> g_occ_pair_calls{0};
static std::atomic<int64_t> g_dfs_steps{0};
static bool const g_count_stats =
    std::getenv("FLOXER_TPU_SEARCH_STATS") != nullptr;

// stage wall-time split (ns), also only accumulated when the opt-in
// stats env is set: worker = whole seed range (DFS + select), select =
// the post-DFS anchor selection incl. locate walks. Diagnostic only.
static std::atomic<int64_t> g_worker_ns{0};
static std::atomic<int64_t> g_select_ns{0};

extern "C" void floxer_stage_ns(int64_t* out2, int64_t reset) {
    out2[0] = g_worker_ns.load(std::memory_order_relaxed);
    out2[1] = g_select_ns.load(std::memory_order_relaxed);
    if (reset) {
        g_worker_ns.store(0, std::memory_order_relaxed);
        g_select_ns.store(0, std::memory_order_relaxed);
    }
}

extern "C" void floxer_search_stats(int64_t* out3, int64_t reset) {
    out3[0] = g_occ_all_calls.load(std::memory_order_relaxed);
    out3[1] = g_occ_pair_calls.load(std::memory_order_relaxed);
    out3[2] = g_dfs_steps.load(std::memory_order_relaxed);
    if (reset) {
        g_occ_all_calls.store(0, std::memory_order_relaxed);
        g_occ_pair_calls.store(0, std::memory_order_relaxed);
        g_dfs_steps.store(0, std::memory_order_relaxed);
    }
}

namespace {

constexpr int SIGMA = 6;
constexpr int64_t OCC_BLOCK = 128;

// Interleaved occ-block layout (the native in-RAM index format): one
// 128-byte row per OCC_BLOCK positions holding [6 x int64 checkpoint |
// 64 nibble-packed symbols | 16 B pad]. A rank query touches exactly two
// adjacent cache lines of one row instead of a checkpoint line plus 1-2
// bwt lines in a separate 500 MB array — at reference-evaluation genome
// scale (10 x 50 Mb) the search was memory-stall-bound (74 M scattered
// occ scans per 250-read chunk, ~2.5 misses each), not compute-bound.
// This is the same locality argument behind the reference's EPR
// dictionaries (fmindex.hpp:8, EprV2_16). Symbol at block position p
// lives in byte p/2: low nibble for even p, high nibble for odd p. Rows
// are built by the Python loader (index/fmindex.py packed_occ_rows) from
// the artifact's plain bwt + checkpoints.
constexpr int64_t OCC_ROW_BYTES = 128;
constexpr int64_t OCC_NIBBLE_OFFSET = 48;

struct SingleIndex {
    const uint8_t* packed;  // [nb][OCC_ROW_BYTES] interleaved rows
};

struct BiIndex {
    SingleIndex fwd;
    SingleIndex rev;
    const int64_t* C;  // [SIGMA + 1]
    int64_t n;
};

// bwt symbol at one position (the LF walk's branch input)
inline int symbol_at(const SingleIndex& idx, int64_t pos) {
    uint8_t const b = idx.packed[(pos / OCC_BLOCK) * OCC_ROW_BYTES +
                                 OCC_NIBBLE_OFFSET +
                                 ((pos % OCC_BLOCK) >> 1)];
    return (pos & 1) ? (b >> 4) : (b & 0x0F);
}

#if defined(__AVX512BW__) && defined(__BMI2__)
// AVX-512 row scan: one 64-byte load covers all 128 block symbols as
// nibbles; per symbol two vpcmpb against the low/high nibble planes ->
// masked popcounts. Prefix masks: low nibble i holds position 2i (valid
// while 2i < len), high nibble i holds 2i+1 (valid while 2i+1 < len).
#include <immintrin.h>

struct RowView {
    const int64_t* base;  // 6 checkpoint counts
    __m512i lo, hi;       // nibble planes
    __mmask64 mlo, mhi;   // prefix masks
};

inline RowView load_row(const SingleIndex& idx, int64_t pos) {
    int64_t const block = pos / OCC_BLOCK;
    int64_t const len = pos - block * OCC_BLOCK;
    const uint8_t* row = idx.packed + block * OCC_ROW_BYTES;
    RowView r;
    r.base = reinterpret_cast<const int64_t*>(row);
    __m512i const v = _mm512_loadu_si512(row + OCC_NIBBLE_OFFSET);
    __m512i const mask_low = _mm512_set1_epi8(0x0F);
    r.lo = _mm512_and_si512(v, mask_low);
    r.hi = _mm512_and_si512(_mm512_srli_epi16(v, 4), mask_low);
    r.mlo = _bzhi_u64(~0ull, (unsigned)((len + 1) >> 1));
    r.mhi = _bzhi_u64(~0ull, (unsigned)(len >> 1));
    return r;
}

inline void occ_all(const SingleIndex& idx, int64_t pos, int64_t* out) {
    RowView const r = load_row(idx, pos);
    for (int s = 0; s < SIGMA; s++) {
        __m512i const sv = _mm512_set1_epi8((char)s);
        uint64_t const c0 = _mm512_mask_cmpeq_epi8_mask(r.mlo, r.lo, sv);
        uint64_t const c1 = _mm512_mask_cmpeq_epi8_mask(r.mhi, r.hi, sv);
        out[s] =
            r.base[s] + __builtin_popcountll(c0) + __builtin_popcountll(c1);
    }
}

// count of one symbol in bwt[:pos] (the LF-walk step of locate)
inline int64_t occ_one(const SingleIndex& idx, int64_t pos, int symbol) {
    RowView const r = load_row(idx, pos);
    __m512i const sv = _mm512_set1_epi8((char)symbol);
    uint64_t const c0 = _mm512_mask_cmpeq_epi8_mask(r.mlo, r.lo, sv);
    uint64_t const c1 = _mm512_mask_cmpeq_epi8_mask(r.mhi, r.hi, sv);
    return r.base[symbol] + __builtin_popcountll(c0) +
           __builtin_popcountll(c1);
}
#else
inline void occ_all(const SingleIndex& idx, int64_t pos, int64_t* out) {
    int64_t const block = pos / OCC_BLOCK;
    int64_t const len = pos - block * OCC_BLOCK;
    const uint8_t* row = idx.packed + block * OCC_ROW_BYTES;
    const int64_t* base = reinterpret_cast<const int64_t*>(row);
    const uint8_t* nib = row + OCC_NIBBLE_OFFSET;
    int32_t counts[SIGMA] = {0, 0, 0, 0, 0, 0};
    for (int64_t i = 0; i < len; i++) {
        uint8_t const c =
            (i & 1) ? (nib[i >> 1] >> 4) : (nib[i >> 1] & 0x0F);
        counts[0] += (c == 0);
        counts[1] += (c == 1);
        counts[2] += (c == 2);
        counts[3] += (c == 3);
        counts[4] += (c == 4);
        counts[5] += (c == 5);
    }
    for (int s = 0; s < SIGMA; s++) out[s] = base[s] + counts[s];
}

inline int64_t occ_one(const SingleIndex& idx, int64_t pos, int symbol) {
    int64_t const block = pos / OCC_BLOCK;
    int64_t const len = pos - block * OCC_BLOCK;
    const uint8_t* row = idx.packed + block * OCC_ROW_BYTES;
    int64_t count = reinterpret_cast<const int64_t*>(row)[symbol];
    const uint8_t* nib = row + OCC_NIBBLE_OFFSET;
    for (int64_t i = 0; i < len; i++) {
        uint8_t const c =
            (i & 1) ? (nib[i >> 1] >> 4) : (nib[i >> 1] & 0x0F);
        count += (c == symbol);
    }
    return count;
}
#endif

// single-symbol rank pair: #bwt[:pos]==sym and #bwt[:pos]<sym in one scan
// (two compare-accumulate lanes instead of occ_all's six). The < count is
// what the bidirectional lb_rev update needs as its symbol prefix sum.
inline void occ_eq_lt(const SingleIndex& idx, int64_t pos, uint8_t sym,
                      int64_t* eq, int64_t* lt) {
#if defined(__AVX512BW__) && defined(__BMI2__)
    RowView const r = load_row(idx, pos);
    int64_t base_lt = 0;
    for (int s = 0; s < sym; s++) base_lt += r.base[s];
    __m512i const sv = _mm512_set1_epi8((char)sym);
    uint64_t const e0 = _mm512_mask_cmpeq_epi8_mask(r.mlo, r.lo, sv);
    uint64_t const e1 = _mm512_mask_cmpeq_epi8_mask(r.mhi, r.hi, sv);
    uint64_t const l0 = _mm512_mask_cmplt_epu8_mask(r.mlo, r.lo, sv);
    uint64_t const l1 = _mm512_mask_cmplt_epu8_mask(r.mhi, r.hi, sv);
    *eq = r.base[sym] + __builtin_popcountll(e0) + __builtin_popcountll(e1);
    *lt = base_lt + __builtin_popcountll(l0) + __builtin_popcountll(l1);
#else
    int64_t const block = pos / OCC_BLOCK;
    int64_t const len = pos - block * OCC_BLOCK;
    const uint8_t* row = idx.packed + block * OCC_ROW_BYTES;
    const int64_t* base = reinterpret_cast<const int64_t*>(row);
    int64_t base_lt = 0;
    for (int s = 0; s < sym; s++) base_lt += base[s];
    const uint8_t* nib = row + OCC_NIBBLE_OFFSET;
    int32_t eq_count = 0;
    int32_t lt_count = 0;
    for (int64_t i = 0; i < len; i++) {
        uint8_t const c =
            (i & 1) ? (nib[i >> 1] >> 4) : (nib[i >> 1] & 0x0F);
        eq_count += (c == sym);
        lt_count += (c < sym);
    }
    *eq = base[sym] + eq_count;
    *lt = base_lt + lt_count;
#endif
}

struct Cursor {
    int64_t lb;
    int64_t lb_rev;
    int64_t len;
};

// all-SIGMA extension; children[s] is the cursor after adding symbol s
inline void extend_all(const BiIndex& index, const Cursor& cur, bool left,
                       Cursor* children) {
    int64_t lo[SIGMA], hi[SIGMA];
    const SingleIndex& idx = left ? index.fwd : index.rev;
    int64_t const base = left ? cur.lb : cur.lb_rev;
    if (g_count_stats) g_occ_all_calls.fetch_add(2, std::memory_order_relaxed);
    occ_all(idx, base, lo);
    occ_all(idx, base + cur.len, hi);
    int64_t prefix = 0;
    for (int s = 0; s < SIGMA; s++) {
        int64_t const count = hi[s] - lo[s];
        if (left) {
            children[s].lb = index.C[s] + lo[s];
            children[s].lb_rev = cur.lb_rev + prefix;
        } else {
            children[s].lb_rev = index.C[s] + lo[s];
            children[s].lb = cur.lb + prefix;
        }
        children[s].len = count;
        prefix += count;
    }
}

// single-symbol extension: exactly extend_all(...)[sym] but via two
// occ_eq_lt scans — the hot path once a branch's error budget is spent
// and only the matching child can be consumed
inline Cursor extend_one(const BiIndex& index, const Cursor& cur, bool left,
                         uint8_t sym) {
    const SingleIndex& idx = left ? index.fwd : index.rev;
    int64_t const base = left ? cur.lb : cur.lb_rev;
    int64_t lo_eq, lo_lt, hi_eq, hi_lt;
    if (g_count_stats) g_occ_pair_calls.fetch_add(2, std::memory_order_relaxed);
    occ_eq_lt(idx, base, sym, &lo_eq, &lo_lt);
    occ_eq_lt(idx, base + cur.len, sym, &hi_eq, &hi_lt);
    Cursor child;
    int64_t const prefix = hi_lt - lo_lt;
    if (left) {
        child.lb = index.C[sym] + lo_eq;
        child.lb_rev = cur.lb_rev + prefix;
    } else {
        child.lb_rev = index.C[sym] + lo_eq;
        child.lb = cur.lb + prefix;
    }
    child.len = hi_eq - lo_eq;
    return child;
}

struct PartSpec {
    int64_t start, end, direction, lower, upper;
};

struct GroupKey {
    int64_t lb, len, errors;
    bool operator==(const GroupKey& o) const {
        return lb == o.lb && len == o.len && errors == o.errors;
    }
};
struct GroupKeyHash {
    size_t operator()(const GroupKey& k) const {
        size_t h = std::hash<int64_t>()(k.lb);
        h ^= std::hash<int64_t>()(k.len) + 0x9e3779b97f4a7c15ull + (h << 6) +
             (h >> 2);
        h ^= std::hash<int64_t>()(k.errors) + 0x9e3779b97f4a7c15ull + (h << 6) +
             (h >> 2);
        return h;
    }
};

struct SearchState {
    const BiIndex* index;
    const uint8_t* pattern;
    const PartSpec* parts;
    int64_t num_parts;
    int64_t max_total;
    int64_t max_groups;

    int64_t* out_groups;  // [max_groups][4]: lb, lb_rev, len, errors
    int64_t num_groups = 0;
    int64_t total = 0;
    bool aborted = false;
    bool overflow = false;
    std::unordered_set<GroupKey, GroupKeyHash> seen;

    void report(const Cursor& cur, int64_t errors) {
        GroupKey const key{cur.lb, cur.len, errors};
        if (!seen.insert(key).second) return;
        if (num_groups >= max_groups) {
            overflow = true;
            aborted = true;
            return;
        }
        int64_t* row = out_groups + num_groups * 4;
        row[0] = cur.lb;
        row[1] = cur.lb_rev;
        row[2] = cur.len;
        row[3] = errors;
        num_groups++;
        total += cur.len;
        if (total >= max_total) aborted = true;
    }

    // last_op: 0 = match/sub, 1 = insertion, 2 = deletion
    void step(const Cursor& cur, int64_t part_idx, int64_t char_pos,
              int64_t errors, int last_op) {
        if (aborted) return;
        if (g_count_stats) g_dfs_steps.fetch_add(1, std::memory_order_relaxed);
        const PartSpec& part = parts[part_idx];
        bool const done = part.direction > 0 ? char_pos >= part.end
                                             : char_pos < part.start;
        if (done) {
            if (errors < part.lower) return;
            process_part(cur, part_idx + 1, errors, last_op);
            return;
        }

        int const pattern_symbol = pattern[char_pos];
        bool const left = part.direction < 0;
        int64_t const next_pos = char_pos + part.direction;

        if (errors >= part.upper) {
            // no substitutions/indels possible on this branch: only the
            // matching child is ever consumed — skip the 6-symbol ranks
            Cursor const child =
                extend_one(*index, cur, left, (uint8_t)pattern_symbol);
            if (child.len > 0) step(child, part_idx, next_pos, errors, 0);
            return;
        }

        Cursor children[SIGMA];
        extend_all(*index, cur, left, children);

        // Prefetch the rows each surviving child's own extension will
        // scan (addresses are fully determined by the child's interval);
        // siblings wait in the recursion while earlier branches run, so
        // their fetches overlap that work. Measured neutral at chr21
        // scale (the OoO window already covers the close-by pops, and
        // 82% of scans are extend_one chains below, which this cannot
        // reach); kept for genome-scale indexes where a sibling's row is
        // a guaranteed DRAM miss. Pure hints: DFS order, results and
        // cap/abort decisions are untouched.
#if defined(__AVX512BW__) && defined(__BMI2__)
        {
            const SingleIndex& nidx = left ? index->fwd : index->rev;
            for (int s = 1; s < SIGMA; s++) {
                if (children[s].len <= 0) continue;
                int64_t const b = left ? children[s].lb : children[s].lb_rev;
                const char* lo_row = reinterpret_cast<const char*>(
                    nidx.packed + (b / OCC_BLOCK) * OCC_ROW_BYTES);
                const char* hi_row = reinterpret_cast<const char*>(
                    nidx.packed +
                    ((b + children[s].len) / OCC_BLOCK) * OCC_ROW_BYTES);
                _mm_prefetch(lo_row, _MM_HINT_T0);
                _mm_prefetch(lo_row + 64, _MM_HINT_T0);
                _mm_prefetch(hi_row, _MM_HINT_T0);
                _mm_prefetch(hi_row + 64, _MM_HINT_T0);
            }
        }
#endif

        if (children[pattern_symbol].len > 0)
            step(children[pattern_symbol], part_idx, next_pos, errors, 0);
        if (aborted) return;

        {
            for (int s = 1; s < SIGMA; s++) {
                if (s == pattern_symbol) continue;
                if (children[s].len > 0)
                    step(children[s], part_idx, next_pos, errors + 1, 0);
                if (aborted) return;
            }
            if (last_op != 2) {
                for (int s = 1; s < SIGMA; s++) {
                    if (children[s].len > 0)
                        step(children[s], part_idx, char_pos, errors + 1, 1);
                    if (aborted) return;
                }
            }
            if (last_op != 1) {
                step(cur, part_idx, next_pos, errors + 1, 2);
            }
        }
    }

    void process_part(const Cursor& cur, int64_t part_idx, int64_t errors,
                      int last_op) {
        if (part_idx == num_parts) {
            report(cur, errors);
            return;
        }
        const PartSpec& part = parts[part_idx];
        int64_t const first = part.direction > 0 ? part.start : part.end - 1;
        step(cur, part_idx, first, errors, last_op);
    }
};

// ---------------------------------------------------------------------------
// Fiber-interleaved DFS: the measured hot loop is memory-stall-bound on
// serially-dependent occ scans — 82% of row scans at chr21 bench scale sit
// in extend_one chains (one scan decides the next scan's address), so
// within ONE seed there is nothing to overlap. Seeds are fully independent,
// though: each worker thread therefore runs F seeds' DFSs as explicit-stack
// fibers, round-robin one "quantum" (= one scan site) at a time, and
// prefetches a frame's occ rows when it is PUSHED — by the time the
// scheduler rotates back (F-1 other quanta later) the lines are in cache.
//
// Parity: a fiber is a faithful transliteration of SearchState::step with
// the recursion replaced by a LIFO stack (children pushed in reverse
// processing order), so per-seed DFS order, dedup, caps and abort points
// are bit-identical to search_one — asserted by the Python-oracle parity
// tests, which run both engines on the same seeds.
// ---------------------------------------------------------------------------

struct Frame {
    Cursor cur;
    int32_t part_idx;
    int32_t char_pos;
    int32_t errors;
    int32_t last_op;  // 0 = match/sub, 1 = insertion, 2 = deletion
};

// Re-read per batch call (one getenv per native call, not per quantum) so
// in-process tests and the long-running server can change the fiber count
// between batches.
inline int fiber_count_from_env() {
    const char* raw = std::getenv("FLOXER_TPU_SEARCH_FIBERS");
    if (raw == nullptr) return 16;  // measured best on this VM (see BENCH)
    int v = std::atoi(raw);
    if (v < 1) v = 1;
    if (v > 64) v = 64;
    return v;
}

struct Fiber {
    SearchState st;
    std::vector<Frame> stack;
    const int64_t* parts_flat = nullptr;
    int64_t num_parts = 0;
    int64_t num_searches = 0;
    int64_t search_idx = 0;
    int64_t seed = -1;  // batch seed index this fiber is running

    void reset_for_seed(const BiIndex& index, const uint8_t* pattern,
                        const int64_t* parts, int64_t searches,
                        int64_t parts_per_search, int64_t max_total,
                        int64_t max_groups, int64_t* out_groups,
                        int64_t seed_index) {
        st.index = &index;
        st.pattern = pattern;
        st.num_parts = parts_per_search;
        st.max_total = max_total;
        st.max_groups = max_groups;
        st.out_groups = out_groups;
        st.num_groups = 0;
        st.total = 0;
        st.aborted = false;
        st.overflow = false;
        st.seen.clear();
        stack.clear();
        parts_flat = parts;
        num_parts = parts_per_search;
        num_searches = searches;
        search_idx = 0;
        seed = seed_index;
    }

    // prefetch the occ rows the frame's first scan will touch (both
    // 64-byte halves of both rows); skipped when the frame starts on a
    // finished part (its continuation is scan-free until deeper)
    inline void prefetch_frame(const Frame& fr) const {
#if defined(__AVX512BW__) && defined(__BMI2__)
        const PartSpec& part = st.parts[fr.part_idx];
        bool const done = part.direction > 0 ? fr.char_pos >= part.end
                                             : fr.char_pos < part.start;
        if (done) return;
        bool const left = part.direction < 0;
        const SingleIndex& idx = left ? st.index->fwd : st.index->rev;
        int64_t const base = left ? fr.cur.lb : fr.cur.lb_rev;
        const char* lo_row = reinterpret_cast<const char*>(
            idx.packed + (base / OCC_BLOCK) * OCC_ROW_BYTES);
        const char* hi_row = reinterpret_cast<const char*>(
            idx.packed +
            ((base + fr.cur.len) / OCC_BLOCK) * OCC_ROW_BYTES);
        _mm_prefetch(lo_row, _MM_HINT_T0);
        _mm_prefetch(lo_row + 64, _MM_HINT_T0);
        _mm_prefetch(hi_row, _MM_HINT_T0);
        _mm_prefetch(hi_row + 64, _MM_HINT_T0);
#else
        (void)fr;
#endif
    }

    inline void push(const Frame& fr) {
        prefetch_frame(fr);
        stack.push_back(fr);
    }

    // start the next scheme search, or return false when the seed is done
    bool start_next_search() {
        if (st.aborted || search_idx >= num_searches) return false;
        st.parts = reinterpret_cast<const PartSpec*>(
            parts_flat + search_idx * num_parts * 5);
        search_idx++;
        // process_part(root, 0, 0, 0) up to its first step()
        Frame fr;
        fr.cur = Cursor{0, 0, st.index->n};
        fr.part_idx = 0;
        if (num_parts == 0) {
            // mirror process_part's part_idx == num_parts branch: a
            // zero-part scheme reports the root cursor instead of
            // dereferencing parts[0]
            st.report(fr.cur, 0);
            return !st.aborted && search_idx < num_searches
                       ? start_next_search()
                       : false;
        }
        const PartSpec& part = st.parts[0];
        fr.char_pos =
            (int32_t)(part.direction > 0 ? part.start : part.end - 1);
        fr.errors = 0;
        fr.last_op = 0;
        push(fr);
        return true;
    }

    // one quantum: pop a frame, run it to its scan site (or its report),
    // push its children. Mirrors SearchState::step exactly.
    void quantum() {
        Frame fr = stack.back();
        stack.pop_back();
        if (st.aborted) {
            stack.clear();
            return;
        }
        // scan-free done-part transitions (step's done branch +
        // process_part, iterated)
        for (;;) {
            if (g_count_stats)
                g_dfs_steps.fetch_add(1, std::memory_order_relaxed);
            const PartSpec& part = st.parts[fr.part_idx];
            bool const done = part.direction > 0 ? fr.char_pos >= part.end
                                                 : fr.char_pos < part.start;
            if (!done) break;
            if (fr.errors < part.lower) return;
            fr.part_idx++;
            if (fr.part_idx == st.num_parts) {
                st.report(fr.cur, fr.errors);
                return;
            }
            const PartSpec& next = st.parts[fr.part_idx];
            fr.char_pos = (int32_t)(next.direction > 0 ? next.start
                                                       : next.end - 1);
        }

        const PartSpec& part = st.parts[fr.part_idx];
        int const pattern_symbol = st.pattern[fr.char_pos];
        bool const left = part.direction < 0;
        int32_t const next_pos = (int32_t)(fr.char_pos + part.direction);

        if (fr.errors >= part.upper) {
            Cursor const child =
                extend_one(*st.index, fr.cur, left, (uint8_t)pattern_symbol);
            if (child.len > 0)
                push(Frame{child, fr.part_idx, next_pos, fr.errors, 0});
            return;
        }

        Cursor children[SIGMA];
        extend_all(*st.index, fr.cur, left, children);

        // push in reverse of the recursive processing order (LIFO):
        // deletion, insertions 5..1, substitutions 5..1, match — pops
        // then run match, subs 1..5, ins 1..5, deletion, like step()
        if (fr.last_op != 1)
            push(Frame{fr.cur, fr.part_idx, next_pos,
                       (int32_t)(fr.errors + 1), 2});
        if (fr.last_op != 2) {
            for (int s = SIGMA - 1; s >= 1; s--)
                if (children[s].len > 0)
                    push(Frame{children[s], fr.part_idx, fr.char_pos,
                               (int32_t)(fr.errors + 1), 1});
        }
        for (int s = SIGMA - 1; s >= 1; s--)
            if (s != pattern_symbol && children[s].len > 0)
                push(Frame{children[s], fr.part_idx, next_pos,
                           (int32_t)(fr.errors + 1), 0});
        if (children[pattern_symbol].len > 0)
            push(Frame{children[pattern_symbol], fr.part_idx, next_pos,
                       fr.errors, 0});
    }

    int status() const {
        return (st.aborted ? 1 : 0) | (st.overflow ? 2 : 0);
    }
};

// Run seeds [begin, end) through F interleaved fibers on this thread.
// pattern_of(i) yields seed i's pattern; groups_of(fiber, i) the output
// buffer seed i should write groups into (the fiber slot lets the select
// path hand each fiber its own reusable scratch buffer); finalize(i,
// state, status) runs when seed i's DFS completes (in fiber completion
// order — callers' outputs are indexed by seed, so order doesn't matter).
template <typename PatternOf, typename GroupsOf, typename Finalize>
void run_fiber_range(const BiIndex& index, PatternOf&& pattern_of,
                     GroupsOf&& groups_of, Finalize&& finalize,
                     const int64_t* parts_flat, int64_t num_searches,
                     int64_t num_parts, int64_t max_total,
                     int64_t max_groups, int64_t begin, int64_t end,
                     int num_fibers) {
    if (begin >= end) return;
    int const F =
        (int)std::min<int64_t>(std::max(num_fibers, 1), end - begin);
    std::vector<Fiber> fibers(F);
    for (auto& f : fibers) f.stack.reserve(256);
    int64_t next_seed = begin;
    int active = 0;
    for (int i = 0; i < F; i++) {
        fibers[i].reset_for_seed(index, pattern_of(next_seed), parts_flat,
                                 num_searches, num_parts, max_total,
                                 max_groups, groups_of(i, next_seed),
                                 next_seed);
        fibers[i].start_next_search();
        next_seed++;
        active++;
    }
    while (active > 0) {
        for (int i = 0; i < F; i++) {
            Fiber& f = fibers[i];
            if (f.seed < 0) continue;
            if (!f.stack.empty()) {
                f.quantum();
                continue;
            }
            if (f.start_next_search()) continue;
            // seed complete
            finalize(f.seed, f.st, f.status());
            if (next_seed < end) {
                f.reset_for_seed(index, pattern_of(next_seed), parts_flat,
                                 num_searches, num_parts, max_total,
                                 max_groups, groups_of(i, next_seed),
                                 next_seed);
                f.start_next_search();
                next_seed++;
            } else {
                f.seed = -1;
                active--;
            }
        }
    }
}

}  // namespace

namespace {

int search_one(const BiIndex& index, const uint8_t* pattern,
               const int64_t* parts_flat, int64_t num_searches,
               int64_t num_parts, int64_t max_total, int64_t max_groups,
               int64_t* out_groups, int64_t* out_meta) {
    SearchState state;
    state.index = &index;
    state.pattern = pattern;
    state.num_parts = num_parts;
    state.max_total = max_total;
    state.max_groups = max_groups;
    state.out_groups = out_groups;

    Cursor const root{0, 0, index.n};
    for (int64_t s = 0; s < num_searches && !state.aborted; s++) {
        state.parts =
            reinterpret_cast<const PartSpec*>(parts_flat + s * num_parts * 5);
        state.process_part(root, 0, 0, 0);
    }
    out_meta[0] = state.num_groups;
    out_meta[1] = state.total;
    return (state.aborted ? 1 : 0) | (state.overflow ? 2 : 0);
}

}  // namespace

namespace {

struct LocateCtx {
    const int64_t* sampled_rows;
    const int64_t* sampled_values;
    int64_t num_sampled;
    const int64_t* seq_starts;
    int64_t num_seqs;
};

// FmIndex.text_position LF walk (index/fmindex.py): walk LF until a
// sampled row (<= sampling_rate - 1 steps)
inline int64_t locate_walk(const SingleIndex& fwd, const int64_t* C,
                           int64_t n, const LocateCtx& loc, int64_t row) {
    int64_t steps = 0;
    for (;;) {
        const int64_t* it = std::lower_bound(
            loc.sampled_rows, loc.sampled_rows + loc.num_sampled, row);
        if (it != loc.sampled_rows + loc.num_sampled && *it == row) {
            int64_t const pos = loc.sampled_values[it - loc.sampled_rows] + steps;
            return pos >= n ? pos - n : pos;
        }
        int const symbol = symbol_at(fwd, row);
        row = C[symbol] + occ_one(fwd, row, symbol);
        steps++;
    }
}

struct SelParams {
    int64_t hard_cap, soft_cap;
    int64_t group_order;  // 0 count_first, 1 errors_first, 2 none
    int64_t choice;       // 0 round_robin, 1 full_groups, 2 first_reported
    int64_t erase_useless;
};

// Anchor selection for one seed: exact port of
// search_host.choose_anchor_rows + finalize_anchors (themselves the
// behavioral port of the reference's search.cpp:190-318). Writes up to
// soft_cap anchors (reference_id, position, errors) in final iteration
// order — reference ascending, per-reference sorted+filtered order when
// erase_useless, emission order otherwise — and the AnchorsOfSeed counts.
inline void select_one(const BiIndex& index, const LocateCtx& loc,
                       const SelParams& sel, const int64_t* groups,
                       int64_t num_groups, int64_t total, int status,
                       int64_t* out_anchors, int64_t* out_counts) {
    out_counts[0] = status;
    out_counts[1] = 0;  // anchors written
    out_counts[2] = 0;  // num_kept_raw
    out_counts[3] = 0;  // num_kept_useful
    out_counts[4] = total;
    if (status & 2) return;  // overflow: Python redoes this seed
    if (total > sel.hard_cap && sel.choice != 2) {
        out_counts[0] |= 4;  // seed fully excluded (search.cpp:190-202)
        return;
    }

    // std::sort with the reference's LITERAL comparators
    // (search.cpp:204-229): the reference uses std::ranges::sort, which in
    // libstdc++ is the same introsort, so tie placement — and for the
    // degenerate errors_first predicate, the whole permutation — matches
    // the reference bit-exactly given the same input order. Sorting the
    // index array is isomorphic to sorting the group values: introsort
    // only inspects elements through the comparator.
    std::vector<int32_t> order(num_groups);
    for (int64_t g = 0; g < num_groups; g++) order[g] = (int32_t)g;
    if (sel.group_order == 0) {  // count_first: (count, then errors)
        std::sort(order.begin(), order.end(),
                  [&](int32_t a, int32_t b) {
                      const int64_t* ga = groups + a * 4;
                      const int64_t* gb = groups + b * 4;
                      if (ga[2] != gb[2]) return ga[2] < gb[2];
                      return ga[3] < gb[3];
                  });
    } else if (sel.group_order == 1) {  // errors_first (verbatim degenerate
        // predicate, search.cpp:215-223: counts compared only when the
        // error counts differ; never otherwise)
        std::sort(order.begin(), order.end(),
                  [&](int32_t a, int32_t b) {
                      const int64_t* ga = groups + a * 4;
                      const int64_t* gb = groups + b * 4;
                      if (ga[3] != gb[3]) return ga[2] < gb[2];
                      return false;
                  });
    }

    struct A {
        int64_t ref, pos, err;
        bool marked;
    };
    std::vector<A> anchors;
    anchors.reserve(std::min<int64_t>(sel.soft_cap, 64));
    auto emit = [&](const int64_t* g, int64_t row_offset) {
        int64_t const pos = locate_walk(index.fwd, index.C, index.n, loc,
                                        g[0] + row_offset);
        const int64_t* it = std::upper_bound(
            loc.seq_starts, loc.seq_starts + loc.num_seqs, pos);
        int64_t const ref = (it - loc.seq_starts) - 1;
        anchors.push_back({ref, pos - loc.seq_starts[ref], g[3], false});
    };

    int64_t kept = 0;
    if (sel.choice == 0) {  // round_robin rotation (search.cpp:239-272)
        std::vector<int32_t> remaining = order;
        int64_t round_no = 0;
        size_t idx = 0;
        while (!remaining.empty() && kept != sel.soft_cap) {
            const int64_t* g = groups + remaining[idx] * 4;
            emit(g, round_no);
            kept++;
            if (g[2] == round_no + 1)
                remaining.erase(remaining.begin() + idx);
            else
                idx++;
            if (idx >= remaining.size()) {
                idx = 0;
                round_no++;
            }
        }
    } else {  // full_groups / first_reported (search.cpp:273-299)
        for (int32_t gi : order) {
            if (kept == sel.soft_cap) break;
            const int64_t* g = groups + gi * 4;
            for (int64_t row = 0; row < g[2]; row++) {
                emit(g, row);
                kept++;
                if (kept == sel.soft_cap) break;
            }
        }
    }

    // group by reference preserving emission order within a reference
    std::stable_sort(anchors.begin(), anchors.end(),
                     [](const A& a, const A& b) { return a.ref < b.ref; });

    int64_t kept_useful = kept;
    if (sel.erase_useless) {
        kept_useful = 0;
        size_t seg = 0;
        std::vector<A> filtered;
        filtered.reserve(anchors.size());
        while (seg < anchors.size()) {
            size_t seg_end = seg;
            while (seg_end < anchors.size() &&
                   anchors[seg_end].ref == anchors[seg].ref)
                seg_end++;
            // stable sort by position (ties keep emission order), then the
            // dominance sweep (search.cpp:352-389)
            std::stable_sort(anchors.begin() + seg, anchors.begin() + seg_end,
                             [](const A& a, const A& b) {
                                 return a.pos < b.pos;
                             });
            auto better = [](const A& a, const A& b) {
                int64_t const d =
                    a.pos > b.pos ? a.pos - b.pos : b.pos - a.pos;
                return a.err <= b.err && d <= b.err - a.err;
            };
            int64_t const cnt = (int64_t)(seg_end - seg);
            A* arr = anchors.data() + seg;
            int64_t current = 0;
            while (current < cnt - 1) {
                int64_t other = current + 1;
                while (other < cnt && better(arr[current], arr[other])) {
                    arr[other].marked = true;
                    other++;
                }
                if (other < cnt && better(arr[other], arr[current]))
                    arr[current].marked = true;
                current = other;
            }
            for (int64_t i = 0; i < cnt; i++)
                if (!arr[i].marked) {
                    filtered.push_back(arr[i]);
                    kept_useful++;
                }
            seg = seg_end;
        }
        anchors.swap(filtered);
    }

    for (size_t i = 0; i < anchors.size(); i++) {
        out_anchors[i * 3] = anchors[i].ref;
        out_anchors[i * 3 + 1] = anchors[i].pos;
        out_anchors[i * 3 + 2] = anchors[i].err;
    }
    out_counts[1] = (int64_t)anchors.size();
    out_counts[2] = kept;
    out_counts[3] = kept_useful;
}

}  // namespace

extern "C" {

// Test probe: the exact std::sort permutation for a (count, errors) list
// under the reference's literal comparators (order_code 0 = count_first,
// 1 = errors_first). Fuzzes the Python introsort replica
// (utils/introsort.py) against the real libstdc++ implementation.
void floxer_sort_groups_probe(const int64_t* counts, const int64_t* errors,
                              int64_t n, int64_t order_code,
                              int32_t* out_perm) {
    std::vector<int32_t> order((size_t)n);
    for (int64_t i = 0; i < n; i++) order[(size_t)i] = (int32_t)i;
    if (order_code == 0) {
        std::sort(order.begin(), order.end(),
                  [&](int32_t a, int32_t b) {
                      if (counts[a] != counts[b]) return counts[a] < counts[b];
                      return errors[a] < errors[b];
                  });
    } else if (order_code == 1) {
        std::sort(order.begin(), order.end(),
                  [&](int32_t a, int32_t b) {
                      if (errors[a] != errors[b]) return counts[a] < counts[b];
                      return false;
                  });
    }
    for (int64_t i = 0; i < n; i++) out_perm[i] = order[(size_t)i];
}

// Returns: bit 0 = aborted (cap hit), bit 1 = group-buffer overflow.
int floxer_search_seed(
    const uint8_t* packed_fwd, const uint8_t* packed_rev,
    const int64_t* C, int64_t n,
    const uint8_t* pattern, const int64_t* parts_flat, int64_t num_searches,
    int64_t num_parts, int64_t max_total, int64_t max_groups,
    int64_t* out_groups, int64_t* out_meta /* [2]: num_groups, total */) {
    BiIndex const index{{packed_fwd}, {packed_rev}, C, n};
    return search_one(index, pattern, parts_flat, num_searches, num_parts,
                      max_total, max_groups, out_groups, out_meta);
}

// Batched variant: num_seeds patterns of uniform length, one scheme, split
// across num_threads host workers. out_groups is
// [num_seeds][max_groups_per_seed][4]; out_meta is [num_seeds][3] with
// (num_groups, total, status).
int floxer_search_seeds_batch(
    const uint8_t* packed_fwd, const uint8_t* packed_rev,
    const int64_t* C, int64_t n,
    const uint8_t* patterns, int64_t pattern_len, int64_t num_seeds,
    const int64_t* parts_flat, int64_t num_searches, int64_t num_parts,
    int64_t max_total, int64_t max_groups_per_seed, int64_t* out_groups,
    int64_t* out_meta, int64_t num_threads) {
    BiIndex const index{{packed_fwd}, {packed_rev}, C, n};

    auto worker = [&](int64_t begin, int64_t end) {
        int const fibers = fiber_count_from_env();
        if (fibers > 1) {
            run_fiber_range(
                index,
                [&](int64_t i) { return patterns + i * pattern_len; },
                [&](int fiber, int64_t i) {
                    (void)fiber;
                    return out_groups + i * max_groups_per_seed * 4;
                },
                [&](int64_t i, SearchState& st, int status) {
                    out_meta[i * 3] = st.num_groups;
                    out_meta[i * 3 + 1] = st.total;
                    out_meta[i * 3 + 2] = status;
                },
                parts_flat, num_searches, num_parts, max_total,
                max_groups_per_seed, begin, end, fibers);
            return;
        }
        for (int64_t i = begin; i < end; i++) {
            int const status = search_one(
                index, patterns + i * pattern_len, parts_flat, num_searches,
                num_parts, max_total, max_groups_per_seed,
                out_groups + i * max_groups_per_seed * 4, out_meta + i * 3);
            out_meta[i * 3 + 2] = status;
        }
    };

    if (num_threads <= 1 || num_seeds < 2) {
        worker(0, num_seeds);
        return 0;
    }

    int64_t const threads = std::min<int64_t>(num_threads, num_seeds);
    std::vector<std::thread> pool;
    pool.reserve(threads);
    int64_t const chunk = (num_seeds + threads - 1) / threads;
    for (int64_t t = 0; t < threads; t++) {
        int64_t const begin = t * chunk;
        int64_t const end = std::min(begin + chunk, num_seeds);
        if (begin >= end) break;
        pool.emplace_back(worker, begin, end);
    }
    for (auto& th : pool) th.join();
    return 0;
}

// Combined DFS + anchor selection, one call per uniform-length seed class:
// the whole per-seed pipeline of the reference's search.cpp:143-324 (scheme
// search, hard cap, group ordering, choice strategy, locate, dominance
// sweep) runs in the worker threads with zero Python between the stages.
// out_anchors: [num_seeds][soft_cap][3] (reference_id, position, errors) in
// final iteration order. out_counts: [num_seeds][5] (status, num_written,
// num_kept_raw, num_kept_useful, total_raw); status bit 0 = aborted,
// bit 1 = overflow (caller falls back for that seed), bit 2 = hard-cap
// excluded.
static int run_select_batch(
    const BiIndex& index, const LocateCtx& loc, const SelParams& sel,
    const uint8_t* pattern_base, const int64_t* pattern_offsets,
    int64_t pattern_stride, int64_t num_seeds, const int64_t* parts_flat,
    int64_t num_searches, int64_t num_parts, int64_t max_total,
    int64_t max_groups_per_seed, int64_t soft_cap, int64_t* out_anchors,
    int64_t* out_counts, int64_t num_threads) {
    auto pattern_of = [&](int64_t i) {
        return pattern_offsets != nullptr ? pattern_base + pattern_offsets[i]
                                          : pattern_base + i * pattern_stride;
    };
    auto worker = [&](int64_t begin, int64_t end) {
        std::chrono::steady_clock::time_point w0;
        if (g_count_stats) w0 = std::chrono::steady_clock::now();
        struct WorkerTimer {
            std::chrono::steady_clock::time_point t0;
            bool on;
            ~WorkerTimer() {
                if (on)
                    g_worker_ns.fetch_add(
                        std::chrono::duration_cast<std::chrono::nanoseconds>(
                            std::chrono::steady_clock::now() - t0)
                            .count(),
                        std::memory_order_relaxed);
            }
        } timer{w0, g_count_stats};
        int const fibers = fiber_count_from_env();
        if (fibers > 1) {
            // one scratch group buffer per fiber slot (a fiber finalizes
            // its seed before reusing the slot for the next one)
            std::vector<std::vector<int64_t>> scratch(
                (size_t)std::min<int64_t>(fibers, std::max<int64_t>(
                                                      end - begin, 1)));
            for (auto& buf : scratch)
                buf.resize((size_t)max_groups_per_seed * 4);
            run_fiber_range(
                index, pattern_of,
                [&](int fiber, int64_t i) {
                    (void)i;
                    return scratch[(size_t)fiber].data();
                },
                [&](int64_t i, SearchState& st, int status) {
                    std::chrono::steady_clock::time_point t0;
                    if (g_count_stats) t0 = std::chrono::steady_clock::now();
                    select_one(index, loc, sel, st.out_groups,
                               st.num_groups, st.total, status,
                               out_anchors + i * soft_cap * 3,
                               out_counts + i * 5);
                    if (g_count_stats)
                        g_select_ns.fetch_add(
                            std::chrono::duration_cast<
                                std::chrono::nanoseconds>(
                                std::chrono::steady_clock::now() - t0)
                                .count(),
                            std::memory_order_relaxed);
                },
                parts_flat, num_searches, num_parts, max_total,
                max_groups_per_seed, begin, end, fibers);
            return;
        }
        std::vector<int64_t> groups(max_groups_per_seed * 4);
        int64_t meta[2];
        for (int64_t i = begin; i < end; i++) {
            int const status = search_one(
                index, pattern_of(i), parts_flat, num_searches,
                num_parts, max_total, max_groups_per_seed, groups.data(),
                meta);
            select_one(index, loc, sel, groups.data(), meta[0], meta[1],
                       status, out_anchors + i * soft_cap * 3,
                       out_counts + i * 5);
        }
    };

    if (num_threads <= 1 || num_seeds < 2) {
        worker(0, num_seeds);
        return 0;
    }
    int64_t const threads = std::min<int64_t>(num_threads, num_seeds);
    std::vector<std::thread> pool;
    pool.reserve(threads);
    int64_t const chunk = (num_seeds + threads - 1) / threads;
    for (int64_t t = 0; t < threads; t++) {
        int64_t const begin = t * chunk;
        int64_t const end = std::min(begin + chunk, num_seeds);
        if (begin >= end) break;
        pool.emplace_back(worker, begin, end);
    }
    for (auto& th : pool) th.join();
    return 0;
}

int floxer_search_select_batch(
    const uint8_t* packed_fwd, const uint8_t* packed_rev,
    const int64_t* C, int64_t n,
    const int64_t* sampled_rows, const int64_t* sampled_values,
    int64_t num_sampled, const int64_t* seq_starts, int64_t num_seqs,
    const uint8_t* patterns, int64_t pattern_len, int64_t num_seeds,
    const int64_t* parts_flat, int64_t num_searches, int64_t num_parts,
    int64_t max_total, int64_t max_groups_per_seed, int64_t hard_cap,
    int64_t soft_cap, int64_t group_order, int64_t choice,
    int64_t erase_useless, int64_t* out_anchors, int64_t* out_counts,
    int64_t num_threads) {
    BiIndex const index{{packed_fwd}, {packed_rev}, C, n};
    LocateCtx const loc{sampled_rows, sampled_values, num_sampled,
                        seq_starts, num_seqs};
    SelParams const sel{hard_cap, soft_cap, group_order, choice,
                        erase_useless};
    return run_select_batch(index, loc, sel, patterns, nullptr, pattern_len,
                            num_seeds, parts_flat, num_searches, num_parts,
                            max_total, max_groups_per_seed, soft_cap,
                            out_anchors, out_counts, num_threads);
}

// Offsets variant: patterns are slices of one shared buffer (the chunk's
// concatenated query sequences) at per-seed byte offsets — the chunk-level
// search batches every query's seeds of one (length, errors) class into a
// single call with no per-pattern copies on the Python side.
int floxer_search_select_batch_offsets(
    const uint8_t* packed_fwd, const uint8_t* packed_rev,
    const int64_t* C, int64_t n,
    const int64_t* sampled_rows, const int64_t* sampled_values,
    int64_t num_sampled, const int64_t* seq_starts, int64_t num_seqs,
    const uint8_t* pattern_buffer, const int64_t* pattern_offsets,
    int64_t num_seeds,
    const int64_t* parts_flat, int64_t num_searches, int64_t num_parts,
    int64_t max_total, int64_t max_groups_per_seed, int64_t hard_cap,
    int64_t soft_cap, int64_t group_order, int64_t choice,
    int64_t erase_useless, int64_t* out_anchors, int64_t* out_counts,
    int64_t num_threads) {
    BiIndex const index{{packed_fwd}, {packed_rev}, C, n};
    LocateCtx const loc{sampled_rows, sampled_values, num_sampled,
                        seq_starts, num_seqs};
    SelParams const sel{hard_cap, soft_cap, group_order, choice,
                        erase_useless};
    return run_select_batch(index, loc, sel, pattern_buffer, pattern_offsets,
                            0, num_seeds, parts_flat, num_searches, num_parts,
                            max_total, max_groups_per_seed, soft_cap,
                            out_anchors, out_counts, num_threads);
}

// Anchor selection only, from externally discovered groups: the device
// frontier search (search_device.py) finds each seed's anchor groups as
// (lb, lb_rev, len, errors) rows; this entry runs the same select_one
// (hard cap, group ordering, choice strategy, locate, dominance sweep —
// the reference's search.cpp:190-318) over those rows, so the chunk-level
// device search keeps zero Python between group discovery and anchors.
// groups_flat: [group_starts[num_seeds]][4] rows, seed-major; totals:
// per-seed raw anchor totals; statuses: per-seed DFS-status bits to pass
// through (0 for device-found seeds). rev index is not needed (locate
// only walks the fwd direction).
int floxer_select_from_groups_batch(
    const uint8_t* packed_fwd, const int64_t* C,
    int64_t n, const int64_t* sampled_rows, const int64_t* sampled_values,
    int64_t num_sampled, const int64_t* seq_starts, int64_t num_seqs,
    const int64_t* groups_flat, const int64_t* group_starts,
    const int64_t* totals, const int64_t* statuses, int64_t num_seeds,
    int64_t hard_cap, int64_t soft_cap, int64_t group_order, int64_t choice,
    int64_t erase_useless, int64_t* out_anchors, int64_t* out_counts,
    int64_t num_threads) {
    BiIndex const index{{packed_fwd}, {packed_fwd}, C, n};
    LocateCtx const loc{sampled_rows, sampled_values, num_sampled,
                        seq_starts, num_seqs};
    SelParams const sel{hard_cap, soft_cap, group_order, choice,
                        erase_useless};
    auto worker = [&](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; i++) {
            int64_t const g0 = group_starts[i];
            int64_t const num_groups = group_starts[i + 1] - g0;
            select_one(index, loc, sel, groups_flat + g0 * 4, num_groups,
                       totals[i], (int)statuses[i],
                       out_anchors + i * soft_cap * 3, out_counts + i * 5);
        }
    };
    if (num_threads <= 1 || num_seeds < 2) {
        worker(0, num_seeds);
        return 0;
    }
    int64_t const threads = std::min<int64_t>(num_threads, num_seeds);
    std::vector<std::thread> pool;
    pool.reserve(threads);
    int64_t const chunk = (num_seeds + threads - 1) / threads;
    for (int64_t t = 0; t < threads; t++) {
        int64_t const begin = t * chunk;
        int64_t const end = std::min(begin + chunk, num_seeds);
        if (begin >= end) break;
        pool.emplace_back(worker, begin, end);
    }
    for (auto& th : pool) th.join();
    return 0;
}

// Batched SA lookup (parity: the Python FmIndex.text_position LF walk,
// index/fmindex.py): each row walks LF until it hits a sampled row
// (<= sampling_rate - 1 steps). Rows come from anchor selection, whose
// choice loops never need positions — so a whole seed's picks resolve in
// one call instead of per-row Python occ queries.
int floxer_locate_batch(
    const uint8_t* packed_fwd, const int64_t* C,
    int64_t n, const int64_t* sampled_rows, const int64_t* sampled_values,
    int64_t num_sampled, const int64_t* rows, int64_t num_rows,
    int64_t* out_positions, int64_t num_threads) {
    auto worker = [&](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; i++) {
            int64_t row = rows[i];
            int64_t steps = 0;
            for (;;) {
                const int64_t* it = std::lower_bound(
                    sampled_rows, sampled_rows + num_sampled, row);
                if (it != sampled_rows + num_sampled && *it == row) {
                    int64_t const pos = sampled_values[it - sampled_rows] + steps;
                    out_positions[i] = pos >= n ? pos - n : pos;
                    break;
                }
                SingleIndex const fwd_view{packed_fwd};
                int const symbol = symbol_at(fwd_view, row);
                row = C[symbol] + occ_one(fwd_view, row, symbol);
                steps++;
            }
        }
    };

    if (num_threads <= 1 || num_rows < 256) {
        worker(0, num_rows);
        return 0;
    }
    int64_t const threads = std::min<int64_t>(num_threads, num_rows);
    std::vector<std::thread> pool;
    pool.reserve(threads);
    int64_t const chunk = (num_rows + threads - 1) / threads;
    for (int64_t t = 0; t < threads; t++) {
        int64_t const begin = t * chunk;
        int64_t const end = std::min(begin + chunk, num_rows);
        if (begin >= end) break;
        pool.emplace_back(worker, begin, end);
    }
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
