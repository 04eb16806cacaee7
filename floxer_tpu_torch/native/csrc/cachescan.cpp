// Verified-interval cache scan over walk arrays.
//
// Native mirror of floxer_tpu.intervals.VerifiedIntervals +
// verify_batch._simulate_key / _scan's cache decisions (themselves the
// behavioral port of the reference's verified_intervals usage,
// src/lib/verification.cpp:119-136 and src/lib/intervals.cpp:84-127):
// per (query, orientation, reference) segment, walks are visited in anchor
// order; a walk whose trimmed root interval is contained in a single
// stored interval is "avoided"; otherwise its (untrimmed) root interval is
// inserted according to the walk's state. Runs the 91k-walk-per-chunk
// simulation in one call instead of a Python loop per walk.
//
// states: 0 = uncomputed (optimistic: report as needed + insert)
//         1 = pending-ok (cheap checks passed: insert, not re-reported)
//         2 = computed, all pre-root levels exist (insert)
//         3 = computed, broken before the root (no insert)
// out_flags: 0 = avoided (cache hit), 1 = needed, 2 = passed through,
//            4 = avoided but AT RISK: every covering interval came from a
//                not-yet-computed walk (state 0/1), so this walk becomes
//                needed if those break — the wave loop may speculatively
//                compute flag-4 walks to collapse re-verify cascades
//
// Build: compiled into libfloxer_native.so (Makefile NATIVE_SRCS).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Cache {
    std::vector<int64_t> starts;  // sorted
    std::vector<int64_t> ends;    // parallel
    std::vector<uint8_t> conf;    // parallel: 1 = confirmed (computed walk)
    std::vector<int64_t> pmax;       // prefix max of ends (all intervals)
    std::vector<int64_t> pmax_conf;  // prefix max of confirmed ends only
    bool dirty = false;

    void refresh() {
        if (!dirty && pmax.size() == starts.size()) return;
        pmax.resize(starts.size());
        pmax_conf.resize(starts.size());
        int64_t running = INT64_MIN;
        int64_t running_conf = INT64_MIN;
        for (size_t i = 0; i < starts.size(); i++) {
            running = ends[i] > running ? ends[i] : running;
            if (conf[i] && ends[i] > running_conf) running_conf = ends[i];
            pmax[i] = running;
            pmax_conf[i] = running_conf;
        }
        dirty = false;
    }

    // 0 = not covered, 1 = covered only by optimistic intervals,
    // 2 = covered by a confirmed interval
    int cover(int64_t lo, int64_t hi) {
        if (starts.empty()) return 0;
        refresh();
        auto it = std::upper_bound(starts.begin(), starts.end(), lo);
        if (it == starts.begin()) return 0;
        size_t const at = static_cast<size_t>(it - starts.begin()) - 1;
        if (pmax_conf[at] >= hi) return 2;
        return pmax[at] >= hi ? 1 : 0;
    }

    void insert(int64_t lo, int64_t hi, bool confirmed) {
        int const covered = cover(lo, hi);
        if (covered == 2 || (covered == 1 && !confirmed)) return;
        auto const pos =
            std::upper_bound(starts.begin(), starts.end(), lo) -
            starts.begin();
        starts.insert(starts.begin() + pos, lo);
        ends.insert(ends.begin() + pos, hi);
        conf.insert(conf.begin() + pos, confirmed ? 1 : 0);
        dirty = true;
    }
};

}  // namespace

extern "C" {

// Returns the number of "needed" walks (flag 1), or -1 on bad input.
int64_t floxer_cache_scan(
    const int64_t* seg_begin, const int64_t* seg_end, int64_t num_segs,
    const int64_t* sorted_ids,
    const int64_t* trim_lo, const int64_t* trim_hi,
    const int64_t* ins_lo, const int64_t* ins_hi,
    const uint8_t* state, int64_t enabled, uint8_t* out_flags) {
    int64_t need = 0;
    for (int64_t s = 0; s < num_segs; s++) {
        Cache cache;
        for (int64_t k = seg_begin[s]; k < seg_end[s]; k++) {
            int64_t const w = sorted_ids[k];
            if (enabled) {
                int const covered = cache.cover(trim_lo[w], trim_hi[w]);
                if (covered == 2) {
                    out_flags[w] = 0;
                    continue;
                }
                if (covered == 1) {
                    // covered, but only by walks that may still break
                    out_flags[w] = state[w] == 0 ? 4 : 0;
                    continue;
                }
            }
            uint8_t const st = state[w];
            if (st == 0) {
                out_flags[w] = 1;
                need++;
                if (enabled) cache.insert(ins_lo[w], ins_hi[w], false);
            } else if (st == 1) {
                out_flags[w] = 2;
                if (enabled) cache.insert(ins_lo[w], ins_hi[w], false);
            } else if (st == 2) {
                out_flags[w] = 2;
                if (enabled) cache.insert(ins_lo[w], ins_hi[w], true);
            } else if (st == 3) {
                out_flags[w] = 2;
            } else {
                return -1;
            }
        }
    }
    return need;
}

}  // extern "C"
