// SA-IS suffix array construction (Nong, Zhang, Chan 2009).
//
// Native replacement for the index-build hot path: the reference delegates
// suffix-array construction to fmindex-collection's C++ build
// (src/main/floxer.cpp:92-97); here it backs floxer_tpu.index.fmindex, which
// falls back to numpy prefix doubling when this library is unavailable.
//
// Memory layout is sized for whole-genome (hg38, ~3.1 Gbp) builds on a
// 125 GB host:
//   - the TOP level reads the text as uint8 (values remapped +1 with a
//     unique appended 0 sentinel, K = max symbol), instead of widening it
//     to the index type — at 3 Gbp that saves 24 GB of RAM and 8x the
//     text-read bandwidth of the int64 variant;
//   - the suffix array is built IN PLACE in the caller-provided (n+1)-entry
//     buffer (floxer_build_suffix_array_inplace), so no second 24 GB copy
//     ever exists;
//   - LMS positions are stored in the dead T1 region of SA instead of a
//     separate vector (n1 <= n/2 guarantees the regions are disjoint),
//     which removes the last O(n)-word allocation.
// Per direction the build peaks at text + (n+1) index words + n bits
// (~31 GB for hg38 with int64), so forward and reverse builds can run
// concurrently on this host (index/fmindex.py does).
//
// Index type is templated: int32 for texts under 2^31 (half the memory),
// int64 beyond.
//
// Build: g++ -O3 -march=native -shared -fPIC sais.cpp -o libsais.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename I, typename TC>
void get_buckets(const TC* T, I n, I K, std::vector<I>& bkt, bool end) {
    std::fill(bkt.begin(), bkt.end(), I(0));
    for (I i = 0; i < n; i++) bkt[T[i]]++;
    I sum = 0;
    for (I c = 0; c <= K; c++) {
        sum += bkt[c];
        bkt[c] = end ? sum : sum - bkt[c];
    }
}

template <typename I, typename TC>
void induce_l(const TC* T, I* SA, I n, I K, const std::vector<bool>& stype,
              std::vector<I>& bkt) {
    get_buckets(T, n, K, bkt, false);
    for (I i = 0; i < n; i++) {
        I j = SA[i] - 1;
        if (SA[i] > 0 && !stype[j]) SA[bkt[T[j]]++] = j;
    }
}

template <typename I, typename TC>
void induce_s(const TC* T, I* SA, I n, I K, const std::vector<bool>& stype,
              std::vector<I>& bkt) {
    get_buckets(T, n, K, bkt, true);
    for (I i = n - 1; i >= 0; i--) {
        I j = SA[i] - 1;
        if (SA[i] > 0 && stype[j]) SA[--bkt[T[j]]] = j;
    }
}

// T[n-1] must be the unique smallest character (sentinel).
template <typename I, typename TC>
void sais(const TC* T, I* SA, I n, I K) {
    std::vector<bool> stype(n);
    stype[n - 1] = true;
    for (I i = n - 2; i >= 0; i--)
        stype[i] = T[i] < T[i + 1] || (T[i] == T[i + 1] && stype[i + 1]);

    auto is_lms = [&](I i) { return i > 0 && stype[i] && !stype[i - 1]; };

    std::vector<I> bkt(K + 1);

    // stage 1: approximately sort LMS suffixes by induced sorting
    std::fill(SA, SA + n, I(-1));
    get_buckets(T, n, K, bkt, true);
    for (I i = 1; i < n; i++)
        if (is_lms(i)) SA[--bkt[T[i]]] = i;
    induce_l(T, SA, n, K, stype, bkt);
    induce_s(T, SA, n, K, stype, bkt);

    // compact the sorted LMS substrings into the front of SA
    I n1 = 0;
    for (I i = 0; i < n; i++)
        if (SA[i] > 0 && is_lms(SA[i])) SA[n1++] = SA[i];
    // the sentinel suffix (position n-1) is LMS and sorts first
    // note: is_lms(n-1) is true because T[n-1] is the unique smallest

    // name the LMS substrings in SA[n1..n)
    std::fill(SA + n1, SA + n, I(-1));
    I name = 0;
    I prev = -1;
    for (I i = 0; i < n1; i++) {
        I pos = SA[i];
        bool diff = false;
        if (prev == -1) {
            diff = true;
        } else {
            for (I d = 0;; d++) {
                if (T[pos + d] != T[prev + d] ||
                    stype[pos + d] != stype[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    // both reached the next LMS with equal content
                    diff = !(is_lms(pos + d) && is_lms(prev + d));
                    break;
                }
            }
        }
        if (diff) {
            name++;
            prev = pos;
        }
        SA[n1 + pos / 2] = name - 1;
    }
    for (I i = n - 1, j = n - 1; i >= n1; i--)
        if (SA[i] >= 0) SA[j--] = SA[i];

    // stage 2: sort the reduced problem
    I* SA1 = SA;
    I* T1 = SA + n - n1;
    if (name < n1) {
        sais<I, I>(T1, SA1, n1, name - 1);
    } else {
        for (I i = 0; i < n1; i++) SA1[T1[i]] = i;
    }

    // stage 3: induce the full SA from the sorted LMS suffixes. The LMS
    // position table lives in the (now dead) T1 region: n1 <= n/2, so
    // SA[0..n1) and SA[n-n1..n) never overlap.
    I* lms_positions = SA + n - n1;
    {
        I j = 0;
        for (I i = 1; i < n; i++)
            if (is_lms(i)) lms_positions[j++] = i;
    }
    for (I i = 0; i < n1; i++) SA1[i] = lms_positions[SA1[i]];

    // lms_positions are fully consumed above; the whole tail resets
    std::fill(SA + n1, SA + n, I(-1));
    get_buckets(T, n, K, bkt, true);
    for (I i = n1 - 1; i >= 0; i--) {
        I j = SA[i];
        SA[i] = -1;
        SA[--bkt[T[j]]] = j;
    }
    induce_l(T, SA, n, K, stype, bkt);
    induce_s(T, SA, n, K, stype, bkt);
}

// Top-level driver reading uint8 text. sa_buf must have n+1 entries; the
// suffix array of the original text lands in sa_buf[1..n] (entry 0 is the
// appended sentinel's suffix).
template <typename I>
int build_u8(const uint8_t* text, int64_t n, I* sa_buf) {
    // remap to 1..max+1 with appended 0 sentinel
    std::vector<uint8_t> T8(n + 1);
    uint8_t maxc = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = uint8_t(text[i] + 1);
        T8[i] = c;
        if (c > maxc) maxc = c;
    }
    T8[n] = 0;
    sais<I, uint8_t>(T8.data(), sa_buf, I(n + 1), I(maxc));
    return 0;
}

}  // namespace

extern "C" {

// In-place variant: sa_buf has n+1 int64 entries; on return sa_buf[1..n]
// is the suffix array (sa_buf[0] == n, the sentinel suffix). The caller
// uses the [1..n] view directly — no copy of the 8n-byte array is made.
int floxer_build_suffix_array_inplace(const uint8_t* text, int64_t n,
                                      int64_t* sa_buf) {
    if (n <= 0) return 0;
    if (n + 1 < (int64_t(1) << 31)) {
        // int32 build into a temporary (texts this size are small), then
        // widen into the caller's buffer
        std::vector<int32_t> SA(n + 1);
        build_u8<int32_t>(text, n, SA.data());
        for (int64_t i = 0; i <= n; i++) sa_buf[i] = SA[i];
        return 0;
    }
    return build_u8<int64_t>(text, n, sa_buf);
}

int floxer_build_suffix_array(const uint8_t* text, int64_t n, int64_t* sa_out) {
    if (n <= 0) return 0;
    std::vector<int64_t> buf(n + 1);
    int rc = floxer_build_suffix_array_inplace(text, n, buf.data());
    if (rc != 0) return rc;
    std::memcpy(sa_out, buf.data() + 1, size_t(n) * sizeof(int64_t));
    return 0;
}

}  // extern "C"
