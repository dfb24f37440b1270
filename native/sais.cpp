// SA-IS: linear-time suffix-array construction by induced sorting
// (Nong, Zhang & Chan 2009), implemented from scratch for the host
// side of the FM-index build.
//
// Why native: the device prefix-doubling SA (ops/bwt_device.py) is
// the right device story for the BWT *golden* (log2(n) lax.sort rounds),
// but as the build path of a search index it is ~2 orders of
// magnitude off a linear-time host construction at chromosome scale
// (round-3 verdict item 5). Suffix sorting is pointer-heavy,
// data-dependent work — exactly what this repo keeps in native/
// (cf. suffixtree.cpp). The reference computes its BWT via suffix-
// tree DFS (/root/reference/src/suffixtree/tree.rs:740-803); this is
// the same product (SA -> BWT) at index-build speed.
//
// Contract (sais_u8): suffix array of the raw byte string `text`
// (length n, arbitrary bytes). Internally the text is widened to
// int32 codes text[i]+1 with a unique 0 sentinel appended, so no
// byte value is special and the result matches a plain lexicographic
// sort of the suffixes of `text` (a proper-prefix suffix sorts
// first). This equals ops/bwt_device.suffix_array(text_without_$)
// when the caller passes text+'$' and '$' is absent from the text —
// cross-checked bit-for-bit in tests/test_fmindex.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline bool is_lms(const std::vector<bool> &t, int64_t i) {
    return i > 0 && t[i] && !t[i - 1];
}

void get_counts(const int32_t *s, int64_t n, int64_t K,
                std::vector<int64_t> &cnt) {
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t i = 0; i < n; i++) cnt[s[i]]++;
}

void get_buckets(const std::vector<int64_t> &cnt, int64_t K,
                 std::vector<int64_t> &bkt, bool end) {
    int64_t sum = 0;
    for (int64_t c = 0; c < K; c++) {
        sum += cnt[c];
        bkt[c] = end ? sum : sum - cnt[c];
    }
}

// Induce L-type then S-type suffixes from the placed LMS seeds.
void induce(const int32_t *s, int32_t *sa, int64_t n, int64_t K,
            const std::vector<bool> &t, const std::vector<int64_t> &cnt,
            std::vector<int64_t> &bkt) {
    get_buckets(cnt, K, bkt, false);
    for (int64_t i = 0; i < n; i++) {
        int64_t j = sa[i];
        if (j > 0 && !t[j - 1]) sa[bkt[s[j - 1]]++] = (int32_t)(j - 1);
    }
    get_buckets(cnt, K, bkt, true);
    for (int64_t i = n - 1; i >= 0; i--) {
        int64_t j = sa[i];
        if (j > 0 && t[j - 1]) sa[--bkt[s[j - 1]]] = (int32_t)(j - 1);
    }
}

// Core recursion. Requires s[n-1] to be a unique smallest sentinel
// (value 0); sa has room for n entries; K = alphabet size.
void sa_is(const int32_t *s, int32_t *sa, int64_t n, int64_t K) {
    if (n == 1) {
        sa[0] = 0;
        return;
    }
    std::vector<bool> t(n);
    t[n - 1] = true;
    for (int64_t i = n - 2; i >= 0; i--)
        t[i] = s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1]);

    std::vector<int64_t> cnt(K), bkt(K);
    get_counts(s, n, K, cnt);

    // Stage 1: place LMS suffixes at their bucket ends (text order),
    // induce a full (approximate) order.
    get_buckets(cnt, K, bkt, true);
    std::fill(sa, sa + n, -1);
    for (int64_t i = 1; i < n; i++)
        if (is_lms(t, i)) sa[--bkt[s[i]]] = (int32_t)i;
    induce(s, sa, n, K, t, cnt, bkt);

    // Compact the now LMS-substring-sorted LMS positions.
    int64_t n1 = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t j = sa[i];
        if (j >= 0 && is_lms(t, j)) sa[n1++] = (int32_t)j;
    }

    // Name LMS substrings (equal substrings share a name).
    std::fill(sa + n1, sa + n, -1);
    int64_t name = 0, prev = -1;
    for (int64_t i = 0; i < n1; i++) {
        int64_t pos = sa[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (int64_t d = 0;; d++) {
                if (s[pos + d] != s[prev + d] ||
                    t[pos + d] != t[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 &&
                    (is_lms(t, pos + d) || is_lms(t, prev + d)))
                    break;  // both ended: equal substrings
            }
        }
        if (diff) {
            name++;
            prev = pos;
        }
        sa[n1 + pos / 2] = (int32_t)(name - 1);
    }
    int64_t j = n - 1;
    for (int64_t i = n - 1; i >= n1; i--)
        if (sa[i] >= 0) sa[j--] = sa[i];

    // Stage 2: order the LMS suffixes exactly.
    int32_t *s1 = sa + n - n1;
    if (name < n1) {
        sa_is(s1, sa, n1, name);
    } else {
        for (int64_t i = 0; i < n1; i++) sa[s1[i]] = (int32_t)i;
    }

    // Map the reduced SA back to LMS text positions.
    {
        int64_t k = 0;
        for (int64_t i = 1; i < n; i++)
            if (is_lms(t, i)) s1[k++] = (int32_t)i;
    }
    for (int64_t i = 0; i < n1; i++) sa[i] = s1[sa[i]];

    // Stage 3: seed exactly-ordered LMS at bucket ends, induce all.
    std::fill(sa + n1, sa + n, -1);
    get_buckets(cnt, K, bkt, true);
    for (int64_t i = n1 - 1; i >= 0; i--) {
        int64_t p = sa[i];
        sa[i] = -1;
        sa[--bkt[s[p]]] = (int32_t)p;
    }
    induce(s, sa, n, K, t, cnt, bkt);
}

}  // namespace

extern "C" {

// Suffix array of the raw byte string text[0..n): sa_out[k] = start
// of the k-th smallest suffix (proper-prefix suffixes sort first).
// Returns 0 on success, nonzero on bad arguments.
int sais_u8(const uint8_t *text, int64_t n, int32_t *sa_out) {
    if (n < 0 || (n > 0 && (!text || !sa_out))) return 1;
    if (n > (int64_t)INT32_MAX - 2) return 2;
    if (n == 0) return 0;
    // Widen to codes+1 with a unique 0 sentinel: no byte is special.
    std::vector<int32_t> w(n + 1);
    for (int64_t i = 0; i < n; i++) w[i] = (int32_t)text[i] + 1;
    w[n] = 0;
    std::vector<int32_t> sa(n + 1);
    sa_is(w.data(), sa.data(), n + 1, 257);
    // sa[0] is the sentinel position n; the rest is the answer.
    std::memcpy(sa_out, sa.data() + 1, sizeof(int32_t) * n);
    return 0;
}

}  // extern "C"
