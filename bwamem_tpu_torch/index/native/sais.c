/* SA-IS suffix array construction (induced sorting), original
 * implementation of the published algorithm (Nong, Zhang & Chan, "Two
 * Efficient Algorithms for Linear Time Suffix Array Construction", 2011).
 * Role-equivalent to the reference's is.c (upstream bwa uses SA-IS for
 * `bwa index`); written from the paper's algorithm, not from that file.
 *
 * Exported entry: sais_u8(s, SA, n, K) where s[0..n-1] is a byte string
 * whose LAST symbol is a unique 0 sentinel (smallest).  SA receives the
 * n suffix positions in lexicographic order (SA[0] == n-1, the sentinel).
 * 64-bit indices throughout: genomes beyond 2^31 symbols are in scope.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int64_t si;

/* The same core works on uint8_t (top level) and si (recursion levels);
 * generate both with a macro. */
#define DEFINE_SAIS(SUF, CHAR)                                               \
                                                                             \
static void get_counts_##SUF(const CHAR *s, si *cnt, si n, si K)             \
{                                                                            \
    si i;                                                                    \
    memset(cnt, 0, (size_t)K * sizeof(si));                                  \
    for (i = 0; i < n; i++) cnt[s[i]]++;                                     \
}                                                                            \
                                                                             \
static void get_buckets_##SUF(const si *cnt, si *bkt, si K, int tail)        \
{                                                                            \
    si i, sum = 0;                                                           \
    for (i = 0; i < K; i++) { sum += cnt[i]; bkt[i] = tail ? sum : sum - cnt[i]; } \
}                                                                            \
                                                                             \
static void induce_##SUF(const CHAR *s, si *SA, const si *cnt, si *bkt,      \
                         si n, si K, const uint8_t *t)                       \
{                                                                            \
    si i, j;                                                                 \
    /* induce L-type from bucket heads, scanning left to right */            \
    get_buckets_##SUF(cnt, bkt, K, 0);                                       \
    for (i = 0; i < n; i++) {                                                \
        j = SA[i];                                                           \
        if (j > 0 && !t[j - 1]) SA[bkt[s[j - 1]]++] = j - 1;                 \
    }                                                                        \
    /* induce S-type from bucket tails, scanning right to left */            \
    get_buckets_##SUF(cnt, bkt, K, 1);                                       \
    for (i = n - 1; i >= 0; i--) {                                           \
        j = SA[i];                                                           \
        if (j > 0 && t[j - 1]) SA[--bkt[s[j - 1]]] = j - 1;                  \
    }                                                                        \
}                                                                            \
                                                                             \
static int sais_##SUF(const CHAR *s, si *SA, si n, si K)                     \
{                                                                            \
    si i, j, d, n1, name, prev, pos, *s1, *cnt, *bkt;                        \
    uint8_t *t;                                                              \
    if (n == 1) { SA[0] = 0; return 0; }                                     \
    t = (uint8_t *)malloc((size_t)n);                                        \
    cnt = (si *)malloc((size_t)K * sizeof(si));                              \
    bkt = (si *)malloc((size_t)K * sizeof(si));                              \
    if (!t || !cnt || !bkt) { free(t); free(cnt); free(bkt); return -1; }    \
    /* classify: 1 = S-type, 0 = L-type; sentinel is S */                    \
    t[n - 1] = 1;                                                            \
    t[n - 2] = 0;                                                            \
    for (i = n - 3; i >= 0; i--)                                             \
        t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;  \
    get_counts_##SUF(s, cnt, n, K);                                          \
                                                                             \
    /* stage 1: sort the LMS substrings by induction */                      \
    for (i = 0; i < n; i++) SA[i] = -1;                                      \
    get_buckets_##SUF(cnt, bkt, K, 1);                                       \
    for (i = n - 1; i >= 1; i--)                                             \
        if (t[i] && !t[i - 1]) SA[--bkt[s[i]]] = i;                          \
    induce_##SUF(s, SA, cnt, bkt, n, K, t);                                  \
                                                                             \
    /* compact the (now LMS-substring-sorted) LMS suffixes */                \
    n1 = 0;                                                                  \
    for (i = 0; i < n; i++) {                                                \
        j = SA[i];                                                           \
        if (j > 0 && t[j] && !t[j - 1]) SA[n1++] = j;                        \
    }                                                                        \
    /* name LMS substrings into the upper half of SA */                      \
    for (i = n1; i < n; i++) SA[i] = -1;                                     \
    name = 0; prev = -1;                                                     \
    for (i = 0; i < n1; i++) {                                               \
        int diff = 0;                                                        \
        pos = SA[i];                                                         \
        if (prev < 0) diff = 1;                                              \
        else {                                                               \
            for (d = 0; d < n; d++) {                                        \
                if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {\
                    diff = 1; break;                                         \
                }                                                            \
                if (d > 0 &&                                                 \
                    ((t[pos + d] && !t[pos + d - 1]) ||                      \
                     (t[prev + d] && !t[prev + d - 1])))                     \
                    break;  /* both reached the next LMS boundary */         \
            }                                                                \
        }                                                                    \
        if (diff) { name++; prev = pos; }                                    \
        SA[n1 + pos / 2] = name - 1;                                         \
    }                                                                        \
    for (i = n - 1, j = n - 1; i >= n1; i--)                                 \
        if (SA[i] >= 0) SA[j--] = SA[i];                                     \
                                                                             \
    /* stage 2: order the LMS suffixes via the reduced problem */            \
    s1 = SA + n - n1;                                                        \
    if (name < n1) {                                                         \
        if (sais_si(s1, SA, n1, name) < 0) {                                 \
            free(t); free(cnt); free(bkt); return -1;                        \
        }                                                                    \
    } else                                                                   \
        for (i = 0; i < n1; i++) SA[s1[i]] = i;                              \
    /* s1's job is done: overwrite it with the LMS positions in text order */\
    for (i = 1, j = 0; i < n; i++)                                           \
        if (t[i] && !t[i - 1]) s1[j++] = i;                                  \
    for (i = 0; i < n1; i++) SA[i] = s1[SA[i]];                              \
                                                                             \
    /* stage 3: induce the full order from the sorted LMS suffixes */        \
    for (i = n1; i < n; i++) SA[i] = -1;                                     \
    get_buckets_##SUF(cnt, bkt, K, 1);                                       \
    for (i = n1 - 1; i >= 0; i--) {                                          \
        j = SA[i]; SA[i] = -1;                                               \
        SA[--bkt[s[j]]] = j;                                                 \
    }                                                                        \
    induce_##SUF(s, SA, cnt, bkt, n, K, t);                                  \
    free(t); free(cnt); free(bkt);                                           \
    return 0;                                                                \
}

static int sais_si(const si *s, si *SA, si n, si K);
DEFINE_SAIS(si, si)
DEFINE_SAIS(u8, uint8_t)

int sais_u8_entry(const uint8_t *s, si *SA, si n, si K)
{
    if (n < 0 || K < 1) return -1;
    if (n == 0) return 0;
    return sais_u8(s, SA, n, K);
}
