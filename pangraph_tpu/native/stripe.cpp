// Native host stripe aligner: banded affine-gap DP + traceback, batched
// over jobs with std::thread.
//
// Semantics are an exact port of the vectorized host aligner in
// align/stripe.py (itself mirroring the reference re-aligner,
// align/nextclade/align/score_matrix.rs + backtrace.rs + band_2d.rs:36-54):
// same stripe geometry, tie order (match < ref-gap <=, qry-gap <=),
// left-aligned gap extension flags, free terminal gaps, IUPAC match masks,
// and per-cell BOUNDARY bits driving band-doubling retries.
//
// Why it exists: a small merge round's whole DP is often < 100 Mcells, which
// the host finishes before a device round would have launched and copied.
// The batch aligner routes such rounds (and jobs whose band outgrew the
// device kernel's widest record row or whose corners leave the band) here and
// keeps the device kernel (ops/cuda/stripe.cu) for the big batches.
//
// Execution model: every
// stripe-edge condition — diagonal/vertical predecessor in the previous
// stripe, positional gap-extension window, first matrix column, terminal
// free-gap column, boundary bits — is a RANGE condition on the in-row
// index, so a row is processed as 16-lane AVX-512 blocks under k-masks with
// no scalar edge cells. The horizontal-gap recurrence is an inclusive
// prefix max (Hillis-Steele within a block + lane-15 carry across blocks).
// One fused pass per row; the only cross-lane state is three carry vectors.
#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>
#include <algorithm>
// STRIPE_FORCE_SCALAR (-DSTRIPE_FORCE_SCALAR) selects the scalar row loop on
// AVX-512 hosts so parity tests can exercise BOTH implementations of the
// recurrence (they are independent code paths selected at compile time).
#if defined(__AVX512F__) && defined(__AVX512BW__) && !defined(STRIPE_FORCE_SCALAR)
#include <immintrin.h>
#define STRIPE_AVX512 1
#endif

namespace {

constexpr int8_t MATCH = 1;
constexpr int8_t REF_GAP = 2;
constexpr int8_t QRY_GAP = 4;
constexpr int8_t REF_EXT = 8;
constexpr int8_t QRY_EXT = 16;
constexpr int8_t BOUND = 32;
constexpr int32_t NOAL = -(1 << 29);

struct Params {
    int32_t match, mismatch, open, ext, la;
    int left_free, right_free;
};

inline int64_t clampi(int64_t x, int64_t lo, int64_t hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// Stripe bounds (band_2d.rs:36-54 / stripe.py simple_stripes)
inline int64_t stripe_b(int64_t i, int64_t ms, int64_t W, int64_t Q) {
    return i == 0 ? 0 : clampi(i - ms - W, 0, Q);
}
inline int64_t stripe_e(int64_t i, int64_t R, int64_t ms, int64_t W, int64_t Q) {
    return i == R ? Q + 1 : clampi(i - ms + W + 1, 1, Q + 1);
}

struct Scratch {
    std::vector<int8_t> paths;
    std::vector<int32_t> H_prev, qry_gaps;
    std::vector<uint8_t> qmask;     // 1 front pad + Q + 16 end pad
    std::vector<int32_t> msub4;     // 4 x (1 front pad + Q + 16 end pad)
    std::vector<int32_t> msub_row;  // scratch for rare ambiguous ref rows
};

#ifdef STRIPE_AVX512
// inclusive prefix max over 16 int32 lanes (Hillis-Steele with NOAL fill)
static inline __m512i prefix_max_epi32(__m512i x, __m512i neutral) {
    x = _mm512_max_epi32(x, _mm512_alignr_epi32(x, neutral, 15));  // << 1 lane
    x = _mm512_max_epi32(x, _mm512_alignr_epi32(x, neutral, 14));  // << 2
    x = _mm512_max_epi32(x, _mm512_alignr_epi32(x, neutral, 12));  // << 4
    x = _mm512_max_epi32(x, _mm512_alignr_epi32(x, neutral, 8));   // << 8
    return x;
}

// mask of lanes with (k0 + lane) >= t, for 64-bit threshold t
static inline __mmask16 lanes_ge(__m512i kvec, int64_t t) {
    if (t <= INT32_MIN) return (__mmask16)0xFFFF;
    if (t > INT32_MAX) return (__mmask16)0;
    return _mm512_cmp_epi32_mask(kvec, _mm512_set1_epi32((int32_t)t), _MM_CMPINT_NLT);
}
static inline __mmask16 lanes_lt(__m512i kvec, int64_t t) {
    return (__mmask16)~lanes_ge(kvec, t);
}
#endif

// Per-job DP state, split out of the former monolithic align_one so setup /
// row / traceback are separately callable. (A row-lockstep mode that
// interleaved two jobs' rows per thread was measured here and REMOVED: the
// two jobs' scratch evicting each other from L1/L2 cost more than the
// dependency-chain overlap won — nopair was 0-30% faster at every
// production shape on this host.)
struct JobState {
    const uint8_t* ref;
    const uint8_t* qry;
    const uint8_t* mask;
    int64_t R, Q, ms, W, stride;
    int8_t* paths;
    int32_t* H_prev;
    int32_t* qry_gaps;
    uint8_t* qmask;
    Scratch* S;
    const Params* P;
    int64_t prev_b, prev_e, pprev_e;
};

// Set up scratch + row 0 for one job. Returns 0 ok, 3 paths over budget.
int job_init(
    JobState& J,
    const uint8_t* ref, int64_t R,
    const uint8_t* qry, int64_t Q,
    int64_t ms, int64_t W,
    const Params& P, const uint8_t* mask,
    int64_t max_paths_bytes, Scratch& S)
{
    // stride = widest stripe. All interior rows have width 2W+2 clipped to
    // sequence edges; only rows 0 and R can be wider (forced begin/end).
    int64_t stride = std::min<int64_t>(2 * W + 2, Q + 1);
    stride = std::max(stride, stripe_e(0, R, ms, W, Q) - stripe_b(0, ms, W, Q));
    stride = std::max(stride, stripe_e(R, R, ms, W, Q) - stripe_b(R, ms, W, Q));
    if ((R + 1) * stride > max_paths_bytes) return 3;
    S.paths.resize((size_t)((R + 1) * stride + 16));
    int8_t* paths = S.paths.data();

    S.H_prev.assign((size_t)(Q + 17), NOAL);
    S.qry_gaps.assign((size_t)(Q + 17), NOAL);
    int32_t* H_prev = S.H_prev.data();

    // per-job query-side IUPAC masks, padded 1 front + 16 end
    S.qmask.assign((size_t)(Q + 17), 0);
    uint8_t* qmask = S.qmask.data() + 1;
    for (int64_t j = 0; j < Q; j++) qmask[j] = mask[qry[j]];

    // substitution-score rows per ref base class (A/C/G/T): contiguous loads
    // in the row loop instead of a per-cell table gather. Ambiguous ref
    // bases (IUPAC codes, 'N') are rare and use per-row scratch.
    const int64_t QS = Q + 17;  // padded class-row stride (1 front + 16 end)
    S.msub4.resize((size_t)(4 * QS));
    for (int c = 0; c < 4; c++) {
        int32_t* __restrict row = S.msub4.data() + (size_t)(c * QS) + 1;
        const uint8_t bit = (uint8_t)(1 << c);
        for (int64_t j = 0; j < Q; j++) {
            const uint8_t m = qmask[j];
            row[j] = (m == 0xF) ? P.match - 1 : ((m & bit) ? P.match : -P.mismatch);
        }
    }
    S.msub_row.resize((size_t)(stride + 32));

    // row 0 (score_matrix.rs:61-80)
    const int64_t e0 = stripe_e(0, R, ms, W, Q);
    paths[0] = 0;
    for (int64_t k = 1; k < e0; k++) paths[k] = REF_GAP | REF_EXT;
    for (int64_t k = 0; k < e0; k++)
        H_prev[k] = (P.left_free || k == 0) ? 0 : -P.open - P.ext * (int32_t)(k - 1);

    J.ref = ref; J.qry = qry; J.mask = mask;
    J.R = R; J.Q = Q; J.ms = ms; J.W = W; J.stride = stride;
    J.paths = paths;
    J.H_prev = H_prev;
    J.qry_gaps = S.qry_gaps.data();
    J.qmask = qmask;
    J.S = &S;
    J.P = &P;
    J.prev_b = 0;
    J.prev_e = e0;
    J.pprev_e = 0;
    return 0;
}

// One DP row (the exact row body align_one always ran; just parameterized
// on JobState so two jobs' rows can interleave on one thread).
void job_row(JobState& J, int64_t i) {
    const uint8_t* ref = J.ref;
    const uint8_t* mask = J.mask;
    const int64_t R = J.R, Q = J.Q, ms = J.ms, W = J.W, stride = J.stride;
    int8_t* paths = J.paths;
    int32_t* H_prev = J.H_prev;
    int32_t* qry_gaps = J.qry_gaps;
    uint8_t* qmask = J.qmask;
    Scratch& S = *J.S;
    const Params& P = *J.P;
    const int64_t QS = Q + 17;
    const int32_t ext = P.ext, open_ = P.open, la = P.la;
    const int64_t prev_b = J.prev_b, prev_e = J.prev_e, pprev_e = J.pprev_e;
    {
        const int64_t b = stripe_b(i, ms, W, Q);
        const int64_t e = stripe_e(i, R, ms, W, Q);
        const int64_t w = e - b;
        int8_t* prow = paths + i * stride;
        const uint8_t rc = ref[i - 1];
        const bool r_unknown = rc == 'N';
        const int mrc = mask[rc];
        const bool r_free_row = P.right_free && (i == R);
        const int32_t gap_cost = r_free_row ? 0 : open_;
        const bool has_fc = (b == 0);
        // first matrix column (j == 0): leading query-deletion chain; uses
        // the OLD H_prev[0], so compute before any store this row
        const int32_t h0 = !has_fc ? 0
                         : (P.left_free ? 0 : (i == 1 ? -open_ : H_prev[0] - ext));

        // substitution-score row for this ref base, indexed by k with the
        // consumed query char being qry[j-1] = qry[b-1+k]
        const int32_t* msubRow;
        if (mrc == 1 || mrc == 2 || mrc == 4 || mrc == 8) {
            const int c = mrc == 1 ? 0 : mrc == 2 ? 1 : mrc == 4 ? 2 : 3;
            msubRow = S.msub4.data() + (size_t)(c * QS) + 1 + (b - 1);
        } else {
            int32_t msub_tab[16];
            for (int m = 0; m < 16; m++)
                msub_tab[m] = (r_unknown || m == 0xF) ? P.match - 1
                            : ((mrc & m) ? P.match : -P.mismatch);
            int32_t* __restrict sr = S.msub_row.data();
            const uint8_t* __restrict qm = qmask + (b - 1);
            for (int64_t k = 0; k < w; k++) sr[k] = msub_tab[qm[k]];
            msubRow = sr;
        }

#ifdef STRIPE_AVX512
        {
            // k-space range thresholds for every stripe-edge condition
            const int64_t diag_lo = std::max(prev_b + 1, (int64_t)1) - b;  // k >= : diag in prev stripe
            const int64_t diag_hi = prev_e + 1 - b;                        // k <  :
            const int64_t ge1_lo = 1 - b;                                  // k >= : j >= 1
            const int64_t up_hi = prev_e - b;                              // k <  : j < prev_e
            const int64_t pose_hi = pprev_e - b;                           // k <  : positional gap ext
            const int64_t ltQ_hi = Q - b;                                  // k <  : j < Q
            const int64_t kQ = Q - b;                                      // k == : j == Q
            const bool iltR = i < R;

            const __m512i NEUT = _mm512_set1_epi32(NOAL);
            const __m512i gcv = _mm512_set1_epi32(gap_cost);
            const __m512i extv = _mm512_set1_epi32(ext);
            const __m512i openv = _mm512_set1_epi32(open_);
            const __m512i lav = _mm512_set1_epi32(la);
            const __m512i h0v = _mm512_set1_epi32(h0);
            const __m512i vMATCH = _mm512_set1_epi32(MATCH);
            const __m512i vREFG = _mm512_set1_epi32(REF_GAP);
            const __m512i vQRYG = _mm512_set1_epi32(QRY_GAP);
            const __m512i vREFX = _mm512_set1_epi32(REF_EXT);
            const __m512i vQRYX = _mm512_set1_epi32(QRY_EXT);
            const __m512i vBND = _mm512_set1_epi32(BOUND);
            const __m512i vFC = _mm512_set1_epi32(QRY_EXT | QRY_GAP);
            const __m512i iota = _mm512_set_epi32(15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
            const __m512i lane15 = _mm512_set1_epi32(15);

            const int32_t* __restrict Hrow = H_prev + b;
            int32_t* __restrict Hst = H_prev + b;
            int32_t* __restrict QGrow = qry_gaps + b;

            __m512i carryH = _mm512_set1_epi32(b >= 1 ? H_prev[b - 1] : NOAL);
            __m512i carryNQ = NEUT;     // lane 15 feeds NQ[t-1] of block lane 0
            __m512i carryG = NEUT;      // lane 15 feeds G[t-1] of block lane 0
            __m512i carryRun = NEUT;    // running prefix-max carry (all lanes)

            // interior fast path: a 16-lane block whose k-range satisfies
            // EVERY edge condition (diag/up/pose full, k>=2, j<Q, no first
            // column, no free-terminal lane) needs no mask computation, no
            // edge blends, and can emit no BOUND bits — that is most blocks
            // of an interior row. Conditions collapse to a per-row k-range.
            int64_t kf_lo = std::max(std::max(diag_lo, ge1_lo), (int64_t)2);
            int64_t kf_hi = std::min(std::min(diag_hi, up_hi), pose_hi);
            if (P.right_free) kf_hi = std::min(kf_hi, kQ);
            kf_hi = std::min(kf_hi, w);

            for (int64_t k0 = 0; k0 < w; k0 += 16) {
                if (k0 >= kf_lo && k0 + 16 <= kf_hi) {
                    const __m512i H_old = _mm512_loadu_si512(Hrow + k0);
                    const __m512i Hm1_old = _mm512_alignr_epi32(H_old, carryH, 15);
                    const __m512i msub = _mm512_loadu_si512(msubRow + k0);
                    const __m512i M = _mm512_add_epi32(Hm1_old, msub);

                    const __m512i qg_old = _mm512_loadu_si512(QGrow + k0);
                    const __m512i q_ext_val = _mm512_sub_epi32(qg_old, extv);
                    const __m512i q_open_val = _mm512_sub_epi32(H_old, openv);
                    const __mmask16 qea_m =
                        _mm512_cmp_epi32_mask(q_ext_val, q_open_val, _MM_CMPINT_NLT);
                    const __m512i QG = _mm512_mask_blend_epi32(qea_m, q_open_val, q_ext_val);
                    _mm512_storeu_si512(QGrow + k0, QG);
                    const __m512i NQ = _mm512_max_epi32(M, QG);

                    const __m512i NQm1 = _mm512_alignr_epi32(NQ, carryNQ, 15);
                    __m512i x = _mm512_sub_epi32(NQm1, gcv);
                    x = prefix_max_epi32(x, NEUT);
                    x = _mm512_max_epi32(x, carryRun);
                    const __m512i G = x;
                    const __m512i Gm1 = _mm512_alignr_epi32(G, carryG, 15);
                    const __m512i Hm1m1 = _mm512_max_epi32(NQm1, Gm1);
                    __mmask16 re_m = _mm512_cmp_epi32_mask(
                        _mm512_sub_epi32(Gm1, extv), _mm512_sub_epi32(Hm1m1, gcv), _MM_CMPINT_NLT);
                    re_m &= _mm512_cmpgt_epi32_mask(G, NEUT);

                    const __mmask16 rsel = _mm512_cmpgt_epi32_mask(G, _mm512_sub_epi32(M, lav));
                    const __m512i best = _mm512_mask_blend_epi32(rsel, M, G);
                    const __mmask16 qsel = _mm512_cmpgt_epi32_mask(QG, _mm512_sub_epi32(best, lav));
                    const __m512i H = _mm512_mask_blend_epi32(qsel, best, QG);
                    _mm512_storeu_si512(Hst + k0, H);

                    __m512i bits = vMATCH;
                    bits = _mm512_mask_mov_epi32(bits, rsel, vREFG);
                    bits = _mm512_mask_mov_epi32(bits, qsel, vQRYG);
                    bits = _mm512_or_si512(bits, _mm512_maskz_mov_epi32(qea_m, vQRYX));
                    bits = _mm512_or_si512(bits, _mm512_maskz_mov_epi32(re_m, vREFX));
                    _mm_storeu_si128((__m128i*)(prow + k0), _mm512_cvtepi32_epi8(bits));

                    carryH = H_old;
                    carryNQ = NQ;
                    carryG = G;
                    carryRun = _mm512_permutexvar_epi32(lane15, G);
                    continue;
                }
                const __mmask16 remm =
                    (w - k0 >= 16) ? (__mmask16)0xFFFF : (__mmask16)((1u << (w - k0)) - 1);
                const __m512i kvec = _mm512_add_epi32(iota, _mm512_set1_epi32((int32_t)k0));
                const __mmask16 diag_m = lanes_ge(kvec, diag_lo) & lanes_lt(kvec, diag_hi);
                const __mmask16 ge1_m = lanes_ge(kvec, ge1_lo);
                const __mmask16 up_m = ge1_m & lanes_lt(kvec, up_hi);
                const __mmask16 pose_m = lanes_lt(kvec, pose_hi);
                const __mmask16 ltQ_m = lanes_lt(kvec, ltQ_hi);
                const __mmask16 qfree_m =
                    P.right_free ? (lanes_ge(kvec, kQ) & lanes_lt(kvec, kQ + 1)) : (__mmask16)0;
                const __mmask16 k0_m = lanes_lt(kvec, 1);   // k == 0
                const __mmask16 k2_m = lanes_ge(kvec, 2);   // k > 1
                const __mmask16 fc_m = has_fc ? k0_m : (__mmask16)0;

                const __m512i H_old = _mm512_loadu_si512(Hrow + k0);
                const __m512i Hm1_old = _mm512_alignr_epi32(H_old, carryH, 15);
                const __m512i msub = _mm512_loadu_si512(msubRow + k0);
                __m512i M = _mm512_mask_blend_epi32(
                    diag_m, NEUT, _mm512_add_epi32(Hm1_old, msub));

                const __m512i qg_old = _mm512_loadu_si512(QGrow + k0);
                // j == Q with free right-terminal gaps: no open/extend cost
                const __m512i amt_e = _mm512_maskz_mov_epi32((__mmask16)~qfree_m, extv);
                const __m512i amt_o = _mm512_maskz_mov_epi32((__mmask16)~qfree_m, openv);
                const __m512i q_ext_val = _mm512_sub_epi32(qg_old, amt_e);
                const __m512i q_open_val = _mm512_sub_epi32(H_old, amt_o);
                const __mmask16 qea_m =
                    _mm512_cmp_epi32_mask(q_ext_val, q_open_val, _MM_CMPINT_NLT) & pose_m;
                __m512i QG = _mm512_mask_blend_epi32(
                    up_m, NEUT, _mm512_mask_blend_epi32(qea_m, q_open_val, q_ext_val));
                _mm512_mask_storeu_epi32(QGrow + k0, remm, QG);

                M = _mm512_mask_blend_epi32(fc_m, M, h0v);
                QG = _mm512_mask_blend_epi32(fc_m, QG, NEUT);
                const __m512i NQ = _mm512_max_epi32(M, QG);

                // horizontal gap: G[k] = max(G[k-1], NQ[k-1] - gap_cost),
                // G[0] = NOAL exactly (first stripe cell has no left move)
                __m512i NQm1 = _mm512_alignr_epi32(NQ, carryNQ, 15);
                __m512i x = _mm512_sub_epi32(NQm1, gcv);
                x = _mm512_mask_blend_epi32(k0_m, x, NEUT);
                x = prefix_max_epi32(x, NEUT);
                x = _mm512_max_epi32(x, carryRun);
                const __m512i G = x;
                const __m512i Gm1 = _mm512_alignr_epi32(G, carryG, 15);
                const __m512i Hm1m1 = _mm512_max_epi32(NQm1, Gm1);
                __mmask16 re_m = _mm512_cmp_epi32_mask(
                    _mm512_sub_epi32(Gm1, extv), _mm512_sub_epi32(Hm1m1, gcv), _MM_CMPINT_NLT);
                re_m &= _mm512_cmpgt_epi32_mask(G, NEUT) & k2_m;

                const __mmask16 rsel = _mm512_cmpgt_epi32_mask(G, _mm512_sub_epi32(M, lav));
                const __m512i best = _mm512_mask_blend_epi32(rsel, M, G);
                const __mmask16 qsel = _mm512_cmpgt_epi32_mask(QG, _mm512_sub_epi32(best, lav));
                __m512i H = _mm512_mask_blend_epi32(qsel, best, QG);
                H = _mm512_mask_blend_epi32(fc_m, H, h0v);
                _mm512_mask_storeu_epi32(Hst + k0, remm, H);

                __m512i bits = vMATCH;
                bits = _mm512_mask_mov_epi32(bits, rsel, vREFG);
                bits = _mm512_mask_mov_epi32(bits, qsel, vQRYG);
                bits = _mm512_or_si512(bits, _mm512_maskz_mov_epi32(up_m & qea_m, vQRYX));
                bits = _mm512_or_si512(bits, _mm512_maskz_mov_epi32(re_m, vREFX));
                if (iltR) {
                    const __mmask16 bnd_m =
                        (((__mmask16)~diag_m | (__mmask16)~up_m | k0_m) & ge1_m & ltQ_m);
                    bits = _mm512_or_si512(bits, _mm512_maskz_mov_epi32(bnd_m, vBND));
                }
                bits = _mm512_mask_blend_epi32(fc_m, bits, vFC);
                _mm_mask_storeu_epi8(prow + k0, remm, _mm512_cvtepi32_epi8(bits));

                carryH = H_old;
                carryNQ = NQ;
                carryG = G;
                carryRun = _mm512_permutexvar_epi32(lane15, G);
            }
        }
#else
        {
            int64_t carry_old = (b >= 1) ? H_prev[b - 1] : NOAL;
            int32_t G_run = NOAL, G_prev_cell = NOAL, Hm1_prev = NOAL, NQ_prev = NOAL;
            for (int64_t j = b; j < e; j++) {
                const int64_t k = j - b;
                int8_t path = 0;
                const int32_t old_Hj = H_prev[j];
                const bool diag_ok = (j - 1 >= prev_b) && (j - 1 < prev_e) && (j >= 1);
                int32_t M;
                if (diag_ok) {
                    M = (int32_t)carry_old + msubRow[k];
                } else {
                    M = NOAL;
                    if (j >= 1 && i < R && j < Q) path |= BOUND;
                }
                const bool up_ok = (j < prev_e) && (j >= 1);
                const bool q_free = P.right_free && (j == Q);
                const int32_t qg_old = qry_gaps[j];
                const int32_t q_ext_val = q_free ? qg_old : qg_old - ext;
                const int32_t q_open_val = q_free ? old_Hj : old_Hj - open_;
                const bool q_ext_allowed = (q_ext_val >= q_open_val) && (j < pprev_e);
                int32_t QG;
                if (up_ok) {
                    QG = q_ext_allowed ? q_ext_val : q_open_val;
                    if (q_ext_allowed) path |= QRY_EXT;
                } else {
                    QG = NOAL;
                    if (j >= 1 && j < Q && i < R) path |= BOUND;
                }
                qry_gaps[j] = up_ok ? QG : NOAL;
                const bool first = (j == 0);
                if (first) {
                    M = h0;
                    QG = NOAL;
                }
                const int32_t NQ = M > QG ? M : QG;
                if (k == 0) {
                    G_run = NOAL;
                    if (j >= 1 && i < R && j < Q) path |= BOUND;
                } else {
                    const int32_t cand = NQ_prev - gap_cost;
                    if (cand > G_run) G_run = cand;
                }
                const int32_t G = G_run;
                if (G > NOAL && k > 1 && (G_prev_cell - ext >= Hm1_prev - gap_cost))
                    path |= REF_EXT;
                int32_t best_mr;
                int8_t origin;
                if (G > M - la) { best_mr = G; origin = REF_GAP; }
                else { best_mr = M; origin = MATCH; }
                int32_t H;
                if (QG > best_mr - la) { H = QG; origin = QRY_GAP; }
                else { H = best_mr; }
                if (first) { H = h0; origin = QRY_GAP; path = QRY_EXT; }
                prow[k] = path | origin;
                H_prev[j] = H;
                carry_old = old_Hj;
                G_prev_cell = G;
                Hm1_prev = NQ > G ? NQ : G;
                NQ_prev = NQ;
            }
        }
#endif
        J.pprev_e = prev_e;
        J.prev_b = b;
        J.prev_e = e;
    }
}

// traceback -> RLE ops (end-to-start) + subs (backtrace.rs:17-100).
// Returns 0 ok, 1 boundary-retry (dead walk / out of band), 2 overflow.
int job_traceback(
    JobState& J,
    int32_t* ops, int64_t ops_cap, int64_t* n_ops_out,
    int64_t* subs, int64_t subs_cap, int64_t* n_subs_out,
    int64_t* lead_ins_out, int* hit_boundary_out)
{
    const uint8_t* ref = J.ref;
    const uint8_t* qry = J.qry;
    const int64_t R = J.R, Q = J.Q, ms = J.ms, W = J.W, stride = J.stride;
    const int8_t* paths = J.paths;
    int64_t i = R, q = Q;
    int state = 0;
    int64_t n_ops = 0, n_subs = 0;
    int cur_op = -1;
    int64_t cur_len = 0;
    int hb = 0;
    while (i > 0) {
        const int64_t b = stripe_b(i, ms, W, Q);
        const int64_t e = stripe_e(i, R, ms, W, Q);
        const int64_t k = q - b;
        if (k < 0 || k >= e - b) return 1;
        const int bits = paths[i * stride + k];
        if (bits == 0) return 1;
        if (bits & BOUND) hb = 1;
        int op;
        if ((bits & MATCH) && state == 0) {
            op = 0;
            i--; q--;
            if (ref[i] != qry[q]) {
                if (n_subs >= subs_cap) return 2;
                subs[n_subs * 2] = i;
                subs[n_subs * 2 + 1] = qry[q];
                n_subs++;
            }
        } else if (((bits & REF_GAP) && state == 0) || state == REF_GAP) {
            op = 1;
            q--;
            state = (bits & REF_EXT) ? REF_GAP : 0;
        } else if (((bits & QRY_GAP) && state == 0) || state == QRY_GAP) {
            op = 2;
            i--;
            state = (bits & QRY_EXT) ? QRY_GAP : 0;
        } else {
            return 1;
        }
        if (op != cur_op) {
            if (cur_len > 0) {
                if (n_ops >= ops_cap) return 2;
                ops[n_ops * 2] = cur_op;
                ops[n_ops * 2 + 1] = (int32_t)cur_len;
                n_ops++;
            }
            cur_op = op;
            cur_len = 0;
        }
        cur_len++;
    }
    if (cur_len > 0) {
        if (n_ops >= ops_cap) return 2;
        ops[n_ops * 2] = cur_op;
        ops[n_ops * 2 + 1] = (int32_t)cur_len;
        n_ops++;
    }
    *lead_ins_out = q;
    *n_ops_out = n_ops;
    *n_subs_out = n_subs;
    *hit_boundary_out = hb;
    return 0;
}

// One banded DP + traceback. Returns 0 ok, 1 boundary-retry (dead walk /
// out of band), 2 output overflow, 3 paths buffer too large.
int align_one(
    const uint8_t* ref, int64_t R,
    const uint8_t* qry, int64_t Q,
    int64_t ms, int64_t W,
    const Params& P, const uint8_t* mask,
    int64_t max_paths_bytes,
    Scratch& S,
    int32_t* ops, int64_t ops_cap, int64_t* n_ops_out,
    int64_t* subs, int64_t subs_cap, int64_t* n_subs_out,
    int64_t* lead_ins_out, int* hit_boundary_out)
{
    JobState J;
    const int rc = job_init(J, ref, R, qry, Q, ms, W, P, mask, max_paths_bytes, S);
    if (rc) return rc;
    for (int64_t i = 1; i <= R; i++) job_row(J, i);
    return job_traceback(J, ops, ops_cap, n_ops_out,
                         subs, subs_cap, n_subs_out, lead_ins_out, hit_boundary_out);
}

}  // namespace

extern "C" {

// Batched stripe alignment over n jobs, threaded. Sequences are passed as
// concatenated uint8 buffers with per-job offsets/lengths. Outputs use flat
// per-job slices of fixed caps. status[j]: 0 ok, 1 boundary-retry needed,
// 2 ops/subs overflow, 3 paths buffer over budget.
void stripe_align_batch(
    int64_t n_jobs,
    const uint8_t* refs, const int64_t* ref_off, const int64_t* ref_len,
    const uint8_t* qrys, const int64_t* qry_off, const int64_t* qry_len,
    const int64_t* ms, const int64_t* W,
    // params
    int64_t match, int64_t mismatch, int64_t open_, int64_t ext, int64_t la,
    int left_free, int right_free,
    const uint8_t* iupac_mask,       // [256]
    int64_t max_paths_bytes,         // per-job paths budget
    // outputs (flat, per-job slices)
    int32_t* ops, int64_t ops_cap, int64_t* n_ops,
    int64_t* subs, int64_t subs_cap, int64_t* n_subs,
    int64_t* lead_ins, int32_t* hit_boundary, int32_t* status,
    int32_t n_threads)
{
    const Params P{(int32_t)match, (int32_t)mismatch, (int32_t)open_,
                   (int32_t)ext, (int32_t)la, left_free, right_free};
    // Size-ordered schedule: biggest DP areas first, so a large job pulled
    // late never leaves one thread finishing alone.
    std::vector<int64_t> order((size_t)n_jobs);
    for (int64_t j = 0; j < n_jobs; j++) order[(size_t)j] = j;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        const int64_t wa = std::min<int64_t>(2 * W[a] + 2, qry_len[a] + 1);
        const int64_t wb = std::min<int64_t>(2 * W[b] + 2, qry_len[b] + 1);
        const int64_t aa = ref_len[a] * wa, ab = ref_len[b] * wb;
        if (aa != ab) return aa > ab;
        return a < b;  // deterministic total order
    });
    const int nt = (int)std::min<int64_t>(std::max(n_threads, 1), n_jobs);
    std::atomic<int64_t> next(0);
    auto run_solo = [&](int64_t j, Scratch& S) {
        int hb = 0;
        const int rc = align_one(
            refs + ref_off[j], ref_len[j],
            qrys + qry_off[j], qry_len[j],
            ms[j], W[j], P, iupac_mask, max_paths_bytes, S,
            ops + j * ops_cap * 2, ops_cap, &n_ops[j],
            subs + j * subs_cap * 2, subs_cap, &n_subs[j],
            &lead_ins[j], &hb);
        hit_boundary[j] = hb;
        status[j] = rc;
    };
    auto worker = [&]() {
        Scratch S;
        for (;;) {
            const int64_t p = next.fetch_add(1);
            if (p >= n_jobs) break;
            run_solo(order[(size_t)p], S);
        }
    };
    if (nt <= 1 || n_jobs <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        ts.reserve(nt);
        for (int t = 0; t < nt; t++) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
}

// 512 when this build runs the AVX-512 row loop, 0 for the scalar loop.
int stripe_simd_bits() {
#ifdef STRIPE_AVX512
    return 512;
#else
    return 0;
#endif
}

}  // extern "C"
