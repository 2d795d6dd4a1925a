// Banded stripe DP + run-jump traceback on the GPU, called from JAX through
// the XLA FFI. The contract (inputs, packed output, cell math, tie rules,
// event words) is the one documented in pangraph_tpu/ops/stripe_dp.py, whose
// plain-lax `stripe_align_spec` is the executable specification this kernel
// is compared against bit for bit.
//
// One warp per problem up to B = 256 lanes; wider bands take a block of B/256
// warps per problem. Band lane k (query position q = i + k - ms - W of row
// i) lives in thread k / N, register slot k % N.
// Per row the recurrence needs the same lane of the previous row (diagonal),
// the next lane up (vertical: one __shfl_down for the thread boundary) and an
// exclusive prefix max over the band (horizontal gap, extend cost 0: a
// per-thread running max plus a 5-step shuffle scan). The carries H, QG and
// the uncapped diagonal-run counter stay in registers; each row's int16
// records go to device memory as 8-byte coalesced stores. After the last row
// lane 0 walks the records back from (rlen, qlen), jumping whole match runs,
// and writes the event list straight into the packed output row.
#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t MATCH = 1, REF_GAP = 2, QRY_GAP = 4, REF_EXT = 8, QRY_EXT = 16, BOUNDARY = 32;
constexpr int32_t NO_ALIGN = -(1 << 29);
constexpr int32_t SCORE_MATCH = 3, PENALTY_MISMATCH = 1, GAP_OPEN = 6;
constexpr int32_t RUN_CAP = (1 << 10) - 1;
constexpr int32_t OP_M = 1, OP_D = 2;
constexpr int META = 5;
constexpr int WARPS_PER_BLOCK = 4;

template <int N>
__device__ __forceinline__ void load_query(uint8_t (&qm)[N], const uint8_t* qp, int i, int k0, int shift, int Q) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int q = i + k0 + u - shift;
    qm[u] = (q >= 1 && q <= Q) ? qp[q - 1] : 0;
  }
}

template <int N, int WARPS>
__global__ void __launch_bounds__(32 * (WARPS == 1 ? WARPS_PER_BLOCK : WARPS))
stripe_kernel(const uint8_t* __restrict__ ref, const uint8_t* __restrict__ qry,
              const int32_t* __restrict__ rlen, const int32_t* __restrict__ qlen,
              const int32_t* __restrict__ msv, const int32_t* __restrict__ Wv,
              int32_t* __restrict__ out, int16_t* __restrict__ rec,
              int m, int R_cap, int Qcap, int K) {
  constexpr int B = 32 * N * WARPS;
  const int lane = threadIdx.x & 31;
  // WARPS == 1: four problems per block, one warp each. WARPS > 1: one
  // problem per block, its band split over WARPS warps that meet in shared
  // memory three times a row (vertical neighbour, scan carry, left cell).
  const int wib = WARPS == 1 ? 0 : (int)(threadIdx.x >> 5);
  const int p = WARPS == 1 ? (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5) : (int)blockIdx.x;
  if (p >= m) return;  // whole warps (WARPS == 1) or whole blocks only
  __shared__ int32_t nbH[WARPS], nbQ[WARPS], tot[WARPS], leftG[WARPS], leftH[WARPS];
  const int R = rlen[p], Q = qlen[p], ms = msv[p], W = Wv[p];
  const int top = 2 * W;       // highest live lane
  const int shift = ms + W;    // q = i + k - shift
  const uint8_t* rp = ref + (size_t)p * R_cap;
  const uint8_t* qp = qry + (size_t)p * Qcap;
  int16_t* recp = rec + (size_t)p * R_cap * B;
  const int k0 = (wib * 32 + lane) * N;

  int32_t H[N], QGc[N], RUN[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int k = k0 + u, q = k - shift;
    H[u] = (k <= top && q >= 0 && q <= Q) ? 0 : NO_ALIGN;  // virtual row 0: free leading gap
    QGc[u] = NO_ALIGN;
    RUN[u] = 0;
  }
  if (WARPS > 1) {
    if (lane == 0) {
      nbH[wib] = H[0];
      nbQ[wib] = QGc[0];
    }
    __syncthreads();
  }

  uint8_t qm_next[N];
  int rm_next = R >= 1 ? rp[0] : 0;
  load_query<N>(qm_next, qp, 1, k0, shift, Q);

  for (int i = 1; i <= R; ++i) {
    uint8_t qm[N];
#pragma unroll
    for (int u = 0; u < N; ++u) qm[u] = qm_next[u];
    const int rm = rm_next;
    if (i < R) {  // prefetch the next row's inputs off the dependency chain
      rm_next = rp[i];
      load_query<N>(qm_next, qp, i + 1, k0, shift, Q);
    }
    const int lo = max(i - shift, 0);  // lowest query position of the row
    const int32_t gap_cost = (i == R) ? 0 : GAP_OPEN;
    // vertical neighbour of the thread's top lane: the next thread's first
    int32_t H_nb = __shfl_down_sync(FULL, H[0], 1);
    int32_t QG_nb = __shfl_down_sync(FULL, QGc[0], 1);
    if (lane == 31) {
      const bool next = WARPS > 1 && wib + 1 < WARPS;
      H_nb = next ? nbH[wib + 1] : NO_ALIGN;
      QG_nb = next ? nbQ[wib + 1] : NO_ALIGN;
    }

    int32_t Mv[N], QGv[N], NQv[N], Gv[N], Hm1[N];
    int32_t path[N];
    int32_t run_max = NO_ALIGN;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int k = k0 + u, q = i + k - shift;
      const bool inm = k <= top && q >= 0 && q <= Q;
      const int32_t Hup = (u + 1 < N) ? H[u + 1] : H_nb;
      const int32_t QGup = (u + 1 < N) ? QGc[u + 1] : QG_nb;
      const bool diag_ok = q >= 1 && inm;
      const bool up_ok = k < top && q >= 1 && inm;
      const bool interior = q >= 1 && q < Q && i < R && inm;
      const int qmu = qm[u];
      const int32_t msub = (rm == 15 || qmu == 15) ? SCORE_MATCH - 1
                         : ((rm & qmu) ? SCORE_MATCH : -PENALTY_MISMATCH);
      int32_t M = diag_ok ? H[u] + msub : NO_ALIGN;
      int32_t pth = (!diag_ok && interior) ? BOUNDARY : 0;
      const int32_t q_open = (q == Q) ? Hup : Hup - GAP_OPEN;
      const bool q_ext = QGup >= q_open && k < top - 1 && i >= 2;
      const int32_t QG = up_ok ? (q_ext ? QGup : q_open) : NO_ALIGN;
      if (up_ok && q_ext) pth |= QRY_EXT;
      if (!up_ok && interior) pth |= BOUNDARY;
      if (q == 0 && inm) M = 0;  // first column: free leading deletion
      const int32_t NQ = max(M, QG);
      const int32_t P = inm ? NQ - gap_cost : NO_ALIGN;
      Gv[u] = run_max;  // exclusive within the thread
      run_max = max(run_max, P);
      Mv[u] = M;
      QGv[u] = QG;
      NQv[u] = NQ;
      path[u] = pth;
    }
    // exclusive prefix max across the warp's threads
    int32_t scan = run_max;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, scan, d);
      if (lane >= d) scan = max(scan, y);
    }
    int32_t carry = __shfl_up_sync(FULL, scan, 1);
    if (lane == 0) carry = NO_ALIGN;
    if (WARPS > 1) {
      if (lane == 31) tot[wib] = scan;
      __syncthreads();
      for (int w = 0; w < wib; ++w) carry = max(carry, tot[w]);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int k = k0 + u, q = i + k - shift;
      const bool inm = k <= top && q >= 0 && q <= Q;
      const int32_t G = max(carry, Gv[u]);
      Gv[u] = (q - lo == 0 || !inm) ? NO_ALIGN : G;
      Hm1[u] = max(NQv[u], Gv[u]);
    }
    // the cell left of the thread's first lane: the previous thread's last
    int32_t G_left = __shfl_up_sync(FULL, Gv[N - 1], 1);
    int32_t Hm1_left = __shfl_up_sync(FULL, Hm1[N - 1], 1);
    if (WARPS > 1) {
      if (lane == 31) {
        leftG[wib] = Gv[N - 1];
        leftH[wib] = Hm1[N - 1];
      }
      __syncthreads();
    }
    if (lane == 0) {
      const bool prev = WARPS > 1 && wib > 0;
      G_left = prev ? leftG[wib - 1] : NO_ALIGN;
      Hm1_left = prev ? leftH[wib - 1] : NO_ALIGN;
    }

    int16_t recv[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int k = k0 + u, q = i + k - shift;
      const bool inm = k <= top && q >= 0 && q <= Q;
      const bool interior = q >= 1 && q < Q && i < R && inm;
      const bool first = q == 0 && inm;
      const int s = q - lo;
      const int32_t pG = u ? Gv[u - 1] : G_left;
      const int32_t pH = u ? Hm1[u - 1] : Hm1_left;
      const int32_t G = Gv[u], M = Mv[u], QG = QGv[u];
      int32_t pth = path[u];
      if (s == 0 && interior) pth |= BOUNDARY;
      if (G > NO_ALIGN && s > 1 && pG >= pH - gap_cost) pth |= REF_EXT;
      const bool rsel = G >= M;
      const int32_t best = rsel ? G : M;
      int32_t origin = rsel ? REF_GAP : MATCH;
      const bool qsel = QG >= best;
      int32_t h = qsel ? QG : best;
      if (qsel) origin = QRY_GAP;
      if (first) {
        h = 0;
        pth = QRY_EXT | QRY_GAP;
      } else {
        pth |= origin;
      }
      if (!inm) {
        h = NO_ALIGN;
        pth = 0;
      }
      const int32_t run = ((pth & MATCH) && inm) ? RUN[u] + 1 : 0;
      recv[u] = (int16_t)(pth | (min(run, RUN_CAP) << 6));
      H[u] = h;
      QGc[u] = QG;  // NO_ALIGN wherever the vertical move was invalid
      RUN[u] = run;
    }
    int16_t* row = recp + (size_t)(i - 1) * B + k0;
#pragma unroll
    for (int u = 0; u < N; u += 4)
      *reinterpret_cast<short4*>(row + u) = make_short4(recv[u], recv[u + 1], recv[u + 2], recv[u + 3]);
    if (WARPS > 1) {
      // the next row reads this row's first lane of every warp; the barrier
      // also keeps tot/left from being overwritten while still read
      if (lane == 0) {
        nbH[wib] = H[0];
        nbQ[wib] = QGc[0];
      }
      __syncthreads();
    }
  }

  int32_t* o = out + (size_t)p * (META + 2 * K);
  for (int x = wib * 32 + lane; x < META + 2 * K; x += 32 * WARPS) o[x] = 0;
  // orders the record stores and the zeroing before the walk
  if (WARPS > 1) __syncthreads();
  else __syncwarp();
  if (lane != 0 || wib != 0) return;

  int32_t* ev_rows = o + META;
  int32_t* ev_words = o + META + K;
  int i = R, q = Q, st = 0, ins = 0, dl = 0, ia = 0, cnt = 0, dead = 0, bnd = 0;
  while (i > 0) {
    const int k = q - i + shift;
    int word = 0;
    if (k >= 0 && k <= top && q >= 0) word = ((int)recp[(size_t)(i - 1) * B + k]) & 0xFFFF;
    const int bits = word & 63, runv = word >> 6;
    if (bits & BOUNDARY) bnd = 1;
    const bool take_m = st == 0 && (bits & MATCH);
    const bool take_i = (st == 0 && (bits & REF_GAP) && !take_m) || st == REF_GAP;
    const bool take_d = (st == 0 && (bits & QRY_GAP) && !take_m && !take_i) || st == QRY_GAP;
    if (bits == 0 || !(take_m || take_i || take_d)) {
      dead = 1;
      break;
    }
    // a non-D move ends a pending deletion run (emitted at its lowest row,
    // the current i); an M move with a trailing insertion run emits its own
    // event. The two never coincide: dl > 0 implies ins == 0.
    const bool emit_d = (take_m || take_i) && dl > 0;
    const bool emit_m = take_m && ins > 0 && dl == 0;
    if (emit_d || emit_m) {
      const int slot = min(cnt, K - 1);
      ev_rows[slot] = emit_d ? i : i - 1;
      ev_words[slot] = emit_d ? (OP_D | (ia << 2) | (dl << 17)) : (OP_M | (ins << 2));
      ++cnt;
    }
    if (take_d && dl == 0) ia = ins;
    else if (emit_d) ia = 0;
    if (take_d) ++dl;
    else if (emit_d) dl = 0;
    const int new_st = take_i ? ((bits & REF_EXT) ? REF_GAP : 0)
                     : (take_d ? ((bits & QRY_EXT) ? QRY_GAP : 0) : st);
    if (take_m) {
      // jump the whole diagonal run; the jumped cells share lane k and carry
      // BOUNDARY exactly when k is a band edge and they are interior
      const int L = min(max(runv, 1), i);
      if (L >= 2 && (k == 0 || k == top) && q >= 2) bnd = 1;
      i -= L;
      q -= L;
      ins = 0;
    } else if (take_d) {
      i -= 1;
      ins = 0;
    } else {
      q -= 1;
      ++ins;
    }
    st = new_st;
  }
  if (i == 0 && !dead && dl > 0) {  // a deletion run reaching row 0
    const int slot = min(cnt, K - 1);
    ev_rows[slot] = 0;
    ev_words[slot] = OP_D | (ia << 2) | (dl << 17);
    ++cnt;
  }
  o[0] = q;
  o[1] = dead | (i > 0 ? 1 : 0);
  o[2] = bnd;
  o[3] = ins;
  o[4] = cnt;
}

template <int N, int WARPS>
void launch(cudaStream_t stream, const uint8_t* ref, const uint8_t* qry, const int32_t* rlen,
            const int32_t* qlen, const int32_t* ms, const int32_t* W, int32_t* out, int16_t* rec,
            int m, int R_cap, int Qcap, int K) {
  const int threads = 32 * (WARPS == 1 ? WARPS_PER_BLOCK : WARPS);
  const int blocks = WARPS == 1 ? (m + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK : m;
  stripe_kernel<N, WARPS><<<blocks, threads, 0, stream>>>(ref, qry, rlen, qlen, ms, W, out, rec, m, R_cap, Qcap, K);
}

ffi::Error StripeAlignImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> ref, ffi::Buffer<ffi::U8> qry,
                           ffi::Buffer<ffi::S32> rlen, ffi::Buffer<ffi::S32> qlen,
                           ffi::Buffer<ffi::S32> ms, ffi::Buffer<ffi::S32> W,
                           ffi::ResultBuffer<ffi::S32> out, ffi::ResultBuffer<ffi::S16> rec) {
  const auto rd = ref.dimensions();
  const auto od = out->dimensions();
  const auto recd = rec->dimensions();
  if (rd.size() != 2 || od.size() != 2 || recd.size() != 3)
    return ffi::Error::InvalidArgument("stripe_align: unexpected ranks");
  const int m = (int)rd[0], R_cap = (int)rd[1];
  const int Qcap = (int)qry.dimensions()[1];
  const int B = (int)recd[2];
  const int K = ((int)od[1] - META) / 2;
  if (m == 0) return ffi::Error::Success();
  const uint8_t* r = ref.typed_data();
  const uint8_t* q = qry.typed_data();
  const int32_t *rl = rlen.typed_data(), *ql = qlen.typed_data(), *msp = ms.typed_data(), *Wp = W.typed_data();
  int32_t* o = out->typed_data();
  int16_t* rc = rec->typed_data();
  switch (B) {
    case 128: launch<4, 1>(stream, r, q, rl, ql, msp, Wp, o, rc, m, R_cap, Qcap, K); break;
    case 256: launch<8, 1>(stream, r, q, rl, ql, msp, Wp, o, rc, m, R_cap, Qcap, K); break;
    case 512: launch<8, 2>(stream, r, q, rl, ql, msp, Wp, o, rc, m, R_cap, Qcap, K); break;
    case 1024: launch<8, 4>(stream, r, q, rl, ql, msp, Wp, o, rc, m, R_cap, Qcap, K); break;
    case 2048: launch<8, 8>(stream, r, q, rl, ql, msp, Wp, o, rc, m, R_cap, Qcap, K); break;
    default: return ffi::Error::InvalidArgument("stripe_align: record width must be 128..2048, a power of two");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PangraphStripeAlign, StripeAlignImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S16>>());
