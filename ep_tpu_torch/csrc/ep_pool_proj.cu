// Kernel G (ep_pool_proj): the Efficient Probing pool with the value
// projection inside.
//   logits[q, n] = q_scaled[q] . x[n]                    (f32)
//   p = softmax_n(logits), rounded to bf16
//   v[n, j]     = bf16(sum_c x[n, c] * W[j, c])          (f32 sum)
//   out[q, c]   = sum_n p[q, n] * v[n, q*cq + c]          (f32 sum, one bf16 rounding)
// Only q_scaled, x, W and out touch device memory: neither the projected
// values (B, N, Q*cq) nor the probabilities are written.
//
// Replaces: ep_tpu/ops/pool_attn_pallas.py::_ep_fused_kernel
//   (ep_pool_proj_attend). The TPU kernel multiplies the (Q, N) probabilities
//   by the whole (N, Q*cq) projection and masks the block diagonal, Q times
//   the needed products, to fill its 128x128 unit; this kernel computes only
//   each query's own cq columns, as kernel D does. W is nn.Linear's (Q*cq, C)
//   weight, the "col" operand of the product.
//
// Bound on this card: operations. At ViT-H/14, 448 px, batch 64 (N=1024,
//   C=1280, Q*cq=1280) the projection is 2*64*1024*1280*1280 = 215 GFLOP,
//   0.217 ms at 989 TFLOP/s, against 168 MB of tokens, 0.050 ms.
// Design: one 256-thread block per (image, group of 8 queries). W (3.3 MB at
//   ViT-H) does not fit shared memory, so everything streams in 64-channel
//   slices of C on a 3-stage cp.async ring, one __syncthreads a slice:
//   pass 1 walks the image in tiles of 256 tokens with the group's 8 query
//     rows beside them and builds the (8, N) f32 logits in shared memory
//     (mma.sync m16n8k16: tokens are the rows, the 8 queries one n-tile, 32
//     tokens a warp); then a warp per query runs the f32 softmax in place and
//     rounds to bf16. Its tiles are large because the pass has almost no
//     arithmetic and lives on the bytes it keeps in flight (with 64-token
//     tiles it took over a quarter of the kernel's time);
//   pass 2 walks the image again in tiles of 64 tokens with the group's 8*cq
//     rows of W: each warp owns 32 tokens x 2*cq columns of the tile's
//     x @ W^T in f32 registers (7 ldmatrix feed 20 mma at cq=40; a 16-token
//     warp tile needed 11), rounds them to bf16 when the last slice is in,
//     weights them by p of their column's query and adds them to per-thread
//     f32 sums.
//   The sums are folded once at the end (lane shuffles, then the 2 token
//   warps through shared memory): no atomics, so the sum's order is fixed.
//   An image's tokens are read twice by each of its Q/8 blocks and the
//   group's slice of W once a token tile, both from L2 at these sizes; pass 2
//   is bound by its mma.sync loop and the ldmatrix traffic that feeds it, not
//   by those loads.
#include "common.cuh"

namespace ep {
namespace {

constexpr int QG = 8;          // queries per block
constexpr int TN1 = 256;       // tokens per tile, pass 1
constexpr int TN = 64;         // tokens per tile, pass 2
constexpr int KS = 64;         // channels per streamed slice
constexpr int LDK = KS + 8;    // shared row stride (bf16) of a slice
constexpr int STAGES = 3;
constexpr int THREADS = 256;   // 8 warps: 2 token halves x 4 column quarters
constexpr int CHK = KS / 8;    // 16-byte chunks per slice row

// The logits' row stride: N padded to pass 1's tile.
__host__ __device__ inline int proj_tokens_padded(int N) {
  return (N + TN1 - 1) / TN1 * TN1;
}

// Rows of one ring stage: the x slice with the q slice (pass 1) or the W
// slice (pass 2) beside it.
__host__ __device__ constexpr int proj_stage_rows(int cq) {
  return TN + QG * cq > TN1 + QG ? TN + QG * cq : TN1 + QG;
}

// The logits follow the ring.
__host__ __device__ inline int proj_smem_bytes(int N, int cq) {
  return STAGES * proj_stage_rows(cq) * LDK * 2 +
         QG * proj_tokens_padded(N) * 4;
}

template <int CQ>
__global__ void __launch_bounds__(THREADS)
ep_pool_proj_kernel(const bf16* __restrict__ q, const bf16* __restrict__ x,
                    const bf16* __restrict__ w, bf16* __restrict__ out, int N,
                    int C, int Q, int x_bstride) {
  constexpr int COLS = QG * CQ;      // columns of x @ W^T this block owns
  constexpr int NTW = CQ / 4;        // 8-column tiles a warp owns (2*CQ / 8)
  constexpr int STAGE = proj_stage_rows(CQ) * LDK;
  static_assert(CQ % 8 == 0, "a warp's column tiles pair up for ldmatrix.x4");
  const int Np = proj_tokens_padded(N);
  const int QC = Q * CQ;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);               // [STAGES][STAGE]
  float* S = reinterpret_cast<float*>(ring + STAGES * STAGE);  // [QG][Np]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // pass 2: token half, column quarter
  const int b = blockIdx.x;
  const int q_lo = blockIdx.y * QG;  // first query of the group
  const int c_lo = q_lo * CQ;        // first column of the group
  const bf16* xb = x + (size_t)b * x_bstride;

  const int n_slices = C / KS;
  const int items1 = Np / TN1 * n_slices;              // pass 1
  const int items2 = (N + TN - 1) / TN * n_slices;     // pass 2
  const int total = items1 + items2;

  // Item i < items1 is token tile i / n_slices of pass 1, else of pass 2,
  // and channel slice i % n_slices. Rows past N, Q or Q*cq are zero.
  auto prefetch = [&](int i) {
    if (i < total) {
      const bool pass2 = i >= items1;
      const int tile = (pass2 ? i - items1 : i) / n_slices;
      const int tokens = pass2 ? TN : TN1;
      const int n0 = tile * tokens;
      const int k0 = (i % n_slices) * KS;  // items1 is a multiple of n_slices
      bf16* xs = ring + (i % STAGES) * STAGE;
      bf16* bs = xs + tokens * LDK;
      for (int idx = tid; idx < tokens * CHK; idx += THREADS) {
        const int r = idx / CHK, c = (idx % CHK) * 8;
        if (n0 + r < N)
          cp_async16(xs + r * LDK + c, xb + (size_t)(n0 + r) * C + k0 + c);
        else
          *reinterpret_cast<uint4*>(xs + r * LDK + c) = zero_pack();
      }
      const bf16* src = pass2 ? w + (size_t)c_lo * C : q + (size_t)q_lo * C;
      const int rows = pass2 ? COLS : QG;
      const int real = pass2 ? QC - c_lo : Q - q_lo;  // rows that exist
      for (int idx = tid; idx < rows * CHK; idx += THREADS) {
        const int r = idx / CHK, c = (idx % CHK) * 8;
        if (r < real)
          cp_async16(bs + r * LDK + c, src + (size_t)r * C + k0 + c);
        else
          *reinterpret_cast<uint4*>(bs + r * LDK + c) = zero_pack();
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) prefetch(i);

  // Rows 16*mi + g and + 8 of the warp's 32 tokens: the tile's x @ W^T in
  // pass 2; acc[mi][0] the logits in pass 1.
  float acc[2][NTW][4];
  float osum[NTW][2];   // this thread's share of out, by column pair
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = acc[1][n][e] = 0.f;
    osum[n][0] = osum[n][1] = 0.f;
  }

  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();  // item i has landed (this thread's copies)
    __syncthreads();  // everyone's copies; and item i-1 has been consumed
    prefetch(i + STAGES - 1);  // into the stage that item i-1 used

    if (i == items1) {
      // Between the passes: f32 softmax over the N real tokens, a warp per
      // query; the probabilities replace the logits, rounded to bf16, and are
      // zero on the padded tokens.
      float* srow = S + warp * Np;  // 8 warps, QG = 8 rows
      float mx = -INFINITY;
      for (int n = lane; n < N; n += 32) mx = fmaxf(mx, srow[n]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int n = lane; n < N; n += 32) sum += expf(srow[n] - mx);
      sum = warp_sum(sum);
      for (int n = lane; n < Np; n += 32)
        srow[n] = n < N ? __bfloat162float(__float2bfloat16_rn(
                              expf(srow[n] - mx) / sum))
                        : 0.f;
      __syncthreads();
    }

    const bf16* xs = ring + (i % STAGES) * STAGE;
    const bool last_slice = i % n_slices == n_slices - 1;

    if (i < items1) {
      // Pass 1: logits of this warp's 32 tokens x the 8 queries.
      const bf16* qs = xs + TN1 * LDK;
      const int n0 = i / n_slices * TN1 + warp * 32;
#pragma unroll
      for (int kd = 0; kd < KS / 16; kd += 2) {
        // four 8x8 matrices: the 8 queries x channels 0-7, 8-15, 16-23, 24-31
        unsigned qb[4];
        ldmatrix_x4(qb, qs + (lane & 7) * LDK + kd * 16 + (lane >> 3) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          unsigned xa0[4], xa1[4];
          const bf16* row = xs + (warp * 32 + mi * 16 + (lane & 15)) * LDK +
                            (lane >> 4) * 8;
          ldmatrix_x4(xa0, row + kd * 16);
          ldmatrix_x4(xa1, row + (kd + 1) * 16);
          mma_bf16_16816(acc[mi][0], xa0, qb[0], qb[1]);
          mma_bf16_16816(acc[mi][0], xa1, qb[2], qb[3]);
        }
      }
      if (last_slice) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // rows g, g+8 are tokens, columns 2*t4, 2*t4+1 queries
          float* s0 = S + (2 * t4) * Np + n0 + mi * 16 + g;
          s0[0] = acc[mi][0][0];
          s0[Np] = acc[mi][0][1];
          s0[8] = acc[mi][0][2];
          s0[Np + 8] = acc[mi][0][3];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][0][e] = 0.f;
        }
      }
      continue;
    }

    // Pass 2: this warp's 32 tokens x 2*CQ columns of x @ W^T.
    const bf16* ws = xs + TN * LDK;
#pragma unroll
    for (int kd = 0; kd < KS / 16; ++kd) {
      unsigned xa[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(xa[mi], xs + (wm * 32 + mi * 16 + (lane & 15)) * LDK +
                                kd * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < NTW / 2; ++j2) {
        unsigned wb[4];
        ldmatrix_x4(wb, ws + (wn * 2 * CQ + j2 * 16 + (lane & 7) +
                              (lane >> 4) * 8) * LDK +
                            kd * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16_16816(acc[mi][2 * j2], xa[mi], wb[0], wb[1]);
          mma_bf16_16816(acc[mi][2 * j2 + 1], xa[mi], wb[2], wb[3]);
        }
      }
    }
    if (last_slice) {
      // v = bf16(x @ W^T); weight rows g and g+8 (tokens) by p of the column
      // pair's query (cq is even, so a pair never straddles two queries).
      const int tok = (i - items1) / n_slices * TN + wm * 32 + g;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const float* prow = S + (wn * 2 * CQ + n * 8 + 2 * t4) / CQ * Np + tok;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float p0 = prow[mi * 16], p1 = prow[mi * 16 + 8];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v0 =
                __bfloat162float(__float2bfloat16_rn(acc[mi][n][e]));
            const float v1 =
                __bfloat162float(__float2bfloat16_rn(acc[mi][n][2 + e]));
            osum[n][e] = fmaf(p1, v1, fmaf(p0, v0, osum[n][e]));
            acc[mi][n][e] = acc[mi][n][2 + e] = 0.f;
          }
        }
      }
    }
  }

  // Fold the sums: over the 8 row lanes of a warp, then over the 2 token warps.
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        osum[n][e] += __shfl_xor_sync(0xffffffffu, osum[n][e], o);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* R = reinterpret_cast<float*>(smem);  // [2][COLS]
  if (g == 0) {
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      float* r = R + wm * COLS + wn * 2 * CQ + n * 8 + 2 * t4;
      r[0] = osum[n][0];
      r[1] = osum[n][1];
    }
  }
  __syncthreads();
  for (int j = tid; j < COLS; j += THREADS)
    if (c_lo + j < QC)
      out[(size_t)b * QC + c_lo + j] = __float2bfloat16_rn(R[j] + R[COLS + j]);
}

template <int CQ>
int launch(const void* q, const void* x, const void* w, void* out, int B, int N,
           int C, int Q, int x_bstride, cudaStream_t s) {
  const int bytes = proj_smem_bytes(N, CQ);
  cudaFuncSetAttribute(ep_pool_proj_kernel<CQ>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  ep_pool_proj_kernel<CQ><<<dim3(B, (Q + QG - 1) / QG), THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), static_cast<bf16*>(out), N, C, Q, x_bstride);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ep

// Dynamic shared memory of one block; 0 when there is no instantiation for
// this cq (built: 16, 24, 32, 40) or C is not a multiple of the 64-channel
// slice.
EP_EXPORT int ep_pool_proj_smem_bytes(int N, int C, int cq) {
  if (N < 1 || C % ep::KS || (cq != 16 && cq != 24 && cq != 32 && cq != 40))
    return 0;
  return ep::proj_smem_bytes(N, cq);
}

// q_scaled (Q, C), tokens (B, N, C), w (Q*cq, C), all bf16 -> out (B, Q*cq).
// The tokens' rows are contiguous; images are x_bstride elements apart.
EP_EXPORT int ep_pool_proj(const void* q, const void* x, const void* w,
                           void* out, int B, int N, int C, int Q, int cq,
                           int x_bstride, void* stream) {
  using namespace ep;
  const int bytes = ep_pool_proj_smem_bytes(N, C, cq);
  if (bytes == 0 || bytes > 232448 || B < 1 || Q < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cq) {
    case 16: return launch<16>(q, x, w, out, B, N, C, Q, x_bstride, s);
    case 24: return launch<24>(q, x, w, out, B, N, C, Q, x_bstride, s);
    case 32: return launch<32>(q, x, w, out, B, N, C, Q, x_bstride, s);
    default: return launch<40>(q, x, w, out, B, N, C, Q, x_bstride, s);
  }
}
