// Kernel D (ep_pool): the Efficient Probing pool.
//   logits[q, n] = q_scaled[q] . tokens[n]             (f32)
//   p = softmax_n(logits), rounded to bf16
//   out[q, c]   = sum_n p[q, n] * v[n, q*cq + c]        (f32 sum, one bf16 rounding)
//
// Replaces: ep_tpu/ops/pool_attn_pallas.py::_ep_kernel (ep_pool_attend). It
//   computes what the TPU kernel computes, not its masked-full block-diagonal
//   (Q, N) @ (N, Q*cq) product, which exists to keep the 128x128 MXU busy and
//   spends Q times the needed MACs.
//
// Bound on this card: bytes. At ViT-B EP32 bs512 the pool reads 155 MB of
//   tokens and 155 MB of projected values for ~10 GFLOP of useful work
//   (~32 FLOP/byte), far below the bf16 ridge.
// Design: one 128-thread block per image. q_scaled (Q x C, 48 KB at ViT-B) stays
//   in shared memory; one image's tokens (301 KB) do not fit in a block's
//   227 KB, so they stream through a 32-token shared tile and the f32 logits
//   (Q x N, 25 KB) build up tile by tile with wmma (bf16 in, f32 accumulate).
//   The f32 softmax runs in place. The value contraction reads v once, straight
//   from device memory with coalesced loads: thread j owns output column j of
//   the (Q*cq)-wide row and walks the N tokens, so no column is computed that
//   the output does not keep. N is exact: nothing pads to 128 lanes.
//   Where the query bank, the token tile and the logits of all Q queries pass
//   a block's 227 KB (ViT-H/14 at 448 px: Q=32, C=1280, N=1024 needs 295,936
//   bytes), the queries are split over 2, 4, ... blocks an image (grid (B,
//   split)): a block keeps its share of the query bank and of the logits
//   (189,184 bytes at that shape with 2), and reads the image's tokens once
//   more per share, from L2. The shapes that fit keep one block an image.
#include "common.cuh"

using namespace nvcuda;

namespace ep {
namespace {

constexpr int TN = 32;        // tokens per streamed tile
constexpr int THREADS = 128;  // 4 warps

__host__ __device__ inline int rows16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int tokens_padded(int N) { return (N + TN - 1) / TN * TN; }

// Shared memory of a block that takes QB of the queries.
__host__ __device__ inline int smem_bytes(int N, int C, int QB) {
  const int CL = C + 8;
  return rows16(QB) * CL * 2 + TN * CL * 2 + rows16(QB) * tokens_padded(N) * 4;
}

constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90

// Blocks an image: the fewest equal shares of the queries that fit a block's
// shared memory; 0 when not even one query a block fits.
inline int query_split(int N, int C, int Q) {
  for (int split = 1; split <= Q; ++split)
    if (Q % split == 0 && smem_bytes(N, C, Q / split) <= MAX_SMEM) return split;
  return 0;
}

__global__ void __launch_bounds__(THREADS)
ep_pool_kernel(const bf16* __restrict__ q, const bf16* __restrict__ x,
               const bf16* __restrict__ v, bf16* __restrict__ out, int N, int C,
               int Q, int cq, int x_bstride) {
  // This block's share of the queries: QB of them from q_lo on.
  const int QB = Q / gridDim.y;
  const int q_lo = blockIdx.y * QB;
  const int CL = C + 8;  // shared row stride (bf16) of q and the token tile
  const int Qp = rows16(QB);
  const int Np = tokens_padded(N);
  const int QC = Q * cq;
  const int CH = C / 8;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);             // [Qp][CL]
  bf16* xs = qs + Qp * CL;                              // [TN][CL]
  float* S = reinterpret_cast<float*>(xs + TN * CL);    // [Qp][Np]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const bf16* xb = x + (size_t)b * x_bstride;

  for (int idx = tid; idx < Qp * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    *reinterpret_cast<uint4*>(qs + r * CL + c) =
        r < QB ? *reinterpret_cast<const uint4*>(q + (size_t)(q_lo + r) * C + c)
               : zero_pack();
  }

  const int nfrag = (Qp / 16) * (TN / 16);
  for (int n0 = 0; n0 < Np; n0 += TN) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < TN * CH; idx += THREADS) {
      const int r = idx / CH, c = (idx % CH) * 8;
      *reinterpret_cast<uint4*>(xs + r * CL + c) =
          n0 + r < N ? *reinterpret_cast<const uint4*>(
                           xb + (size_t)(n0 + r) * C + c)
                     : zero_pack();
    }
    __syncthreads();
    for (int f = warp; f < nfrag; f += THREADS / 32) {
      const int qi = f / (TN / 16), ti = f % (TN / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + qi * 16 * CL + k, CL);
        wmma::load_matrix_sync(fb, xs + ti * 16 * CL + k, CL);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + qi * 16 * Np + n0 + ti * 16, acc, Np,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // f32 softmax over the N real tokens, one warp per query row; the
  // probabilities replace the logits, already rounded to bf16.
  for (int r = warp; r < QB; r += THREADS / 32) {
    float* srow = S + r * Np;
    float mx = -INFINITY;
    for (int n = lane; n < N; n += 32) mx = fmaxf(mx, srow[n]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int n = lane; n < N; n += 32) sum += expf(srow[n] - mx);
    sum = warp_sum(sum);
    for (int n = lane; n < N; n += 32)
      srow[n] = __bfloat162float(__float2bfloat16_rn(expf(srow[n] - mx) / sum));
  }
  __syncthreads();

  // out[q, c] = sum_n p[q, n] v[n, q*cq + c]: thread j owns column j.
  const bf16* vb = v + (size_t)b * N * QC;
  for (int j = q_lo * cq + tid; j < (q_lo + QB) * cq; j += THREADS) {
    const float* prow = S + (j / cq - q_lo) * Np;
    float acc = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n)
      acc = fmaf(prow[n], __bfloat162float(vb[(size_t)n * QC + j]), acc);
    out[(size_t)b * QC + j] = __float2bfloat16_rn(acc);
  }
}

}  // namespace
}  // namespace ep

// Shared memory of one block at the query split the launch takes; over
// 232,448 when not even one query a block fits.
EP_EXPORT int ep_pool_smem_bytes(int N, int C, int Q) {
  const int split = ep::query_split(N, C, Q);
  return ep::smem_bytes(N, C, split ? Q / split : 1);
}

// Blocks an image (1 where all Q queries fit one block); 0 when none fits.
EP_EXPORT int ep_pool_query_split(int N, int C, int Q) {
  return ep::query_split(N, C, Q);
}

// q_scaled (Q, C), tokens (B, N, C), v (B, N, Q*cq), all bf16 -> out (B, Q*cq).
// The tokens' rows are contiguous; images are x_bstride elements apart, so the
// patch tokens can be a view that skips the [CLS] row.
EP_EXPORT int ep_pool(const void* q, const void* x, const void* v, void* out,
                      int B, int N, int C, int Q, int cq, int x_bstride,
                      void* stream) {
  using namespace ep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int split = query_split(N, C, Q);
  if (split == 0) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(N, C, Q / split);
  cudaFuncSetAttribute(ep_pool_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  ep_pool_kernel<<<dim3(B, split), THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(x),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), N, C, Q, cq,
      x_bstride);
  return (int)cudaGetLastError();
}
