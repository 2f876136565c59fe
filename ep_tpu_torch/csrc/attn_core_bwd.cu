// Kernel E (attn_core_bwd): the backward of kernel B. From the fused qkv
// tensor (B, T, 3D) and the output cotangent dO (B, T, D), both bf16 in their
// natural layout, it writes dqkv (B, T, 3D) bf16 with columns
// [dq heads | dk heads | dv heads], at the TPU kernel's cast points:
//   A  = softmax(coef * q k^T)                   f32, normalised
//   dV = bf16(A)^T dO,  dA = dO V^T              f32 sums
//   dL = bf16(A * (dA - rowsum(A * dA)) * coef)
//   dQ = dL K,  dK = dL^T Q                      f32 sums, one bf16 rounding
// with coef = scale / temperature.
//
// Replaces: ep_tpu/ops/attn_fused_pallas.py::_bwd_kernel (head width 64) and
//   ::_bwd_kernel_head_group (head width 80, ViT-H), the in-VMEM Pallas
//   backward that the attention supercell's backward runs under --finetuning.
//
// Bound on this card: the five products are 10*T*T*Dh FLOP per (image, head)
//   against 14*T*Dh bytes in and out (about 2.5x the forward's FLOPs on the
//   same bytes): ~180 FLOP/byte at T=257, below the bf16 ridge on paper, but
//   like the forward it is held by the mma.sync rate, the exp and the
//   shared-memory fragment loads, not by device memory.
// Design: one block per (image, head), up to 9 warps (7 at T=197, 9 at
//   T=257: as few as take the 16-row tiles in the fewest rounds). Q, K, V and dO of the head are
//   staged once in shared memory (4 x T x Dh bf16, 191 KB at T=257, Dh=80)
//   with cp.async straight out of the qkv and dO rows; rows past T are zero.
//   No (T, T) tensor exists anywhere: everything is built from 16 x 16 tiles
//   held in registers (mma.sync m16n8k16 fed by ldmatrix, as in attn_core.cu).
//   Pass 1, one warp per 16 query rows, sweeps the keys twice in 16-key tiles:
//   the first sweep recomputes the logits and dA = dO V^T and keeps, per row,
//   a running max, sum of exp and sum of exp * dA (rescaled whenever the max
//   grows), which give the row max, 1/sum and rowsum(A * dA) exactly in f32;
//   the second sweep rebuilds A and dA, forms dL in registers and, since the
//   accumulator layout of two m16n8 tiles is the A-operand layout of one k16
//   slice, feeds it straight into dQ += dL K. The three row statistics go to
//   shared memory. Pass 2, one warp per 16 keys, sweeps the queries: it
//   computes the transposed tiles K Q^T and V dO^T, rebuilds A^T and dL^T
//   from the row statistics and accumulates dV += bf16(A)^T dO and
//   dK += dL^T Q in registers. The price of holding nothing but 16 x 16 tiles
//   is recomputation: 9 products of the five's size instead of 5, which buys
//   166-168 registers a thread without spills (ptxas, Dh 64 and 80) and T
//   bounded only by shared memory (320 at Dh=80).
#include "common.cuh"

namespace ep {
namespace {

constexpr int MAX_WARPS = 9;

__host__ __device__ inline int rows16(int T) { return (T + 15) / 16 * 16; }

template <int DH>
__host__ __device__ inline int bwd_smem_bytes(int T) {
  return 4 * rows16(T) * (DH + 8) * 2 + 3 * rows16(T) * 4;
}

// Warps per block: the fewest rounds of 16-row tiles, then the fewest warps
// that still take them in that many rounds.
__host__ inline int bwd_warps(int T) {
  const int tiles = rows16(T) / 16;
  const int rounds = (tiles + MAX_WARPS - 1) / MAX_WARPS;
  return (tiles + rounds - 1) / rounds;
}

// s = A1 B1[c0:c0+16]^T and d = A2 B2[c0:c0+16]^T: two 16 x 16 f32 tiles
// (s[j] holds columns 8j..8j+7) from the A fragments a1, a2 of a warp's 16
// rows and 16 rows of the row-major shared matrices b1, b2.
template <int DH, int LD>
__device__ __forceinline__ void tile_products(float (&s)[2][4], float (&d)[2][4],
                                              const unsigned (&a1)[DH / 16][4],
                                              const unsigned (&a2)[DH / 16][4],
                                              const bf16* b1, const bf16* b2,
                                              int c0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = d[j][e] = 0.f;
  const int off = (c0 + (lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
    unsigned f[4];
    ldmatrix_x4(f, b1 + off + kd * 16);
    mma_bf16_16816(s[0], a1[kd], f[0], f[1]);
    mma_bf16_16816(s[1], a1[kd], f[2], f[3]);
    ldmatrix_x4(f, b2 + off + kd * 16);
    mma_bf16_16816(d[0], a2[kd], f[0], f[1]);
    mma_bf16_16816(d[1], a2[kd], f[2], f[3]);
  }
}

// acc[n] += a (16 x 16, A layout) times rows c0..c0+15 of the row-major
// shared matrix m (16 x DH), for the DH/8 output tiles.
template <int DH, int LD>
__device__ __forceinline__ void accumulate_rows(float (&acc)[DH / 8][4],
                                                const unsigned (&a)[4],
                                                const bf16* m, int c0, int lane) {
  const int off = (c0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int nd = 0; nd < DH / 16; ++nd) {
    unsigned f[4];
    ldmatrix_x4_trans(f, m + off + nd * 16);
    mma_bf16_16816(acc[2 * nd], a, f[0], f[1]);
    mma_bf16_16816(acc[2 * nd + 1], a, f[2], f[3]);
  }
}

template <int DH, int LD>
__device__ __forceinline__ void load_a(unsigned (&a)[DH / 16][4], const bf16* m,
                                       int r0, int lane) {
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd)
    ldmatrix_x4(a[kd], m + (r0 + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);
}

// Rows r0+g and r0+g+8 of a 16 x DH f32 accumulator to bf16 columns of dst
// (row stride ld), skipping rows at or past T.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld,
                                           const float (&acc)[DH / 8][4],
                                           int r0, int g, int t4, int T) {
  bf16* row = dst + (size_t)(r0 + g) * ld + 2 * t4;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (r0 + g < T)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (r0 + g + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * ld + n * 8) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DH>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
attn_core_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                     bf16* __restrict__ dqkv, int T, int H, float coef) {
  constexpr int LD = DH + 8;  // shared row stride (bf16)
  constexpr int CH = DH / 8;  // 16-byte chunks per head row
  const int TP = rows16(T);
  const int tiles = TP / 16;
  const int D = H * DH;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [TP][LD] each
  bf16* Ks = Qs + TP * LD;
  bf16* Vs = Ks + TP * LD;
  bf16* Gs = Vs + TP * LD;
  float* row_max = reinterpret_cast<float*>(Gs + TP * LD);  // [TP] each
  float* row_inv = row_max + TP;                            // 1 / sum of exp
  float* row_dot = row_inv + TP;                            // rowsum(A * dA)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int h = blockIdx.x, b = blockIdx.y;
  const bf16* qkv_b = qkv + (size_t)b * T * 3 * D + h * DH;
  const bf16* g_b = gout + (size_t)b * T * D + h * DH;
  bf16* dqkv_b = dqkv + (size_t)b * T * 3 * D + h * DH;

  for (int idx = tid; idx < TP * CH; idx += nthreads) {
    const int t = idx / CH, c = (idx % CH) * 8, o = t * LD + c;
    if (t < T) {
      const bf16* row = qkv_b + (size_t)t * 3 * D + c;
      cp_async16(Qs + o, row);
      cp_async16(Ks + o, row + D);
      cp_async16(Vs + o, row + 2 * D);
      cp_async16(Gs + o, g_b + (size_t)t * D + c);
    } else {
      *reinterpret_cast<uint4*>(Qs + o) = zero_pack();
      *reinterpret_cast<uint4*>(Ks + o) = zero_pack();
      *reinterpret_cast<uint4*>(Vs + o) = zero_pack();
      *reinterpret_cast<uint4*>(Gs + o) = zero_pack();
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- pass 1: a warp per 16 query rows; dQ and the row statistics --------
  // This thread holds rows g (index 0) and g+8 (index 1) of each tile, at
  // columns c0 + 8j + 2*t4 + e.
  for (int tile = warp; tile < tiles; tile += nwarps) {
    const int r0 = tile * 16;
    unsigned qa[DH / 16][4], ga[DH / 16][4];
    load_a<DH, LD>(qa, Qs, r0, lane);
    load_a<DH, LD>(ga, Gs, r0, lane);

    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f},
          dot[2] = {0.f, 0.f};
    for (int c0 = 0; c0 < TP; c0 += 16) {
      float s[2][4], da[2][4];
      tile_products<DH, LD>(s, da, qa, ga, Ks, Vs, c0, lane);
      float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = c0 + 8 * j + 2 * t4 + (e & 1) < T;
          s[j][e] = ok ? s[j][e] * coef : -INFINITY;
          cm[e >> 1] = fmaxf(cm[e >> 1], s[j][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // key 0 is in the first tile, so the max is finite from there on
        const float m = fmaxf(mx[r], quad_max(cm[r]));
        const float rescale = __expf(mx[r] - m);
        sum[r] *= rescale;
        dot[r] *= rescale;
        mx[r] = m;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[j][e] - mx[e >> 1]);
          sum[e >> 1] += p;
          dot[e >> 1] += p * da[j][e];
        }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      inv[r] = 1.f / quad_sum(sum[r]);
      dot[r] = quad_sum(dot[r]) * inv[r];
    }

    float dq[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
    for (int c0 = 0; c0 < TP; c0 += 16) {
      float s[2][4], da[2][4];
      tile_products<DH, LD>(s, da, qa, ga, Ks, Vs, c0, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool ok = c0 + 8 * j + 2 * t4 + (e & 1) < T;
          const float a = ok ? __expf(s[j][e] * coef - mx[r]) * inv[r] : 0.f;
          s[j][e] = a * (da[j][e] - dot[r]) * coef;  // dL
        }
      const unsigned la[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      accumulate_rows<DH, LD>(dq, la, Ks, c0, lane);
    }
    store_rows<DH>(dqkv_b, (size_t)3 * D, dq, r0, g, t4, T);
    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        row_max[row] = mx[r];
        // rows past T (zero q and dO) drop out of pass 2 through a zero 1/sum
        row_inv[row] = row < T ? inv[r] : 0.f;
        row_dot[row] = dot[r];
      }
    }
  }
  __syncthreads();

  // ---- pass 2: a warp per 16 keys; dK and dV -----------------------------
  // This thread holds keys k0+g (index 0) and k0+g+8 (index 1) of the tile,
  // against queries c0 + 8j + 2*t4 + e.
  for (int tile = warp; tile < tiles; tile += nwarps) {
    const int k0 = tile * 16;
    unsigned ka[DH / 16][4], va[DH / 16][4];
    load_a<DH, LD>(ka, Ks, k0, lane);
    load_a<DH, LD>(va, Vs, k0, lane);
    const bool key_ok[2] = {k0 + g < T, k0 + g + 8 < T};
    float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    for (int c0 = 0; c0 < TP; c0 += 16) {
      float st[2][4], dat[2][4];  // K Q^T and V dO^T: A^T and dA^T
      tile_products<DH, LD>(st, dat, ka, va, Qs, Gs, c0, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = c0 + 8 * j + 2 * t4 + (e & 1);
          const float a = key_ok[e >> 1]
              ? __expf(st[j][e] * coef - row_max[q]) * row_inv[q] : 0.f;
          st[j][e] = a;
          dat[j][e] = a * (dat[j][e] - row_dot[q]) * coef;  // dL^T
        }
      const unsigned aa[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
      const unsigned la[4] = {pack_bf16(dat[0][0], dat[0][1]), pack_bf16(dat[0][2], dat[0][3]),
                              pack_bf16(dat[1][0], dat[1][1]), pack_bf16(dat[1][2], dat[1][3])};
      accumulate_rows<DH, LD>(dv, aa, Gs, c0, lane);
      accumulate_rows<DH, LD>(dk, la, Qs, c0, lane);
    }
    store_rows<DH>(dqkv_b + D, (size_t)3 * D, dk, k0, g, t4, T);
    store_rows<DH>(dqkv_b + 2 * D, (size_t)3 * D, dv, k0, g, t4, T);
  }
}

template <int DH>
int launch_bwd(const void* qkv, const void* gout, void* dqkv, int B, int T,
               int H, float coef, cudaStream_t s) {
  const int bytes = bwd_smem_bytes<DH>(T);
  cudaFuncSetAttribute(attn_core_bwd_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  attn_core_bwd_kernel<DH><<<dim3(H, B), 32 * bwd_warps(T), bytes, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(gout),
      static_cast<bf16*>(dqkv), T, H, coef);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ep

// Dynamic shared memory the backward needs at this T and head width; 0 when
// there is no instantiation for the head width (64 and 80 are built).
EP_EXPORT int ep_attn_core_bwd_smem_bytes(int T, int head_dim) {
  if (T < 1) return 0;
  if (head_dim == 64) return ep::bwd_smem_bytes<64>(T);
  if (head_dim == 80) return ep::bwd_smem_bytes<80>(T);
  return 0;
}

// qkv (B, T, 3*H*Dh) and dO (B, T, H*Dh) bf16 -> dqkv (B, T, 3*H*Dh) bf16;
// coef = scale/temperature. The caller checks the shared-memory size.
EP_EXPORT int ep_attn_core_bwd(const void* qkv, const void* gout, void* dqkv,
                               int B, int T, int H, int head_dim, float coef,
                               void* stream) {
  if (ep_attn_core_bwd_smem_bytes(T, head_dim) == 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64
             ? ep::launch_bwd<64>(qkv, gout, dqkv, B, T, H, coef, s)
             : ep::launch_bwd<80>(qkv, gout, dqkv, B, T, H, coef, s);
}
