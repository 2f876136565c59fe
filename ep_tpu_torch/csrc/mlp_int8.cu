// The int8 MLP half: out = x + fc2(gelu(fc1(LN2(x)))) with both products on
// the int8 tensor cores, as three kernels: ln_quant, fc1, fc2.
//
// Replaces: ep_tpu/ops/mlp_int8_pallas.py::_kernel (one program an image,
//   both weights resident) and its split form _kernel_fc1 / _kernel_fc2. The
//   TPU kernels hold one image's rows and a whole weight in VMEM; one block
//   of an H100 has 227 KB of shared memory, so here the rows are tiled across
//   images (LN and both scales are per token) and the weights stream. What is
//   kept is the contract: no LN output and no hidden activation wider than
//   int8 reaches device memory. Between the kernels pass only int8 codes with
//   their f32 scales: hq (M, D) with sx (M), then aq (M, DH) with sa (M, S),
//   where M = B*T and S is the stripe count. S is part of the result: the
//   hidden activation is requantised per token and per stripe of DH/S
//   columns, exactly as the TPU kernels do at the same shape.
//
// Bound on this card: operations. One block's two products are 4*M*D*DH
//   int8 operations against about M*(4*D + 2*DH) bytes of activations, far
//   above the int8 ridge of an H100.
// Design: a simple tiled product first. mma.sync m16n8k32 (s8 x s8 -> s32)
//   fed by ldmatrix from a 3-stage cp.async ring of 128-byte K slices; an
//   int8 row of 32 bytes has the byte layout of a bf16 row of 16 values, so
//   the b16 ldmatrix addressing of attn_block_gemm.cu carries over in bytes.
//   * ln_quant: one warp a row; f32 statistics, h = LN(x), sx = max|h|/127,
//     hq = rint(h / sx).
//   * fc1: one block owns 128 rows and one stripe. The requantisation scale
//     needs the whole stripe's max before any code can be written, and a
//     stripe (3072 columns at ViT-B) fits no tile, so the block runs the
//     stripe's product twice: pass 0 keeps only max|gelu| per row (quad
//     shuffles, then atomicMax in shared memory), pass 1 recomputes and
//     writes aq = rint(gelu / sa). GELU is the tanh form on the bf16-rounded
//     pre-activation, rounded to bf16 after every elementary operation.
//   * fc2: a 128x64 tile over K = DH; at each stripe's end the s32
//     accumulator is dequantised with sa[:, s]*s2 into an f32 running sum
//     (the scale changes per stripe, so the s32 sum cannot run across
//     stripes); epilogue bias, f32 residual, one rounding to bf16.
//   Every f32 step uses the round-to-nearest intrinsics so that no
//   multiply-add is contracted: the kernels round where the plain version
//   (ops/mlp_int8.py::mlp_int8_ref) rounds, and the s32 sums are exact.
//   Running fc1's product twice, the pipeline refill per column tile and
//   mma.sync instead of wgmma are what a faster version would remove.
//
// Layouts: x, out (M, D) bf16; w1q (DH, D) and w2q (D, DH) int8, the
// nn.Linear layout (K contiguous per output channel, the "col" operand of the
// mma); s1 (DH), s2 (D), b1, b2, gamma, beta f32. Requires D % 128 == 0 and
// (DH / S) % 128 == 0 (checked by the Python wrapper); M may be ragged.
#include "common.cuh"

namespace ep {
namespace {

constexpr int BM = 128, BK = 128, STAGES = 3, THREADS = 256;
constexpr int LDS = BK + 16;  // shared row stride (bytes) of a K slice
constexpr int CPR = BK / 16;  // 16-byte chunks per slice row
constexpr float GELU_K0 = 0.044677734375f;  // bf16(0.044715)
constexpr float GELU_K1 = 0.796875f;        // bf16(sqrt(2/pi))

// d += a * b: a 16x32 s8 (row), b 32x8 s8 (col), d 16x8 s32. Thread
// (g = lane/4, t = lane%4) holds d rows g and g+8, columns 2t and 2t+1.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// tanh-form GELU of a bf16-representable value, every operation rounded to
// bf16 with bf16 constants: the arithmetic of gelu_tanh_bf16 in mlp_int8.py.
__device__ __forceinline__ float gelu_bf16(float a) {
  const float x3 = round_bf16(__fmul_rn(round_bf16(__fmul_rn(a, a)), a));
  const float inner = round_bf16(__fadd_rn(a, round_bf16(__fmul_rn(x3, GELU_K0))));
  const float th = round_bf16(tanhf(round_bf16(__fmul_rn(inner, GELU_K1))));
  const float cdf = round_bf16(__fmul_rn(round_bf16(__fadd_rn(th, 1.0f)), 0.5f));
  return round_bf16(__fmul_rn(a, cdf));
}

__device__ __forceinline__ int quantise(float v, float scale) {
  return (int)rintf(__fdiv_rn(v, scale));  // half to even; |v/scale| <= 127
}

// h = LN(x) in f32 for 8 consecutive columns of one row.
__device__ __forceinline__ void ln_chunk(const bf16* xr, const float* gamma,
                                         const float* beta, int c, float mean,
                                         float rstd, float (&h)[8]) {
  Pack8 v;
  v.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    h[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.get(e), mean), rstd),
                               __ldg(gamma + c + e)),
                     __ldg(beta + c + e));
}

// One warp per row: LN2 with f32 statistics (the variance as the mean squared
// deviation), the row's scale sx = max(max|h|, 1e-8) / 127 and its codes.
__global__ void ln_quant_kernel(const bf16* __restrict__ x,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                int8_t* __restrict__ hq, float* __restrict__ sx,
                                int M, int D, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    Pack8 v;
    v.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v.get(e);
  }
  const float mean = warp_sum(s) / (float)D;
  float ss = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    Pack8 v;
    v.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = __fsub_rn(v.get(e), mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / (float)D + eps);
  float am = 0.f, h[8];
  for (int c = lane * 8; c < D; c += 256) {
    ln_chunk(xr, gamma, beta, c, mean, rstd, h);
#pragma unroll
    for (int e = 0; e < 8; ++e) am = fmaxf(am, fabsf(h[e]));
  }
  const float scale = __fdiv_rn(fmaxf(warp_max(am), 1e-8f), 127.0f);
  for (int c = lane * 8; c < D; c += 256) {
    ln_chunk(xr, gamma, beta, c, mean, rstd, h);
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e >> 2] |= (unsigned)(quantise(h[e], scale) & 0xff) << (8 * (e & 3));
    *reinterpret_cast<uint2*>(hq + (size_t)row * D + c) = make_uint2(w[0], w[1]);
  }
  if (lane == 0) sx[row] = scale;
}

// Rows row0.. of a (rows, ld) int8 matrix, bytes k0..k0+BK, into one stage.
// Rows at or past `rows` are zero-filled.
template <int TILE_ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const int8_t* __restrict__ src,
                                          int ld, int row0, int rows, int k0,
                                          int tid) {
  const int c_row = tid / CPR, c_col = (tid % CPR) * 16;
#pragma unroll
  for (int i = 0; i < TILE_ROWS / (THREADS / CPR); ++i) {
    const int r = c_row + (THREADS / CPR) * i;
    unsigned char* d = dst + r * LDS + c_col;
    if (row0 + r < rows)
      cp_async16(d, src + (size_t)(row0 + r) * ld + k0 + c_col);
    else
      *reinterpret_cast<uint4*>(d) = zero_pack();
  }
}

// acc += A slice x W slice for one warp: rows a_row0.. of the A stage, rows
// (output channels) w_row0.. of the W stage, MI x 2*NJ tiles of 16 x 8.
template <int MI, int NJ>
__device__ __forceinline__ void mma_slice(const unsigned char* as,
                                          const unsigned char* ws, int a_row0,
                                          int w_row0, int lane,
                                          int (&acc)[MI][2 * NJ][4]) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 32) {
    unsigned af[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldmatrix_x4(af[mi], reinterpret_cast<const bf16*>(
                              as + (a_row0 + mi * 16 + (lane & 15)) * LDS + ks +
                              (lane >> 4) * 16));
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      unsigned bfr[4];
      ldmatrix_x4(bfr, reinterpret_cast<const bf16*>(
                           ws + (w_row0 + nj * 16 + (lane & 7) + (lane >> 4) * 8) *
                                    LDS + ks + ((lane >> 3) & 1) * 16));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_s8_16832(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
        mma_s8_16832(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
      }
    }
  }
}

// The product of rows m0.. of A (M, K) with output channels n0..n0+BN of W
// over K slices kt0..kt0+nk, through the cp.async ring. after(kt) runs once
// the MMAs of slice kt are issued. Leaves the ring free (all copies landed,
// all warps past their last read).
template <int BN, int MI, int NJ, class After>
__device__ __forceinline__ void product(const int8_t* __restrict__ A,
                                        const int8_t* __restrict__ W, int K,
                                        int M, int m0, int n0, int nk,
                                        unsigned char* ring, int a_row0,
                                        int w_row0, int tid,
                                        int (&acc)[MI][2 * NJ][4], After after) {
  constexpr int A_STAGE = BM * LDS, B_STAGE = BN * LDS;
  unsigned char* As = ring;
  unsigned char* Bs = ring + STAGES * A_STAGE;
  auto load_stage = [&](int buf, int kt) {
    load_tile<BM>(As + buf * A_STAGE, A, K, m0, M, kt * BK, tid);
    load_tile<BN>(Bs + buf * B_STAGE, W, K, n0, n0 + BN, kt * BK, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt landed; every warp is done with slice kt-1
    if (kt + STAGES - 1 < nk)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int buf = kt % STAGES;
    mma_slice<MI, NJ>(As + buf * A_STAGE, Bs + buf * B_STAGE, a_row0, w_row0,
                      tid & 31, acc);
    after(kt);
  }
  cp_async_wait<0>();
  __syncthreads();
}

constexpr int FC1_BN = 128, FC1_MI = 4, FC1_NJ = 2;  // 2x4 warps of 64x32
constexpr int FC1_SMEM = STAGES * (BM + FC1_BN) * LDS;
constexpr int FC2_BN = 64, FC2_MI = 2, FC2_NJ = 2;  // 4x2 warps of 32x32
constexpr int FC2_SMEM = STAGES * (BM + FC2_BN) * LDS;
constexpr int FC2_CLD = FC2_BN + 4;  // f32 row stride of fc2's epilogue tile
static_assert(BM * FC2_CLD * 4 <= FC2_SMEM, "fc2's epilogue tile fits the ring");
static_assert(BM * LDS <= FC1_SMEM, "fc1's code tile fits the ring");

// grid (S, ceil(M / 128)): rows m0.. and stripe blockIdx.x of the hidden dim.
__global__ void __launch_bounds__(THREADS, 2)
fc1_kernel(const int8_t* __restrict__ hq, const float* __restrict__ sx,
           const int8_t* __restrict__ w1q, const float* __restrict__ s1,
           const float* __restrict__ b1, int8_t* __restrict__ aq,
           float* __restrict__ sa, int M, int D, int DH, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float sx_s[BM];
  __shared__ float sa_s[BM];
  __shared__ unsigned amax_s[BM];  // bits of a non-negative f32: order-preserving

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int stripe = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int ds = DH / S;
  const int nk = D / BK;

  if (tid < BM) {
    sx_s[tid] = (m0 + tid < M) ? sx[m0 + tid] : 0.f;
    amax_s[tid] = 0u;
  }
  __syncthreads();

  for (int pass = 0; pass < 2; ++pass) {
    for (int n0 = stripe * ds; n0 < (stripe + 1) * ds; n0 += FC1_BN) {
      int acc[FC1_MI][2 * FC1_NJ][4];
#pragma unroll
      for (int mi = 0; mi < FC1_MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2 * FC1_NJ; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
      product<FC1_BN, FC1_MI, FC1_NJ>(hq, w1q, D, M, m0, n0, nk, smem, wm * 64,
                                      wn * 32, tid, acc, [](int) {});

      // a = acc*(sx*s1) + b1 in f32, rounded to bf16, GELU in bf16
      float rmax[FC1_MI][2];
#pragma unroll
      for (int mi = 0; mi < FC1_MI; ++mi) rmax[mi][0] = rmax[mi][1] = 0.f;
#pragma unroll
      for (int ni = 0; ni < 2 * FC1_NJ; ++ni) {
        const int c = wn * 32 + ni * 8 + 2 * t;
        const float s1a = __ldg(s1 + n0 + c), s1b = __ldg(s1 + n0 + c + 1);
        const float b1a = __ldg(b1 + n0 + c), b1b = __ldg(b1 + n0 + c + 1);
#pragma unroll
        for (int mi = 0; mi < FC1_MI; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm * 64 + mi * 16 + g + 8 * half;
            const float sxr = sx_s[r];
            const float va = gelu_bf16(round_bf16(__fadd_rn(
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * half]),
                          __fmul_rn(sxr, s1a)), b1a)));
            const float vb = gelu_bf16(round_bf16(__fadd_rn(
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + 1]),
                          __fmul_rn(sxr, s1b)), b1b)));
            if (pass == 0) {
              rmax[mi][half] = fmaxf(rmax[mi][half], fmaxf(fabsf(va), fabsf(vb)));
            } else {
              const float sar = sa_s[r];
              const unsigned q = (unsigned)(quantise(va, sar) & 0xff) |
                                 ((unsigned)(quantise(vb, sar) & 0xff) << 8);
              *reinterpret_cast<unsigned short*>(smem + r * LDS + c) =
                  (unsigned short)q;
            }
          }
      }
      if (pass == 0) {
#pragma unroll
        for (int mi = 0; mi < FC1_MI; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v = rmax[mi][half];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            if (t == 0)
              atomicMax(&amax_s[wm * 64 + mi * 16 + g + 8 * half],
                        __float_as_uint(v));
          }
      } else {
        __syncthreads();  // the code tile is whole
        for (int idx = tid; idx < BM * (FC1_BN / 16); idx += THREADS) {
          const int r = idx / (FC1_BN / 16), c = (idx % (FC1_BN / 16)) * 16;
          if (m0 + r < M)
            *reinterpret_cast<uint4*>(aq + (size_t)(m0 + r) * DH + n0 + c) =
                *reinterpret_cast<const uint4*>(smem + r * LDS + c);
        }
        __syncthreads();  // before the next tile's copies land on it
      }
    }
    if (pass == 0) {
      __syncthreads();  // every warp's maxima are in
      if (tid < BM) {
        const float v =
            __fdiv_rn(fmaxf(__uint_as_float(amax_s[tid]), 1e-8f), 127.0f);
        sa_s[tid] = v;
        if (m0 + tid < M) sa[(size_t)(m0 + tid) * S + stripe] = v;
      }
      __syncthreads();
    }
  }
}

// grid (D / 64, ceil(M / 128)).
__global__ void __launch_bounds__(THREADS, 2)
fc2_kernel(const int8_t* __restrict__ aq, const float* __restrict__ sa,
           const int8_t* __restrict__ w2q, const float* __restrict__ s2,
           const float* __restrict__ b2, const bf16* __restrict__ x,
           bf16* __restrict__ out, int M, int D, int DH, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][FC2_CLD], after the loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * FC2_BN;
  const int m0 = blockIdx.y * BM;
  const int per_stripe = (DH / S) / BK;

  float s2v[2 * FC2_NJ][2];
#pragma unroll
  for (int ni = 0; ni < 2 * FC2_NJ; ++ni) {
    s2v[ni][0] = __ldg(s2 + n0 + wn * 32 + ni * 8 + 2 * t);
    s2v[ni][1] = __ldg(s2 + n0 + wn * 32 + ni * 8 + 2 * t + 1);
  }
  int acc[FC2_MI][2 * FC2_NJ][4];
  float y[FC2_MI][2 * FC2_NJ][4];
#pragma unroll
  for (int mi = 0; mi < FC2_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2 * FC2_NJ; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0;
        y[mi][ni][e] = 0.f;
      }

  // y += acc * (sa[:, s] * s2) at the end of each stripe of K
  auto fold = [&](int kt) {
    if ((kt + 1) % per_stripe) return;
    const int s = kt / per_stripe;
#pragma unroll
    for (int mi = 0; mi < FC2_MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 32 + mi * 16 + g + 8 * half;
        const float sar = (m < M) ? __ldg(sa + (size_t)m * S + s) : 0.f;
#pragma unroll
        for (int ni = 0; ni < 2 * FC2_NJ; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 2 * half + j;
            y[mi][ni][e] = __fadd_rn(
                y[mi][ni][e], __fmul_rn(__int2float_rn(acc[mi][ni][e]),
                                        __fmul_rn(sar, s2v[ni][j])));
            acc[mi][ni][e] = 0;
          }
      }
  };
  product<FC2_BN, FC2_MI, FC2_NJ>(aq, w2q, DH, M, m0, n0, DH / BK, smem,
                                  wm * 32, wn * 32, tid, acc, fold);

#pragma unroll
  for (int mi = 0; mi < FC2_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2 * FC2_NJ; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mi * 16 + g + 8 * half;
        const int c = wn * 32 + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(Cs + r * FC2_CLD + c) =
            make_float2(y[mi][ni][2 * half], y[mi][ni][2 * half + 1]);
      }
  __syncthreads();
  // out = bf16(f32(x) + (y + b2))
  for (int idx = tid; idx < BM * FC2_BN / 8; idx += THREADS) {
    const int r = idx / (FC2_BN / 8), c = (idx % (FC2_BN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M) continue;
    Pack8 res, o;
    res.u = *reinterpret_cast<const uint4*>(x + (size_t)m * D + n);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o.set(e, __fadd_rn(res.get(e),
                         __fadd_rn(Cs[r * FC2_CLD + c + e], __ldg(b2 + n + e))));
    *reinterpret_cast<uint4*>(out + (size_t)m * D + n) = o.u;
  }
}

}  // namespace
}  // namespace ep

// x (M, D) bf16 -> hq (M, D) int8 and sx (M) f32.
EP_EXPORT int ep_mlp_int8_ln_quant(const void* x, const void* gamma,
                                   const void* beta, void* hq, void* sx, int M,
                                   int D, float eps, void* stream) {
  using namespace ep;
  const int rows_per_block = 256 / 32;
  ln_quant_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<int8_t*>(hq),
      static_cast<float*>(sx), M, D, eps);
  return (int)cudaGetLastError();
}

// hq (M, D), sx (M), w1q (DH, D), s1/b1 (DH) -> aq (M, DH) int8, sa (M, S).
EP_EXPORT int ep_mlp_int8_fc1(const void* hq, const void* sx, const void* w1q,
                              const void* s1, const void* b1, void* aq,
                              void* sa, int M, int D, int DH, int S,
                              void* stream) {
  using namespace ep;
  cudaFuncSetAttribute(fc1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       FC1_SMEM);
  const dim3 grid(S, (M + BM - 1) / BM);
  fc1_kernel<<<grid, THREADS, FC1_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w1q), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<int8_t*>(aq),
      static_cast<float*>(sa), M, D, DH, S);
  return (int)cudaGetLastError();
}

// aq (M, DH), sa (M, S), w2q (D, DH), s2/b2 (D), x (M, D) -> out (M, D) bf16.
EP_EXPORT int ep_mlp_int8_fc2(const void* aq, const void* sa, const void* w2q,
                              const void* s2, const void* b2, const void* x,
                              void* out, int M, int D, int DH, int S,
                              void* stream) {
  using namespace ep;
  cudaFuncSetAttribute(fc2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       FC2_SMEM);
  const dim3 grid(D / FC2_BN, (M + BM - 1) / BM);
  fc2_kernel<<<grid, THREADS, FC2_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(aq), static_cast<const float*>(sa),
      static_cast<const int8_t*>(w2q), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const bf16*>(x),
      static_cast<bf16*>(out), M, D, DH, S);
  return (int)cudaGetLastError();
}
