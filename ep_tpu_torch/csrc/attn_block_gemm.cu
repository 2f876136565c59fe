// Kernels A (ln_qkv_gemm) and C (proj_residual_gemm): the two products of the
// attention supercell, around the attention core (kernel B, attn_core.cu).
//
// Replaces: ep_tpu/ops/attn_block_pallas.py::_kernel, its LN1 + qkv part
//   (A: bf16(bf16(LN(x)) @ Wqkv + b)) and its proj + residual part
//   (C: bf16(f32(x) + (o @ Wproj + b))). The TPU kernel holds one image's
//   whole half-block in VMEM; on Hopper one image's qkv rows (~0.9 MB at
//   ViT-B) are far over a block's 227 KB of shared memory, so the half-block
//   becomes three kernels that keep its contract: the LN output never reaches
//   device memory, and no per-head q/k/v copy or (B,H,T,T) tensor exists.
//
// Bound on this card: operations. At ViT-B bs512 the qkv product is 357 GFLOP
//   and proj 119 GFLOP per block against 155 MB of activations read, far above
//   the ~295 FLOP/byte ridge of an H100 in bf16, and only wgmma reaches the
//   tensor cores' full rate.
// Design: the main loop of hopper.cuh. One persistent block an SM (384
//   threads: two consumer warpgroups and a producer) owns a panel of 128 rows
//   for all of its 256-column tiles, then takes the panel gridDim further on.
//   A producer thread streams 64-deep K slices of the panel and of W through
//   a 3-stage ring by TMA; each consumer warpgroup accumulates its 64 x 256
//   half of the tile in registers with wgmma m64n256k16 (f32 accumulators),
//   one group in flight while the next is prepared.
//   * C takes both operands from shared memory.
//   * A applies LN on the way from shared memory to the tensor core: wgmma
//     takes its A operand from registers, so each warp reads the raw-x
//     fragment of its 16 rows with ldmatrix (the swizzle's XOR in the
//     address), normalises the 8 values a thread holds with its two rows'
//     (mean, rstd) kept in registers and gamma / beta staged once a block in
//     shared memory, rounds to bf16 and issues the product. Nothing is
//     written back, no block-wide barrier sits in the loop, and the fragments
//     of slice k+1 are prepared while the products of slice k run. The row
//     statistics come from a kernel of their own, one warp a row, which reads
//     the row once with 16-byte loads and keeps it in registers for the
//     two-pass variance (taken inside the GEMM at the head of each panel they
//     left the tensor cores idle for a fifth of its time).
//   * The epilogue adds the f32 bias (and, for C, the f32 residual) to the
//     accumulators and rounds once to bf16, the cast points of the TPU
//     kernel, into a buffer of the warpgroup in shared memory, in the layout
//     of TMA boxes; one thread hands the boxes to TMA, which writes them
//     while the next tile's loop runs and drops what lies past M or N. For C
//     the producer brings the residual tile into the same buffer by TMA
//     during the loop. (Stores of 4 bytes a thread straight from the
//     accumulators took as long as the product itself.)
//
// Layouts: A (M, K) row-major bf16 with M = B*T; W (N, K) row-major bf16, the
// nn.Linear weight layout; out (M, N) bf16. Requires K % 64 == 0, N % 8 == 0
// and, for kernel A, K <= 1280 (a row's values are held by one warp); checked
// by the Python wrapper.
//
// LN1's gradient in the supercell's backward (ln1_apply, ln1_bwd): no TPU
// kernel. The JAX package leaves LN1's VJP to XLA, which fuses it; autograd
// over the plain f32 LayerNorm took 45 launches and some 200 bytes an
// element a block on this card. Bound: bytes (a few operations an element).
//   * ln1_apply writes xn = bf16((f32(x) - mean) * rstd * gamma + beta), the
//     input of qkv's weight gradient, from kernel A's row statistics, with
//     kernel A's rounding steps.
//   * ln1_bwd reads x, the statistics, gamma, dxn (the gradient at xn) and
//     g (the gradient at the block's output) once each, one warp a row, and
//     writes bf16(f32(g) + f32(bf16(dx))): LN's input gradient rounded to
//     x's type, then the residual's sum, the plain version's two roundings.
//     Each block keeps f32 column sums of f32(dxn) * xhat (gamma's
//     gradient), f32(dxn) (beta's) and f32(g) (the projection bias's) in
//     registers over a fixed range of rows, adds its warps' sums in a fixed
//     order and writes them; a second kernel adds the blocks' sums in a
//     fixed order. No atomics: two runs give the same bits.
// Both take kernel A's widths (K % 64 == 0, K <= 1280), a lane holding
// K / 256 (rounded up) 16-byte chunks of a row.
#include "hopper.cuh"

namespace ep {
namespace {

using namespace hopper;

constexpr int BM = TILE_M, THREADS = BLOCK_THREADS;
constexpr int BN = 256, BK = 64, STAGES = 3;
constexpr int STAGE_BYTES = A_STAGE_BYTES + BN * SLICE_BYTES;
// The output tile on its way out (and, for C, the residual tile on its way
// in): per consumer warpgroup four chunks of 64 rows x 64 columns, each in
// the 128-byte swizzle a TMA box has.
constexpr int CHUNK_COLS = 64, CHUNKS = BN / CHUNK_COLS;
constexpr int CHUNK_BYTES = 64 * CHUNK_COLS * 2;
constexpr int OUT_BYTES = 2 * CHUNKS * CHUNK_BYTES;
constexpr int BAR_BYTES = (2 * STAGES + 4) * 8;
constexpr int MAX_K_LN = 1280;
constexpr int ROW_CHUNKS = MAX_K_LN / 8 / 32;  // 16-byte chunks a lane holds

__host__ __device__ constexpr int smem_bytes(bool ln, int K) {
  return 1024 + STAGES * STAGE_BYTES + OUT_BYTES + BAR_BYTES +
         (ln ? 2 * K * 4 : 0);
}
static_assert(smem_bytes(true, MAX_K_LN) <= MAX_SMEM, "kernel A fits a block");

// One warp a row: mean and 1/sqrt(var + eps) in f32, the variance taken as
// the mean squared deviation. The row is read once, 16 bytes a lane and
// load, and held in registers for the second pass (K <= MAX_K_LN).
__global__ void ln_stats_kernel(const bf16* __restrict__ x,
                                float2* __restrict__ stats, int M, int K,
                                float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  unsigned v[ROW_CHUNKS][4];
#pragma unroll
  for (int c = 0; c < ROW_CHUNKS; ++c) {
    const uint4 u = (lane + 32 * c) * 8 < K ? __ldg(xr + lane + 32 * c)
                                            : zero_pack();
    v[c][0] = u.x, v[c][1] = u.y, v[c][2] = u.z, v[c][3] = u.w;
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < ROW_CHUNKS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += bf16_lo(v[c][e]) + bf16_hi(v[c][e]);
  const float mean = warp_sum(s) / (float)K;
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < ROW_CHUNKS; ++c)
    if ((lane + 32 * c) * 8 < K) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d0 = __fsub_rn(bf16_lo(v[c][e]), mean);
        const float d1 = __fsub_rn(bf16_hi(v[c][e]), mean);
        ss = __fadd_rn(ss, __fmul_rn(d0, d0));
        ss = __fadd_rn(ss, __fmul_rn(d1, d1));
      }
    }
  const float var = warp_sum(ss) / (float)K;
  if (lane == 0) stats[row] = make_float2(mean, 1.0f / sqrtf(var + eps));
}

__device__ __forceinline__ void ldmatrix_x4_u32(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// LN of the two bf16 values in `raw`, each rounded to bf16 again. No
// multiply-add is contracted: the steps round as the plain version's do.
__device__ __forceinline__ unsigned ln_pair(unsigned raw, float2 st, float2 g,
                                            float2 b) {
  return pack_bf16(
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(bf16_lo(raw), st.x), st.y), g.x), b.x),
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(bf16_hi(raw), st.x), st.y), g.y), b.y));
}

template <bool LN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_out,
            const __grid_constant__ CUtensorMap map_resid,
            const float* __restrict__ bias, const float2* __restrict__ stats,
            const float* __restrict__ gamma, const float* __restrict__ beta,
            int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* out_s = smem + STAGES * STAGE_BYTES;  // [2][CHUNKS][64][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_s + OUT_BYTES);
  const Ring ring{smem, bars, bars + STAGES, STAGES, STAGE_BYTES};
  uint64_t* resid_full = bars + 2 * STAGES;  // [2]: a warpgroup's residual landed
  uint64_t* out_free = resid_full + 2;       // [2]: its store has read the buffer
  float* gamma_s = reinterpret_cast<float*>(out_s + OUT_BYTES + BAR_BYTES);
  float* beta_s = gamma_s + K;

  const int tid = threadIdx.x;
  if (tid == 0) {
    ring_init(ring);
    for (int i = 0; i < 2; ++i) {
      mbar_init(resid_full + i, 1);
      mbar_init(out_free + i, 1);
    }
    fence_barrier_init();
  }
  if (LN)
    for (int i = tid; i < K; i += THREADS) {
      gamma_s[i] = gamma[i];
      beta_s[i] = beta[i];
    }
  __syncthreads();

  const int wg = tid >> 7;
  const int n_panels = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int nk = K / BK;

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (tid == 256) {
      RingPos pos;
      unsigned free_phase = 0;
      for (int panel = blockIdx.x; panel < n_panels; panel += gridDim.x) {
        const int m0 = panel * BM;
        for (int tile = 0; tile < n_tiles; ++tile) {
          const int n0 = tile * BN;
          if (LN) {
            produce_tile(ring, pos, &map_a, &map_w, m0, n0, 0, nk, BK,
                         STAGE_BYTES);
            continue;
          }
          // C: the residual tile follows half of the tile's slices, when the
          // store of the tile before has long read the buffer it lands in
          produce_tile(ring, pos, &map_a, &map_w, m0, n0, 0, nk / 2, BK,
                       STAGE_BYTES);
          for (int w = 0; w < 2; ++w) {
            mbar_wait(out_free + w, free_phase ^ 1);
            int chunks = 0;
            for (int c = 0; c < CHUNKS; ++c)
              chunks += m0 + w * 64 < M && n0 + c * CHUNK_COLS < N;
            mbar_expect_tx(resid_full + w, chunks * CHUNK_BYTES);
            for (int c = 0; c < chunks; ++c)
              tma_load_2d(out_s + (w * CHUNKS + c) * CHUNK_BYTES, &map_resid,
                          resid_full + w, n0 + c * CHUNK_COLS, m0 + w * 64);
          }
          free_phase ^= 1;
          produce_tile(ring, pos, &map_a, &map_w, m0, n0, nk / 2, nk, BK,
                       STAGE_BYTES);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_in_tile = wg * 64 + warp * 16;  // first of this warp's rows
  unsigned char* out_wg = out_s + wg * CHUNKS * CHUNK_BYTES;
  RingPos pos;
  unsigned resid_phase = 0;
  float acc[BN / 2];

  // This lane's share of the LN'd A fragments of one slice: for each 16-deep
  // step, rows g and g + 8 at k = 2t, 2t + 1 and 2t + 8, 2t + 9.
  float2 st0 = make_float2(0.f, 0.f), st1 = st0;
  auto load_frags = [&](unsigned (&a)[4][4], int stage, int kt) {
    const int row = row_in_tile + (lane & 15);
    const unsigned base = smem_u32(ring.a(stage)) + row * SLICE_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned raw[4];
      ldmatrix_x4_u32(raw, base + (((kk * 2 + (lane >> 4)) ^ (row & 7)) << 4));
      const int k = kt * BK + kk * 16 + 2 * t;
      const float2 g0 = *reinterpret_cast<const float2*>(gamma_s + k);
      const float2 g1 = *reinterpret_cast<const float2*>(gamma_s + k + 8);
      const float2 b0 = *reinterpret_cast<const float2*>(beta_s + k);
      const float2 b1 = *reinterpret_cast<const float2*>(beta_s + k + 8);
      a[kk][0] = ln_pair(raw[0], st0, g0, b0);
      a[kk][1] = ln_pair(raw[1], st1, g0, b0);
      a[kk][2] = ln_pair(raw[2], st0, g1, b1);
      a[kk][3] = ln_pair(raw[3], st1, g1, b1);
    }
  };
  // The slice's four products with A from registers; returns its stage.
  auto issue_rs = [&](unsigned (&a)[4][4], int kt) {
    const uint64_t db = smem_desc(ring.b(pos.stage));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs_n256(acc, a[kk], db + kk * DESC_K_STEP, (kt | kk) != 0);
    wgmma_commit();
    const int stage = pos.stage;
    pos.advance(STAGES);
    return stage;
  };

  for (int panel = blockIdx.x; panel < n_panels; panel += gridDim.x) {
    const int m0 = panel * BM;
    if (LN) {
      const int r0 = m0 + row_in_tile + g;
      st0 = r0 < M ? __ldg(stats + r0) : make_float2(0.f, 0.f);
      st1 = r0 + 8 < M ? __ldg(stats + r0 + 8) : make_float2(0.f, 0.f);
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int n0 = tile * BN;
      int prev = -1;
      if (LN) {
        unsigned a0[4][4], a1[4][4];
        mbar_wait(ring.full + pos.stage, pos.phase);
        load_frags(a0, pos.stage, 0);
        for (int kt = 0; kt < nk; kt += 2) {
          int cur = issue_rs(a0, kt);
          wgmma_wait<1>();  // slice kt-1 has retired: its stage and a1 are free
          if (prev >= 0) release(ring, prev, lane);
          prev = cur;
          if (kt + 1 < nk) {
            mbar_wait(ring.full + pos.stage, pos.phase);
            load_frags(a1, pos.stage, kt + 1);
            cur = issue_rs(a1, kt + 1);
            wgmma_wait<1>();  // slice kt has retired: a0 is free
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) keep_all(a0[kk]);
            release(ring, prev, lane);
            prev = cur;
            if (kt + 2 < nk) {
              mbar_wait(ring.full + pos.stage, pos.phase);
              load_frags(a0, pos.stage, kt + 2);
            }
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          keep_all(a0[kk]);
          keep_all(a1[kk]);
        }
      } else {
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(ring.full + pos.stage, pos.phase);
          const uint64_t da =
              smem_desc(ring.a(pos.stage) + wg * 64 * SLICE_BYTES);
          const uint64_t db = smem_desc(ring.b(pos.stage));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16_ss_n256(acc, da + kk * DESC_K_STEP, db + kk * DESC_K_STEP,
                               (kt | kk) != 0);
          wgmma_commit();
          const int cur = pos.stage;
          pos.advance(STAGES);
          wgmma_wait<1>();
          if (prev >= 0) release(ring, prev, lane);
          prev = cur;
        }
        wgmma_wait<0>();
      }
      keep_all(acc);
      release(ring, prev, lane);

      // out = bf16(acc + bias), for C bf16(f32(resid) + (acc + bias)), into
      // the warpgroup's buffer and from there to device memory by TMA, which
      // drops what lies past M or N and runs on under the next tile's loop.
      if (LN) {
        if (warp == 0 && lane == 0) bulk_wait_read();  // the tile before is out
        named_barrier(1 + wg, 128);
      } else {
        mbar_wait(resid_full + wg, resid_phase);
        resid_phase ^= 1;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float2 b = col < N ? __ldg(reinterpret_cast<const float2*>(bias + col))
                                 : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // row warp*16 + g + 8*half of the chunk, 16-byte unit j % 8 of it
          unsigned* at = reinterpret_cast<unsigned*>(
              out_wg + (j >> 3) * CHUNK_BYTES +
              (warp * 16 + g + 8 * half) * SLICE_BYTES + (((j & 7) ^ g) << 4) +
              4 * t);
          float lo = __fadd_rn(acc[4 * j + 2 * half], b.x);
          float hi = __fadd_rn(acc[4 * j + 2 * half + 1], b.y);
          if (!LN) {
            const unsigned res = *at;
            lo = __fadd_rn(bf16_lo(res), lo);
            hi = __fadd_rn(bf16_hi(res), hi);
          }
          *at = pack_bf16(lo, hi);
        }
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (warp == 0 && lane == 0) {
        if (m0 + wg * 64 < M)
          for (int c = 0; c < CHUNKS && n0 + c * CHUNK_COLS < N; ++c)
            tma_store_2d(&map_out, out_wg + c * CHUNK_BYTES, n0 + c * CHUNK_COLS,
                         m0 + wg * 64);
        bulk_commit();
        if (!LN) {
          bulk_wait_read();
          mbar_arrive(out_free + wg);
        }
      }
    }
  }
  if (warp == 0 && lane == 0) bulk_wait();
}

template <bool LN>
int launch_gemm(const bf16* a, const bf16* w, const float* b, const float2* stats,
                const float* gamma, const float* beta, const bf16* resid,
                bf16* out, int M, int N, int K, cudaStream_t s) {
  CUtensorMap map_a, map_w, map_out, map_resid;
  int rc = make_map(&map_a, a, 2, M, K, BM);
  if (rc == 0) rc = make_map(&map_w, w, 2, N, K, BN);
  if (rc == 0) rc = make_map(&map_out, out, 2, M, N, 64);
  if (rc == 0) rc = make_map(&map_resid, LN ? out : resid, 2, M, N, 64);
  if (rc != 0) return rc;
  const int smem = smem_bytes(LN, K);
  cudaFuncSetAttribute(gemm_kernel<LN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes(LN, MAX_K_LN));
  const int n_panels = (M + BM - 1) / BM;
  const int grid = n_panels < sm_count() ? n_panels : sm_count();
  gemm_kernel<LN><<<grid, THREADS, smem, s>>>(map_a, map_w, map_out, map_resid, b,
                                              stats, gamma, beta, M, N, K);
  return (int)cudaGetLastError();
}

int launch_stats(const bf16* x, float2* stats, int M, int K, float eps,
                 cudaStream_t s) {
  const int rows_per_block = 256 / 32;
  ln_stats_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0, s>>>(
      x, stats, M, K, eps);
  return (int)cudaGetLastError();
}

// ---- LN1's gradient ---------------------------------------------------------

constexpr int LN_WARPS = 8, LN_THREADS = LN_WARPS * 32;

// The 8 bf16 values of a 16-byte chunk, as f32.
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) v[2 * e] = bf16_lo(w[e]), v[2 * e + 1] = bf16_hi(w[e]);
}

// xn = bf16((f32(x) - mean) * rstd * gamma + beta): one warp a row, rows
// strided over the grid; gamma and beta held in registers.
template <int CH>
__global__ void __launch_bounds__(LN_THREADS)
ln1_apply_kernel(const bf16* __restrict__ x, const float2* __restrict__ stats,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 bf16* __restrict__ xn, int M, int K) {
  const int lane = threadIdx.x & 31;
  float2 gm[CH][4], bt[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (lane + 32 * c) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col < K) {
        gm[c][e] = __ldg(reinterpret_cast<const float2*>(gamma + col) + e);
        bt[c][e] = __ldg(reinterpret_cast<const float2*>(beta + col) + e);
      }
  }
  for (int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5); row < M;
       row += gridDim.x * LN_WARPS) {
    const float2 st = __ldg(stats + row);
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
    uint4* yr = reinterpret_cast<uint4*>(xn + (size_t)row * K);
    uint4 u[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c)
      u[c] = (lane + 32 * c) * 8 < K ? __ldg(xr + lane + 32 * c) : zero_pack();
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if ((lane + 32 * c) * 8 < K)
        yr[lane + 32 * c] = make_uint4(ln_pair(u[c].x, st, gm[c][0], bt[c][0]),
                                       ln_pair(u[c].y, st, gm[c][1], bt[c][1]),
                                       ln_pair(u[c].z, st, gm[c][2], bt[c][2]),
                                       ln_pair(u[c].w, st, gm[c][3], bt[c][3]));
  }
}

// out = bf16(f32(g) + f32(bf16(rstd * (dy - mean(dy) - xhat * mean(dy *
// xhat))))), xhat = (f32(x) - mean) * rstd, dy = f32(dxn) * gamma; and this
// block's column sums of f32(dxn) * xhat, f32(dxn) and f32(g) over its rows
// [blockIdx.x * rows, +rows) into part[blockIdx.x][3][K]. Warp w takes rows
// w, w + LN_WARPS, ... of the range; a lane owns the same columns in every
// row, so its sums stay in registers until the block adds them.
template <int CH>
__global__ void __launch_bounds__(LN_THREADS)
ln1_bwd_kernel(const bf16* __restrict__ x, const float2* __restrict__ stats,
               const float* __restrict__ gamma, const bf16* __restrict__ dxn,
               const bf16* __restrict__ g, bf16* __restrict__ out,
               float* __restrict__ part, int M, int K, int rows) {
  extern __shared__ float ln_smem[];
  float* gamma_s = ln_smem;   // [K]
  float* sums_s = ln_smem + K;  // [3][K]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < K; i += LN_THREADS) gamma_s[i] = gamma[i];
  __syncthreads();

  float sg[CH][8], sb[CH][8], sp[CH][8];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) sg[c][e] = sb[c][e] = sp[c][e] = 0.f;

  const float inv_k = 1.f / (float)K;
  const int r0 = blockIdx.x * rows, r1 = min(M, r0 + rows);
  for (int row = r0 + warp; row < r1; row += LN_WARPS) {
    const float2 st = __ldg(stats + row);
    const size_t off = (size_t)row * K / 8;
    uint4 xv[CH], dv[CH], gv[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const bool in = (lane + 32 * c) * 8 < K;
      const size_t at = off + lane + 32 * c;
      xv[c] = in ? __ldg(reinterpret_cast<const uint4*>(x) + at) : zero_pack();
      dv[c] = in ? __ldg(reinterpret_cast<const uint4*>(dxn) + at) : zero_pack();
      gv[c] = in ? __ldg(reinterpret_cast<const uint4*>(g) + at) : zero_pack();
    }
    // the row's two means (the lanes' zero-filled columns add nothing)
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (lane + 32 * c) * 8;
      if (col < K) {
        float xf[8], df[8], gf[8];
        unpack8(xv[c], xf);
        unpack8(dv[c], df);
        unpack8(gv[c], gf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = __fmul_rn(__fsub_rn(xf[e], st.x), st.y);
          const float dy = __fmul_rn(df[e], gamma_s[col + e]);
          s1 += dy;
          s2 += dy * xh;
          sg[c][e] += df[e] * xh;
          sb[c][e] += df[e];
          sp[c][e] += gf[e];
        }
      }
    }
    const float m1 = warp_sum(s1) * inv_k, m2 = warp_sum(s2) * inv_k;
    uint4* orow = reinterpret_cast<uint4*>(out) + off;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (lane + 32 * c) * 8;
      if (col < K) {
        float xf[8], df[8], gf[8];
        unpack8(xv[c], xf);
        unpack8(dv[c], df);
        unpack8(gv[c], gf);
        unsigned w[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float o[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float xh = __fmul_rn(__fsub_rn(xf[e + h], st.x), st.y);
            const float dy = __fmul_rn(df[e + h], gamma_s[col + e + h]);
            const float dx = __fmul_rn(
                st.y, __fsub_rn(__fsub_rn(dy, m1), __fmul_rn(xh, m2)));
            o[h] = __fadd_rn(gf[e + h],
                             __bfloat162float(__float2bfloat16_rn(dx)));
          }
          w[e / 2] = pack_bf16(o[0], o[1]);
        }
        orow[lane + 32 * c] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  // the warps' sums into the block's, warp 0 first, then to part
  for (int w = 0; w < LN_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = (lane + 32 * c) * 8;
        if (col < K)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float* s = sums_s + col + e;
            s[0] = w ? s[0] + sg[c][e] : sg[c][e];
            s[K] = w ? s[K] + sb[c][e] : sb[c][e];
            s[2 * K] = w ? s[2 * K] + sp[c][e] : sp[c][e];
          }
      }
    }
    __syncthreads();
  }
  float* p = part + (size_t)blockIdx.x * 3 * K;
  for (int i = threadIdx.x; i < 3 * K; i += LN_THREADS) p[i] = sums_s[i];
}

// sums[j] = part[0][j] + part[1][j] + ... over the blocks, in a fixed order:
// eight strands a column, then the strands in order.
__global__ void ln1_bwd_finish_kernel(const float* __restrict__ part,
                                      float* __restrict__ sums, int blocks,
                                      int n) {
  __shared__ float s[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (j < n)
    for (int b = threadIdx.y; b < blocks; b += 8) v += part[(size_t)b * n + j];
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
#pragma unroll
    for (int y = 1; y < 8; ++y) v += s[y][threadIdx.x];
    sums[j] = v;
  }
}

inline int ln_chunks(int K) { return (K + 255) / 256; }
inline int ln_bwd_smem(int K) { return 4 * K * (int)sizeof(float); }

// Blocks of 8 warps for M rows, one wave: as many as the card holds at once,
// fewer where rows run short.
template <typename Kernel>
int one_wave(Kernel kernel, int smem, int M) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LN_THREADS,
                                                smem);
  const int most = (per_sm > 0 ? per_sm : 1) * sm_count();
  const int need = (M + LN_WARPS - 1) / LN_WARPS;
  return need < most ? (need > 0 ? need : 1) : most;
}

// ln1_bwd's blocks, each a contiguous range of rows.
template <int CH>
int ln1_bwd_grid(int M, int K) {
  return one_wave(ln1_bwd_kernel<CH>, ln_bwd_smem(K), M);
}

template <int CH>
int launch_ln1_apply(const bf16* x, const float2* stats, const float* gamma,
                     const float* beta, bf16* xn, int M, int K, cudaStream_t s) {
  ln1_apply_kernel<CH><<<one_wave(ln1_apply_kernel<CH>, 0, M), LN_THREADS, 0,
                         s>>>(x, stats, gamma, beta, xn, M, K);
  return (int)cudaGetLastError();
}

template <int CH>
int launch_ln1_bwd(const bf16* x, const float2* stats, const float* gamma,
                   const bf16* dxn, const bf16* g, bf16* out, float* part,
                   float* sums, int M, int K, cudaStream_t s) {
  const int grid = ln1_bwd_grid<CH>(M, K);
  const int rows = (M + grid - 1) / grid;
  ln1_bwd_kernel<CH><<<grid, LN_THREADS, ln_bwd_smem(K), s>>>(
      x, stats, gamma, dxn, g, out, part, M, K, rows);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ln1_bwd_finish_kernel<<<(3 * K + 31) / 32, dim3(32, 8), 0, s>>>(part, sums,
                                                                  grid, 3 * K);
  return (int)cudaGetLastError();
}

// One instance a chunk count: K <= 256 * CH.
#define EP_LN_DISPATCH(K, FN, ...)                  \
  switch (ln_chunks(K)) {                           \
    case 1: return FN<1>(__VA_ARGS__);              \
    case 2: return FN<2>(__VA_ARGS__);              \
    case 3: return FN<3>(__VA_ARGS__);              \
    case 4: return FN<4>(__VA_ARGS__);              \
    case 5: return FN<5>(__VA_ARGS__);              \
    default: return (int)cudaErrorInvalidValue;     \
  }

}  // namespace
}  // namespace ep

// LN1's output from kernel A's statistics: x (M, K) bf16, stats (M, 2) f32,
// gamma, beta (K) f32 -> xn (M, K) bf16.
EP_EXPORT int ep_ln1_apply(const void* x, const void* stats, const void* gamma,
                           const void* beta, void* xn, int M, int K,
                           void* stream) {
  using namespace ep;
  const bf16* xp = static_cast<const bf16*>(x);
  const float2* sp = static_cast<const float2*>(stats);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  bf16* yp = static_cast<bf16*>(xn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EP_LN_DISPATCH(K, launch_ln1_apply, xp, sp, gp, bp, yp, M, K, s)
}

// The number of blocks ep_ln1_bwd runs for M rows of K: its scratch holds
// that many times 3 * K floats.
EP_EXPORT int ep_ln1_bwd_blocks(int M, int K) {
  using namespace ep;
  EP_LN_DISPATCH(K, ln1_bwd_grid, M, K)
}

// LN1's backward with the residual: x, dxn, g (M, K) bf16, stats (M, 2),
// gamma (K) f32 -> out (M, K) bf16 = g + dx; sums (3, K) f32 = gamma's,
// beta's and the projection bias's gradients; part: f32 scratch of
// ep_ln1_bwd_blocks(M, K) * 3 * K.
EP_EXPORT int ep_ln1_bwd(const void* x, const void* stats, const void* gamma,
                         const void* dxn, const void* g, void* out, void* part,
                         void* sums, int M, int K, void* stream) {
  using namespace ep;
  const bf16* xp = static_cast<const bf16*>(x);
  const float2* sp = static_cast<const float2*>(stats);
  const float* gp = static_cast<const float*>(gamma);
  const bf16* dp = static_cast<const bf16*>(dxn);
  const bf16* rp = static_cast<const bf16*>(g);
  bf16* op = static_cast<bf16*>(out);
  float* pp = static_cast<float*>(part);
  float* up = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EP_LN_DISPATCH(K, launch_ln1_bwd, xp, sp, gp, dp, rp, op, pp, up, M, K, s)
}

// The row statistics of kernel A alone: x (M, K) bf16 -> stats (M, 2) f32,
// (mean, 1/sqrt(var + eps)) a row.
EP_EXPORT int ep_ln_row_stats(const void* x, void* stats, int M, int K,
                              float eps, void* stream) {
  using namespace ep;
  return launch_stats(static_cast<const bf16*>(x), static_cast<float2*>(stats),
                      M, K, eps, static_cast<cudaStream_t>(stream));
}

// Kernel A. x (M, K), w (N, K) bf16; b (N), gamma, beta (K) f32; stats: f32
// scratch of 2*M -> out (M, N).
EP_EXPORT int ep_ln_qkv_gemm(const void* x, const void* w, const void* b,
                             const void* gamma, const void* beta, void* stats,
                             void* out, int M, int N, int K, float eps,
                             void* stream) {
  using namespace ep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_stats(static_cast<const bf16*>(x),
                              static_cast<float2*>(stats), M, K, eps, s);
  if (rc != 0) return rc;
  return launch_gemm<true>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const float2*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), nullptr,
      static_cast<bf16*>(out), M, N, K, s);
}

// Kernel C. o (M, K), w (N, K), b f32, resid (M, N) -> out (M, N).
EP_EXPORT int ep_proj_residual_gemm(const void* o, const void* w, const void* b,
                                    const void* resid, void* out, int M, int N,
                                    int K, void* stream) {
  using namespace ep;
  return launch_gemm<false>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(w),
      static_cast<const float*>(b), nullptr, nullptr, nullptr,
      static_cast<const bf16*>(resid), static_cast<bf16*>(out), M, N, K,
      static_cast<cudaStream_t>(stream));
}

EP_EXPORT const char* ep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
