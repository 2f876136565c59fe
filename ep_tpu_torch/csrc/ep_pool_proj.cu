// Kernel G (ep_pool_proj): the Efficient Probing pool with the value
// projection inside.
//   logits[q, n] = q_scaled[q] . x[n]                   (f32 from bf16)
//   p = bf16(softmax_n(logits))                          (f32 max, exp, sum)
//   v[n, j]     = bf16(sum_c x[n, c] * W[j, c])          (f32 sum)
//   out[q, k]   = bf16(sum_n p[q, n] * v[n, q*cq + k])   (f32 sum)
// Only q_scaled, x, W and out touch device memory: neither the projected
// values (B, N, Q*cq) nor the probabilities are written.
//
// Replaces: ep_tpu/ops/pool_attn_pallas.py::_ep_fused_kernel
//   (ep_pool_proj_attend), with its rounding points. The TPU kernel multiplies
//   p by the whole projection and keeps the block diagonal; here the product
//   with p is the projection's epilogue: each v element is weighted by p of
//   its column's query and summed over the tokens, so any cq works. W is
//   nn.Linear's (Q*cq, C) weight, K-major like the tokens.
//
// Bound on this card: operations. The projection is 2*B*N*C*QC: 215 GFLOP at
//   ViT-H/14, 448 px, batch 64 (N=1024, C=QC=1280), 0.217 ms at 989 TFLOP/s,
//   against 168 MB of tokens (0.050 ms); the logits add Q/QC of it. The
//   product stays whole: (p @ x) @ W^T would be 40 times less work but drops
//   v's rounding point.
//
// Design: the main loop of hopper.cuh, a cluster of blocks an image.
//   * Block `rank` takes `panels` consecutive panels of 128 tokens
//     (ops/pool_attn.py::ep_pool_proj_tiling: 2 blocks at N=196 and 256, 8 at
//     N=1024, at most 16). A block is a TMA producer warp and two consumer
//     warpgroups. For each panel it walks W's QC rows in tiles of 256; each
//     tile is a loop over 64-deep K slices of W's rows and of the panel (a
//     3-D map with the image as depth: tokens past N read as zero, never the
//     next image's) through a 3-stage ring. The product is v^T: a warpgroup
//     takes 128 of the tile's rows of W as wgmma's M (two m64n128k16, the
//     panel's tokens as N), 128 f32 accumulators a thread. The panel's
//     re-reads for the later tiles come from L2.
//   * The first tile's slices also bring the query bank's (padded by TMA's
//     zero fill to QN = 8, 16, 32 or 64 rows), and the same loop issues
//     logits^T (a warpgroup's 64 tokens x QN, wgmma m64nQNk16) beside the
//     projection.
//   * The softmax across the cluster, after the first tile: each block's
//     per-query max goes into every peer's shared memory (distributed shared
//     memory), a cluster barrier, the global max; then the sums of
//     exp(l - max) the same way, added in rank order. p = bf16(exp(l - max) /
//     sum), a true division, stays in shared memory for the panel's tiles;
//     tokens past N get p = 0.
//   * The pool in the epilogue: a thread holds 4 rows j of v^T, each at 32 of
//     the panel's tokens, so each row has one query (j / cq), found once a
//     tile. It rounds each value to bf16 (v), weights it by p of the token
//     and sums along the row; two shuffles add the 4 lanes of a row, and the
//     row's sum goes into the block's f32 partial sum of column j. No barrier:
//     the warps run on into the next tile independently. (With the tokens as
//     M instead, each thread held 64 columns of two tokens: a query lookup
//     for every value and a reduction across lanes and warps made the
//     epilogue a third of the kernel's time.)
//   * After the last tile a cluster barrier, and each block sums its share of
//     the columns over the ranks' partial sums in rank order, rounds once and
//     stores. No atomics: two calls agree bit for bit.
//   * Past 16 panels (N > 2048) a block takes several. It then computes its
//     panels' logits in two passes of their own (the max, then the sums) and
//     again in each panel's first tile, where p is made: the same products in
//     the same order give the same logits, and shared memory does not grow
//     with N.
//   The producer thread meets the cluster's barriers like everyone, after
//   the loads that precede each one, so it never waits on a barrier that
//   needs slices it has not issued.
#include "hopper.cuh"

namespace ep {
namespace {

using namespace hopper;

constexpr int BT = TILE_M;                      // tokens a panel
constexpr int BJ = 256;                         // rows of W (columns of v) a tile
constexpr int STAGES = 3;
constexpr int MAX_CLUSTER = 16;
constexpr int THREADS = BLOCK_THREADS;
constexpr int CONSUMERS = 256;                  // two warpgroups
constexpr int X_BYTES = BT * SLICE_BYTES;       // the panel's slice
constexpr int W_BYTES = BJ * SLICE_BYTES;       // W's rows of the tile
// p as bf16 [Q][P_STRIDE], a panel's tokens in order: 68 words a query, so
// the 8 row lanes of a warp, whose queries may differ, read 8 bank groups
constexpr int P_STRIDE = BT + 8;

__host__ __device__ constexpr int query_rows(int Q) {
  return Q <= 8 ? 8 : Q <= 16 ? 16 : Q <= 32 ? 32 : 64;
}
__host__ __device__ constexpr int stage_bytes(int qn) {
  return X_BYTES + W_BYTES + qn * SLICE_BYTES;
}

// Byte offsets from the 1024-aligned base of the block's shared memory
// (ops/pool_attn.py::ep_pool_proj_smem_bytes computes the same).
struct Layout {
  int p, wred, partial, xmax, xsum, stat, bars, bytes;
};
__host__ __device__ constexpr Layout layout(int Q, int QC, int CL) {
  const int qn = query_rows(Q);
  const int p = STAGES * stage_bytes(qn);          // [Q][P_STRIDE] bf16
  const int wred = p + Q * P_STRIDE * 2;           // [8][qn] f32
  const int partial = wred + 8 * qn * 4;           // [QC] f32
  const int xmax = partial + (QC + 3) / 4 * 16;    // [CL][qn]
  const int xsum = xmax + CL * qn * 4;             // [CL][qn]
  const int stat = xsum + CL * qn * 4;             // [2][qn]: max, sum
  const int bars = stat + 2 * qn * 4;              // [2][STAGES]
  return Layout{p, wred, partial, xmax, xsum, stat, bars,
                1024 + bars + 2 * STAGES * 8};
}

// The K loop of one tile of a panel. With PROJ, v^T: the warpgroup's 128 of
// the tile's rows of W (two wgmma M of 64, acc[m]) times the panel's 128
// tokens; with LOGITS, logits^T: the warpgroup's 64 tokens times the query
// bank (lacc).
template <int QN, bool PROJ, bool LOGITS>
__device__ __forceinline__ void k_loop(const Ring& ring, RingPos& pos, int nk,
                                       int wg, int lane,
                                       float (&acc)[2][BT / 2],
                                       float (&lacc)[QN / 2]) {
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(ring.full + pos.stage, pos.phase);
    const unsigned char* s = ring.a(pos.stage);
    const uint64_t dx = smem_desc(s);
    const uint64_t dxl = smem_desc(s + wg * 64 * SLICE_BYTES);
    const uint64_t dw0 = smem_desc(s + X_BYTES + wg * 128 * SLICE_BYTES);
    const uint64_t dw1 = smem_desc(s + X_BYTES + (wg * 128 + 64) * SLICE_BYTES);
    const uint64_t dq = smem_desc(s + X_BYTES + W_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (PROJ) {
        wgmma_bf16_ss_n128(acc[0], dw0 + kk * DESC_K_STEP, dx + kk * DESC_K_STEP,
                           (kt | kk) != 0);
        wgmma_bf16_ss_n128(acc[1], dw1 + kk * DESC_K_STEP, dx + kk * DESC_K_STEP,
                           (kt | kk) != 0);
      }
      if (LOGITS)
        wgmma_ss<0>(lacc, dxl + kk * DESC_K_STEP, dq + kk * DESC_K_STEP,
                    (kt | kk) != 0);
    }
    wgmma_commit();
    const int cur = pos.stage;
    pos.advance(STAGES);
    wgmma_wait<1>();
    if (prev >= 0) release(ring, prev, lane);
    prev = cur;
  }
  wgmma_wait<0>();
  if (PROJ) {
    keep_all(acc[0]);
    keep_all(acc[1]);
  }
  if (LOGITS) keep_all(lacc);
  release(ring, prev, lane);
}

// The block's value for each query column of `v` (this thread's part: index
// 2*jj + e is query 8*jj + 2*t + e) reduced over the 8 row lanes of each warp
// and the 8 warps, max or sum in a fixed order; then, after the cluster
// barrier that the caller's peers meet as well, over the cluster into
// stat[q]: the max, or the sum in rank order. `xchg` is [CL][QN].
template <int QN, bool MAX>
__device__ __forceinline__ void cluster_reduce(float (&v)[QN / 4], float* wred,
                                               float* xchg, float* stat,
                                               unsigned rank, int CL, int tid,
                                               int lane) {
  const int wid = tid >> 5, t = lane & 3;
#pragma unroll
  for (int i = 0; i < QN / 4; ++i) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v[i], o);
      v[i] = MAX ? fmaxf(v[i], u) : v[i] + u;
    }
    if (lane < 4) wred[wid * QN + 8 * (i >> 1) + 2 * t + (i & 1)] = v[i];
  }
  named_barrier(1, CONSUMERS);
  if (tid < QN) {
    float r = wred[tid];
    for (int w = 1; w < 8; ++w)
      r = MAX ? fmaxf(r, wred[w * QN + tid]) : r + wred[w * QN + tid];
    for (int peer = 0; peer < CL; ++peer)
      st_cluster(cluster_addr(xchg + rank * QN + tid, peer), r);
  }
  cluster_arrive();
  cluster_wait();
  if (tid < QN) {
    float r = xchg[tid];
    for (int peer = 1; peer < CL; ++peer)
      r = MAX ? fmaxf(r, xchg[peer * QN + tid]) : r + xchg[peer * QN + tid];
    stat[tid] = r;
  }
  named_barrier(1, CONSUMERS);
}

// One tile's pool. The thread holds, of each of its rows j of v^T (n0 + the
// warpgroup's 128 + 64m + 16*warp + g + 8h), the panel's tokens 8jj + 2t and
// + 1: it rounds them to bf16 (v), weights them by p of the row's query
// (j / cq) and of the token, and sums them; the 4 lanes of a row add their
// sums, and lane 0 adds the row's into partial[j] (assigned on the block's
// first panel). Fixed order, no barrier: the warps run on independently.
// (Nothing but wgmma writes acc: ptxas serialises every wgmma of a kernel
// whose accumulators other instructions define, C7515.)
__device__ __forceinline__ void pool_epilogue(
    const float (&acc)[2][BT / 2], const unsigned char* p_s, float* partial, int n0,
    int QC, int Q, int cq, int wg, int warp, int lane, bool first) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = n0 + wg * 128 + m * 64 + warp * 16 + g + 8 * h;
      // past QC the row of W reads as zero, and q stays in range
      const unsigned char* pr = p_s + (min(j / cq, Q - 1) * P_STRIDE + 2 * t) * 2;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BT / 8; ++jj) {
        const unsigned pp = *reinterpret_cast<const unsigned*>(pr + jj * 16);
        const unsigned v =
            pack_bf16(acc[m][4 * jj + 2 * h], acc[m][4 * jj + 2 * h + 1]);
        sum = fmaf(bf16_hi(pp), bf16_hi(v), fmaf(bf16_lo(pp), bf16_lo(v), sum));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (t == 0 && j < QC) partial[j] = first ? sum : partial[j] + sum;
    }
}

// One cluster (CL blocks along x) an image; block `rank` takes panels
// rank*panels .. of the image's ceil(N / 128), at least one of them.
template <int QN>
__global__ void __launch_bounds__(THREADS, 1)
ep_pool_proj_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_q,
                    bf16* __restrict__ out, int out_stride, int N, int C, int Q,
                    int cq, int CL, int panels) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int QC = Q * cq;
  const Layout L = layout(Q, QC, CL);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const Ring ring{smem, bars, bars + STAGES, STAGES, stage_bytes(QN)};
  unsigned char* p_s = smem + L.p;
  float* wred = reinterpret_cast<float*>(smem + L.wred);
  float* partial = reinterpret_cast<float*>(smem + L.partial);
  float* xmax = reinterpret_cast<float*>(smem + L.xmax);
  float* xsum = reinterpret_cast<float*>(smem + L.xsum);
  float* stat_m = reinterpret_cast<float*>(smem + L.stat);
  float* stat_s = stat_m + QN;

  const int tid = threadIdx.x;
  const unsigned rank = cluster_rank();
  const int b = blockIdx.x / CL;
  const int first_panel = (int)rank * panels;
  const int my_panels = min(panels, (N + BT - 1) / BT - first_panel);
  const int nk = (C + 63) / 64;
  const int n_tiles = (QC + BJ - 1) / BJ;
  const bool multi = panels > 1;

  if (tid == 0) ring_init(ring);
  __syncthreads();
  // every peer has started before a block writes into its shared memory (the
  // wait comes before the first exchange)
  cluster_arrive();

  if (tid >= CONSUMERS) {
    setmaxnreg_dec<40>();
    RingPos pos;
    // the slices of one tile: tokens with W's rows (PROJ), the query bank's
    // (LOGITS) or both
    auto tile = [&](int panel, int n0, bool proj, bool logits) {
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(ring.empty + pos.stage, pos.phase ^ 1);
        unsigned char* s = ring.a(pos.stage);
        uint64_t* full = ring.full + pos.stage;
        mbar_expect_tx(full, X_BYTES + (proj ? W_BYTES : 0) +
                                 (logits ? QN * SLICE_BYTES : 0));
        tma_load_3d(s, &map_x, full, kt * 64, (first_panel + panel) * BT, b);
        if (proj) tma_load_2d(s + X_BYTES, &map_w, full, kt * 64, n0);
        if (logits)
          tma_load_2d(s + X_BYTES + W_BYTES, &map_q, full, kt * 64, 0);
        pos.advance(STAGES);
      }
    };
    // three stretches of loads, each followed by the cluster barrier the
    // consumers meet after them: the max exchange, the sum exchange and the
    // partial sums (the first two both follow the first tile of one panel)
    for (int stretch = 0; stretch < 3; ++stretch) {
      if (tid == CONSUMERS) {
        if (multi) {
          for (int panel = 0; panel < my_panels; ++panel) {
            if (stretch < 2) {
              tile(panel, 0, false, true);
            } else {
              for (int n = 0; n < n_tiles; ++n)
                tile(panel, n * BJ, true, n == 0);
            }
          }
        } else if (stretch == 0) {
          tile(0, 0, true, true);
        } else if (stretch == 2) {
          for (int n = 1; n < n_tiles; ++n) tile(0, n * BJ, true, false);
        }
      }
      __syncwarp();
      cluster_wait();
      cluster_arrive();
    }
    cluster_wait();
    cluster_arrive();  // the exit barrier
    cluster_wait();
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;  // this thread's tokens r0, r0 + 8
  RingPos pos;
  float acc[2][BT / 2];
  float lacc[QN / 2];  // 4*jj + 2*h + e: token r0 + 8*h, query 8*jj + 2*t + e
  float colv[QN / 4];  // this thread's max or sum a query column: 2*jj + e

  // rows of panel `panel` that lie before N
  auto valid_rows = [&](int panel) { return N - (first_panel + panel) * BT; };

  if (multi) {
    // the max and then the sums over all of the block's panels
#pragma unroll
    for (int i = 0; i < QN / 4; ++i) colv[i] = -INFINITY;
    for (int panel = 0; panel < my_panels; ++panel) {
      k_loop<QN, false, true>(ring, pos, nk, wg, lane, acc, lacc);
      const int valid = valid_rows(panel);
#pragma unroll
      for (int i = 0; i < QN / 2; ++i)
        if (r0 + 8 * ((i >> 1) & 1) < valid)
          colv[2 * (i >> 2) + (i & 1)] = fmaxf(colv[2 * (i >> 2) + (i & 1)],
                                               lacc[i]);
    }
    cluster_wait();
    cluster_reduce<QN, true>(colv, wred, xmax, stat_m, rank, CL, tid, lane);
#pragma unroll
    for (int i = 0; i < QN / 4; ++i) colv[i] = 0.f;
    for (int panel = 0; panel < my_panels; ++panel) {
      k_loop<QN, false, true>(ring, pos, nk, wg, lane, acc, lacc);
      const int valid = valid_rows(panel);
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) {
        const int c = 2 * (i >> 2) + (i & 1);
        if (r0 + 8 * ((i >> 1) & 1) < valid)
          colv[c] += expf(lacc[i] - stat_m[8 * (i >> 2) + 2 * t + (i & 1)]);
      }
    }
    cluster_reduce<QN, false>(colv, wred, xsum, stat_s, rank, CL, tid, lane);
  }

  for (int panel = 0; panel < my_panels; ++panel) {
    const int valid = valid_rows(panel);
    k_loop<QN, true, true>(ring, pos, nk, wg, lane, acc, lacc);
    if (!multi) {
#pragma unroll
      for (int i = 0; i < QN / 4; ++i) colv[i] = -INFINITY;
#pragma unroll
      for (int i = 0; i < QN / 2; ++i)
        if (r0 + 8 * ((i >> 1) & 1) < valid)
          colv[2 * (i >> 2) + (i & 1)] = fmaxf(colv[2 * (i >> 2) + (i & 1)],
                                               lacc[i]);
      cluster_wait();
      cluster_reduce<QN, true>(colv, wred, xmax, stat_m, rank, CL, tid, lane);
    }
    // e = exp(l - max), zero past N (beside lacc: only wgmma writes that)
    float ev[QN / 2];
#pragma unroll
    for (int i = 0; i < QN / 2; ++i)
      ev[i] = r0 + 8 * ((i >> 1) & 1) < valid
                  ? expf(lacc[i] - stat_m[8 * (i >> 2) + 2 * t + (i & 1)])
                  : 0.f;
    if (!multi) {
#pragma unroll
      for (int i = 0; i < QN / 4; ++i)
        colv[i] = ev[4 * (i >> 1) + (i & 1)] + ev[4 * (i >> 1) + 2 + (i & 1)];
      cluster_reduce<QN, false>(colv, wred, xsum, stat_s, rank, CL, tid, lane);
    }
    // p = bf16(e / sum), once every warp's epilogue has read the panel before's
    named_barrier(1, CONSUMERS);
    bf16* p16 = reinterpret_cast<bf16*>(p_s);
#pragma unroll
    for (int jj = 0; jj < QN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * jj + 2 * t + e;
        if (q < Q) {
          const float s = stat_s[q];
          p16[q * P_STRIDE + r0] = __float2bfloat16_rn(__fdiv_rn(ev[4 * jj + e], s));
          p16[q * P_STRIDE + r0 + 8] =
              __float2bfloat16_rn(__fdiv_rn(ev[4 * jj + 2 + e], s));
        }
      }
    named_barrier(1, CONSUMERS);  // p of all 128 tokens is in
    pool_epilogue(acc, p_s, partial, 0, QC, Q, cq, wg, warp, lane, panel == 0);
    for (int n = 1; n < n_tiles; ++n) {
      k_loop<QN, true, false>(ring, pos, nk, wg, lane, acc, lacc);
      pool_epilogue(acc, p_s, partial, n * BJ, QC, Q, cq, wg, warp, lane,
                    panel == 0);
    }
  }

  // the partial sums of the cluster, in rank order
  cluster_arrive();
  cluster_wait();
  for (int j = (int)rank * CONSUMERS + tid; j < QC; j += CL * CONSUMERS) {
    float total = ld_cluster(cluster_addr(partial + j, 0));
    for (int r = 1; r < CL; ++r)
      total += ld_cluster(cluster_addr(partial + j, r));
    out[(size_t)b * out_stride + j] = __float2bfloat16_rn(total);
  }
  // no block leaves while a peer reads its partial sums
  cluster_arrive();
  cluster_wait();
}

// Map of the (B, N, C) bf16 tokens at ptr, rows C and images `image_stride`
// elements apart, with boxes of 128 rows x 64 channels in the 128-byte
// swizzle and zero fill past N and C. Returns 0 or a cudaError_t.
int make_token_map(CUtensorMap* map, const void* ptr, int B, int N, int C,
                   long long image_stride) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2,
                                 (cuuint64_t)image_stride * 2};
  const cuuint32_t box[3] = {64, BT, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box,
                         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The launch's configuration but its grid, after setting the kernel's
// attributes for it.
template <int QN>
cudaLaunchConfig_t configure(int Q, int QC, int CL, cudaLaunchAttribute* attr,
                             cudaStream_t stream) {
  const int smem = layout(Q, QC, CL).bytes;
  cudaFuncSetAttribute(ep_pool_proj_kernel<QN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (CL > 8)
    cudaFuncSetAttribute(ep_pool_proj_kernel<QN>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int QN>
int resident_clusters(int Q, int QC, int CL) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = configure<QN>(Q, QC, CL, &attr, 0);
  cfg.gridDim = dim3(CL * sm_count());
  int n = 0;
  const cudaError_t rc =
      cudaOccupancyMaxActiveClusters(&n, ep_pool_proj_kernel<QN>, &cfg);
  return rc == cudaSuccess ? n : -(int)rc;
}

template <int QN>
int launch(const bf16* q, const bf16* x, const bf16* w, bf16* out, int B,
           int N, int C, int Q, int cq, int x_bstride, int out_stride, int CL,
           int panels, cudaStream_t stream) {
  const int QC = Q * cq;
  CUtensorMap map_x, map_w, map_q;
  int rc = make_token_map(&map_x, x, B, N, C, x_bstride);
  if (rc == 0) rc = make_map(&map_w, w, 2, QC, C, BJ);
  if (rc == 0) rc = make_map(&map_q, q, 2, Q, C, QN);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = configure<QN>(Q, QC, CL, &attr, stream);
  cfg.gridDim = dim3(B * CL);
  rc = (int)cudaLaunchKernelEx(&cfg, ep_pool_proj_kernel<QN>, map_x, map_w,
                               map_q, out, out_stride, N, C, Q, cq, CL,
                               panels);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace
}  // namespace ep

// Shared memory of one block for Q queries, Q*cq = QC value columns and a
// cluster of `cluster` blocks (ops/pool_attn.py::ep_pool_proj_smem_bytes
// computes the same); it does not depend on N.
EP_EXPORT int ep_pool_proj_smem_bytes(int Q, int QC, int cluster) {
  return ep::layout(Q, QC, cluster).bytes;
}

// Clusters of `cluster` blocks that the card holds at once (a negative
// cudaError_t where the query fails).
EP_EXPORT int ep_pool_proj_resident_clusters(int Q, int QC, int cluster) {
  using namespace ep;
  if (Q < 1 || Q > 64 || cluster < 1 || cluster > MAX_CLUSTER)
    return -(int)cudaErrorInvalidValue;
  return Q <= 8    ? resident_clusters<8>(Q, QC, cluster)
         : Q <= 16 ? resident_clusters<16>(Q, QC, cluster)
         : Q <= 32 ? resident_clusters<32>(Q, QC, cluster)
                   : resident_clusters<64>(Q, QC, cluster);
}

// q_scaled (Q, C), tokens (B, N, C), w (Q*cq, C), all bf16 -> out (B, Q*cq).
// The tokens' rows are contiguous; images are x_bstride elements apart, so the
// patch tokens can be a view that skips the [CLS] row. out's images are
// out_stride elements apart, so that a bank of more than 64 queries runs as
// groups of at most 64, each launch on its group's rows of q_scaled and w and
// its columns of out (ops/pool_attn.py::query_groups). A cluster of `cluster`
// blocks an image, `panels` panels of 128 tokens a block
// (ops/pool_attn.py::ep_pool_proj_tiling).
EP_EXPORT int ep_pool_proj(const void* q, const void* x, const void* w,
                           void* out, int B, int N, int C, int Q, int cq,
                           int x_bstride, int out_stride, int cluster,
                           int panels, void* stream) {
  using namespace ep;
  const int span = panels * BT;  // tokens a block
  if (B < 1 || N < 1 || Q < 1 || Q > 64 || cq < 1 || C % 8 || (Q * cq) % 8 ||
      x_bstride % 8 || out_stride < Q * cq || cluster < 1 ||
      cluster > MAX_CLUSTER || panels < 1 ||
      cluster * span < N || (cluster - 1) * span >= N ||
      layout(Q, Q * cq, cluster).bytes > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const auto fn = Q <= 8 ? launch<8> : Q <= 16 ? launch<16>
                : Q <= 32 ? launch<32> : launch<64>;
  return fn(static_cast<const bf16*>(q), static_cast<const bf16*>(x),
            static_cast<const bf16*>(w), static_cast<bf16*>(out), B, N, C, Q,
            cq, x_bstride, out_stride, cluster, panels,
            static_cast<cudaStream_t>(stream));
}
