// Kernel D (ep_pool): the Efficient Probing pool.
//   logits[q, n] = q_scaled[q] . tokens[n]             (f32)
//   p = softmax_n(logits), rounded to bf16
//   out[q, c]   = sum_n p[q, n] * v[n, q*cq + c]        (f32 sum, one bf16 rounding)
//
// Replaces: ep_tpu/ops/pool_attn_pallas.py::_ep_kernel (ep_pool_attend), and
//   computes as it does: both products on the matrix unit, the value
//   contraction as the full (Q, tokens) @ (tokens, Q*cq) product of which the
//   block diagonal is kept. At Q <= 64 the columns thrown away cost the
//   tensor cores almost nothing, and what bounds the kernel is its bytes.
//
// Bound on this card: bytes. The pool reads every token and every projected
// value once (2 * B * N * C bytes each in bf16 at d_out = 1: 154 MB each at
// ViT-B, batch 512) for 2 * B * N * Q * C useful operations, about 32 a byte.
//
// Design: a cluster of blocks per image splits its tokens into tiles of 64
//   (wgmma's M), `tiles` consecutive tiles a block (ops/pool_attn.py::
//   ep_pool_tiling picks the cluster size and the tiles; 4 blocks of one tile
//   at N=196 and N=256, 16 at N=1024), so that every shape puts enough blocks
//   on the card and no token is read twice. A block is one warpgroup; its
//   thread 0 keeps a ring of STAGES TMA loads in flight over the block's
//   items, in this order: for each tile, 128-byte slices of C (64 tokens x 64
//   channels by a 3-D map over the patch-token view, zero past N, with the
//   matching slice of the query bank, zero past Q), then for each tile the
//   v boxes of 64 tokens x 64 columns, so the first values land while the
//   softmax runs.
//   1. logits^T (64 tokens x QN queries, QN = 8, 16, 32 or 64 >= Q) by wgmma
//      m64nQNk16 from shared memory, f32 accumulators, into shared memory.
//   2. The softmax over all N tokens of the image, across the cluster: each
//      block's per-query max goes into every peer's shared memory
//      (distributed shared memory), a cluster barrier, the global max; then
//      the per-query sums of exp(l - max) the same way, summed in rank order,
//      so every block holds the same max and sum. p = bf16(exp(l - max) / sum)
//      with a true division: the rounding point of the TPU kernel, which an
//      online softmax would move.
//   3. p (the query rows, 64 tokens deep, in the 128-byte swizzle) times each
//      v box by wgmma m64n64k16, v read N-major (the transpose bit); the
//      thread that holds (query r, column j) with j / cq == r adds it to the
//      block's f32 partial sum of column j.
//   4. A cluster barrier; each block sums its share of the columns over the
//      ranks' partial sums in rank order (distributed shared memory), rounds
//      to bf16 once and stores. No atomics: two calls agree bit for bit.
//   What holds it back is the time a block spends off its loads (the
//   exchanges, the products, the barriers), not the depth of its ring: on an
//   H100 a ring of 2 slots with 5 blocks an SM beat 4 slots with 3 and 8
//   with 1. So the block keeps its shared memory small: the exchange arrays
//   are sized by the cluster, and a tile's p holds only its query rows (the
//   64 rows wgmma reads run on into what follows, and give output rows that
//   no column keeps).
#include "hopper.cuh"

namespace ep {
namespace {

using namespace hopper;

constexpr int TN = 64;                            // tokens a tile
constexpr int TILE_BYTES = TN * SLICE_BYTES;      // 64 rows x 128 bytes
constexpr int STAGES = 2;
constexpr int MAX_CLUSTER = 16;
constexpr int THREADS = 128;                      // one warpgroup

__host__ __device__ constexpr int query_rows(int Q) {
  return Q <= 8 ? 8 : Q <= 16 ? 16 : Q <= 32 ? 32 : 64;
}
__host__ __device__ constexpr int slot_bytes(int qn) {
  return TILE_BYTES + qn * SLICE_BYTES;
}
// f32 logits a query row: padded so that the 4 lanes of a quad (2 queries
// apart) and its 8 groups (one token apart) write 32 different banks
__host__ __device__ constexpr int logits_stride(int tiles) {
  return tiles * TN + 4;
}

// Rows of p a tile keeps: Q rounded up to the swizzle's 8-row group. wgmma
// reads 64 rows from a tile's start; the rows past Q are whatever follows
// (the next tile's p, the logits), and only give output rows that no column
// keeps.
__host__ __device__ constexpr int p_rows(int Q) { return (Q + 7) / 8 * 8; }

// Byte offsets from the 1024-aligned base of the block's shared memory.
struct Layout {
  int p, logits, partial, xmax, xsum, bars, bytes;
};
__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr Layout layout(int Q, int QC, int CL, int tiles) {
  const int qn = query_rows(Q);
  const int p = STAGES * slot_bytes(qn);              // tiles x [p_rows][128 B]
  const int logits = p + tiles * p_rows(Q) * SLICE_BYTES;  // [qn][stride] f32
  const int partial = logits + qn * logits_stride(tiles) * 4;  // [QC] f32
  const int xmax = partial + (QC + 3) / 4 * 16;       // [CL][qn]
  const int xsum = xmax + CL * qn * 4;                // [CL][qn]
  const int bars = xsum + CL * qn * 4;
  // the last tile's 64 rows end inside the block's memory
  const int end = max_int(bars + STAGES * 8,
                          p + (tiles - 1) * p_rows(Q) * SLICE_BYTES + TILE_BYTES);
  return Layout{p, logits, partial, xmax, xsum, bars, 1024 + end};
}

// One cluster (CL blocks along x) an image; block `rank` takes tiles
// rank*tiles .. of the image's ceil(N / 64), at least one of them.
template <int QN>
__global__ void __launch_bounds__(THREADS)
ep_pool_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_v,
               bf16* __restrict__ out, int out_stride, int N, int C, int Q,
               int cq, int CL, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int QC = Q * cq;
  const Layout L = layout(Q, QC, CL, tiles);
  unsigned char* p_s = smem + L.p;
  float* logits = reinterpret_cast<float*>(smem + L.logits);
  float* partial = reinterpret_cast<float*>(smem + L.partial);
  float* xmax = reinterpret_cast<float*>(smem + L.xmax);
  float* xsum = reinterpret_cast<float*>(smem + L.xsum);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned rank = cluster_rank();
  const int b = blockIdx.x / CL;
  const int n0 = (int)rank * tiles * TN;
  const int my_tiles = min(tiles, (N + TN - 1) / TN - n0 / TN);
  const int valid = min(N - n0, my_tiles * TN);  // this block's real tokens
  const int nk = (C + 63) / 64, nv = (QC + 63) / 64;
  const int n_logit_items = my_tiles * nk;
  const int n_items = n_logit_items + my_tiles * nv;
  const int LDL = logits_stride(tiles);
  const int PT = p_rows(Q) * SLICE_BYTES;  // bytes from one tile's p to the next

  // thread 0: item i into slot i % STAGES
  auto issue = [&](int i) {
    const int slot = i % STAGES;
    unsigned char* s = smem + slot * slot_bytes(QN);
    if (i < n_logit_items) {
      const int tile = i / nk, kt = i % nk;
      mbar_expect_tx(full + slot, slot_bytes(QN));
      tma_load_3d(s, &map_x, full + slot, kt * 64, n0 + tile * TN, b);
      tma_load_2d(s + TILE_BYTES, &map_q, full + slot, kt * 64, 0);
    } else {
      const int j = i - n_logit_items, tile = j / nv, cb = j % nv;
      mbar_expect_tx(full + slot, TILE_BYTES);
      tma_load_3d(s, &map_v, full + slot, cb * 64, n0 + tile * TN, b);
    }
  };
  // every warp's reads of item i's slot are over: thread 0 refills it
  auto consumed = [&](int i) {
    named_barrier(1, THREADS);
    if (tid == 0 && i + STAGES < n_items) issue(i + STAGES);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(STAGES, n_items); ++i) issue(i);
  // every peer has started before this block writes into its shared memory
  // (the wait comes after the logits)
  cluster_arrive();

  // 1. logits^T, a 64-token tile at a time: rows tokens, columns queries
  int it = 0;
  for (int tile = 0; tile < my_tiles; ++tile) {
    float acc[QN / 2];
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int slot = it % STAGES;
      mbar_wait(full + slot, (it / STAGES) & 1);
      unsigned char* s = smem + slot * slot_bytes(QN);
      const uint64_t da = smem_desc(s), db = smem_desc(s + TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(acc, da + kk * DESC_K_STEP, db + kk * DESC_K_STEP,
                    (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      keep_all(acc);
      consumed(it);
    }
#pragma unroll
    for (int jj = 0; jj < QN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * jj + 2 * t + e;
        if (q < Q)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            logits[q * LDL + tile * TN + 16 * warp + g + 8 * half] =
                acc[4 * jj + 2 * half + e];
      }
  }
  __syncthreads();
  cluster_wait();

  // 2. softmax across the cluster, a warp a query
  for (int q = warp; q < Q; q += THREADS / 32) {
    const float* lr = logits + q * LDL;
    float mx = -INFINITY;
    for (int n = lane; n < valid; n += 32) mx = fmaxf(mx, lr[n]);
    mx = warp_max(mx);
    if (lane < CL) st_cluster(cluster_addr(xmax + rank * QN + q, lane), mx);
  }
  cluster_arrive();
  cluster_wait();
  for (int q = warp; q < Q; q += THREADS / 32) {
    float* lr = logits + q * LDL;
    const float m = warp_max(lane < CL ? xmax[lane * QN + q] : -INFINITY);
    float sum = 0.f;
    for (int n = lane; n < valid; n += 32) {
      const float e = expf(lr[n] - m);
      lr[n] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane < CL) st_cluster(cluster_addr(xsum + rank * QN + q, lane), sum);
  }
  cluster_arrive();
  cluster_wait();
  for (int q = warp; q < Q; q += THREADS / 32) {
    const float* lr = logits + q * LDL;
    float s = xsum[q];
    for (int r = 1; r < CL; ++r) s += xsum[r * QN + q];
    for (int n = lane; n < my_tiles * TN; n += 32) {
      const float p = n < valid ? __fdiv_rn(lr[n], s) : 0.f;
      const int k = n % TN;
      *reinterpret_cast<bf16*>(p_s + (n / TN) * PT + q * SLICE_BYTES +
                               (((k >> 3) ^ (q & 7)) << 4) + (k & 7) * 2) =
          __float2bfloat16_rn(p);
    }
  }
  fence_proxy_async();  // p is read by wgmma (the async proxy)
  __syncthreads();

  // 3. p @ v, a v box at a time; keep the block diagonal
  const int r0 = 16 * warp + g;  // and r0 + 8: this thread's query rows
  for (int tile = 0; tile < my_tiles; ++tile) {
    const uint64_t dp = smem_desc(p_s + tile * PT);
    for (int cb = 0; cb < nv; ++cb, ++it) {
      const int slot = it % STAGES;
      mbar_wait(full + slot, (it / STAGES) & 1);
      const uint64_t dv = smem_desc(smem + slot * slot_bytes(QN));
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1>(acc, dp + kk * DESC_K_STEP,
                    dv + kk * (16 * SLICE_BYTES >> 4), kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
      keep_all(acc);
      consumed(it);
      // row r owns the box's columns [r*cq - cb*64, + cq): most rows none
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lo = (r0 + 8 * half) * cq - cb * 64;
        if (r0 + 8 * half < Q && lo < 64 && lo + cq > 0) {
          float* dst = partial + cb * 64;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * jj + 2 * t + e;
              if (col >= lo && col < lo + cq)
                dst[col] = (tile ? dst[col] : 0.f) + acc[4 * jj + 2 * half + e];
            }
        }
      }
    }
  }

  // 4. the partial sums of the cluster, in rank order
  cluster_arrive();
  cluster_wait();
  for (int j = (int)rank * THREADS + tid; j < QC; j += CL * THREADS) {
    float total = ld_cluster(cluster_addr(partial + j, 0));
    for (int r = 1; r < CL; ++r) total += ld_cluster(cluster_addr(partial + j, r));
    out[(size_t)b * out_stride + j] = __float2bfloat16_rn(total);
  }
  // no block leaves while a peer reads its partial sums
  cluster_arrive();
  cluster_wait();
}

// Map of the (B, N, cols) bf16 tensor at ptr, rows `row_stride` and images
// `image_stride` elements apart, with boxes of 64 rows x 64 columns in the
// 128-byte swizzle, zero fill past N and past cols. Returns 0 or a cudaError_t.
int make_tile_map(CUtensorMap* map, const void* ptr, int B, int N, int cols,
                  int row_stride, long long image_stride) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2,
                                 (cuuint64_t)image_stride * 2};
  const cuuint32_t box[3] = {64, TN, 1};
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
cudaLaunchConfig_t configure(int Q, int QC, int CL, int tiles,
                             cudaLaunchAttribute* attr, cudaStream_t stream) {
  const int smem = layout(Q, QC, CL, tiles).bytes;
  cudaFuncSetAttribute(ep_pool_kernel<QN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (CL > 8)
    cudaFuncSetAttribute(ep_pool_kernel<QN>,
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
int resident_clusters(int Q, int QC, int CL, int tiles) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = configure<QN>(Q, QC, CL, tiles, &attr, 0);
  cfg.gridDim = dim3(CL * sm_count());
  int n = 0;
  const cudaError_t rc =
      cudaOccupancyMaxActiveClusters(&n, ep_pool_kernel<QN>, &cfg);
  return rc == cudaSuccess ? n : -(int)rc;
}

template <int QN>
int launch(const bf16* q, const bf16* x, const bf16* v, bf16* out, int B,
           int N, int C, int Q, int cq, int x_bstride, int v_stride,
           int out_stride, int CL, int tiles, cudaStream_t stream) {
  const int QC = Q * cq;
  CUtensorMap map_x, map_q, map_v;
  int rc = make_tile_map(&map_x, x, B, N, C, C, x_bstride);
  if (rc == 0) rc = make_map(&map_q, q, 2, Q, C, QN);
  if (rc == 0)
    rc = make_tile_map(&map_v, v, B, N, QC, v_stride, (long long)N * v_stride);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = configure<QN>(Q, QC, CL, tiles, &attr, stream);
  cfg.gridDim = dim3(B * CL);
  rc = (int)cudaLaunchKernelEx(&cfg, ep_pool_kernel<QN>, map_x, map_q, map_v,
                               out, out_stride, N, C, Q, cq, CL, tiles);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace
}  // namespace ep

// Shared memory of one block for Q queries, Q*cq value columns, a cluster of
// `cluster` blocks and `tiles` tiles of 64 tokens a block
// (ops/pool_attn.py::ep_pool_smem_bytes computes the same).
EP_EXPORT int ep_pool_smem_bytes(int Q, int QC, int cluster, int tiles) {
  return ep::layout(Q, QC, cluster, tiles).bytes;
}

// Clusters of `cluster` blocks that the card holds at once, what the shared
// memory and the cluster's shape leave of the SMs (a negative cudaError_t
// where the query fails).
EP_EXPORT int ep_pool_resident_clusters(int Q, int QC, int cluster, int tiles) {
  using namespace ep;
  if (Q < 1 || Q > 64 || cluster < 1 || cluster > MAX_CLUSTER || tiles < 1)
    return -(int)cudaErrorInvalidValue;
  return Q <= 8    ? resident_clusters<8>(Q, QC, cluster, tiles)
         : Q <= 16 ? resident_clusters<16>(Q, QC, cluster, tiles)
         : Q <= 32 ? resident_clusters<32>(Q, QC, cluster, tiles)
                   : resident_clusters<64>(Q, QC, cluster, tiles);
}

// q_scaled (Q, C), tokens (B, N, C), v (B, N, Q*cq), all bf16 -> out (B, Q*cq).
// The tokens' rows are contiguous; images are x_bstride elements apart, so the
// patch tokens can be a view that skips the [CLS] row. v's rows are v_stride
// elements apart and out's images out_stride apart, so that a bank of more
// than 64 queries runs as groups of at most 64, each launch on its group's
// rows of q_scaled and columns of v and out (ops/pool_attn.py::query_groups).
// A cluster of `cluster` blocks an image, `tiles` tiles of 64 tokens a block
// (ops/pool_attn.py::ep_pool_tiling).
EP_EXPORT int ep_pool(const void* q, const void* x, const void* v, void* out,
                      int B, int N, int C, int Q, int cq, int x_bstride,
                      int v_stride, int out_stride, int cluster, int tiles,
                      void* stream) {
  using namespace ep;
  const int span = tiles * TN;  // tokens a block
  if (B < 1 || N < 1 || Q < 1 || Q > 64 || cq < 1 || C % 8 || (Q * cq) % 8 ||
      x_bstride % 8 || v_stride % 8 || v_stride < Q * cq ||
      out_stride < Q * cq || cluster < 1 || cluster > MAX_CLUSTER || tiles < 1 ||
      cluster * span < N || (cluster - 1) * span >= N ||
      layout(Q, Q * cq, cluster, tiles).bytes > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const auto fn = Q <= 8 ? launch<8> : Q <= 16 ? launch<16>
                : Q <= 32 ? launch<32> : launch<64>;
  return fn(static_cast<const bf16*>(q), static_cast<const bf16*>(x),
            static_cast<const bf16*>(v), static_cast<bf16*>(out), B, N, C, Q,
            cq, x_bstride, v_stride, out_stride, cluster, tiles,
            static_cast<cudaStream_t>(stream));
}
