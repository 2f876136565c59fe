// LARS over every trained leaf in two launches (train/lars.py::LARS.step):
// lars_norms, each chunk's partial sums of p^2 and dp^2, then lars_apply,
// each leaf's trust ratio, the momentum and the parameter update.
//
// Replaces: no TPU kernel. The JAX package leaves optax's LARS to XLA, which
//   fuses its per-leaf work into a few passes; the plain PyTorch loop on this
//   card is some 15 kernels a leaf (an f32 copy of the gradient, two norms,
//   a where, the momentum, casts, a copy), ~2,300 launches a ViT-B
//   fine-tuning step of 152 leaves, each done before the host has launched
//   the next.
//
// Bound on this card: bytes. A few operations an element against 8 bytes an
//   element read by the first pass (f32 p and g) and 20 by the second (p, g
//   and mu read, mu and p written): 2.4 GB for ViT-B's 86.6 M f32
//   parameters, 0.73 ms at 3.35 TB/s.
// Design: two passes, because the trust ratio q = tc * |p| / |dp| needs each
//   whole leaf's norms before any element of it is updated. Both passes walk
//   the same fixed-size chunks of every leaf (the chunk table, built once per
//   parameter list in ops/lars.py), one block a chunk; a leaf's chunks are
//   consecutive. The first writes each chunk's two partial sums to its own
//   slot of a [chunks, 2] f32 buffer, with no atomics; in the second, every
//   block of a leaf sums that leaf's partials in the same fixed order, so
//   the blocks agree on q bit for bit and a rerun gives the same result.
//   The per-step pointers (p, g, mu read, mu written) come in one table,
//   copied to the card from a pinned host tensor; a null g reads as zeros
//   (a leaf without a gradient) and a null mu as zeros (the first step).
//   Elements go four at a time (16-byte f32, 8-byte bf16 vectors) where the
//   leaf's pointers are 16-byte aligned, one at a time elsewhere. The
//   arithmetic rounds where the plain chain in f32 rounds, with no fused
//   multiply-add: dp = g + wd*p, dp*q, mu = momentum*mu + dp, then
//   p + mu*(-lr) rounded to p's type and mu rounded to its storage type;
//   only the sums of the norms run in another order.
//
// Tables (mirrored by ops/lars.py::LEAF_DTYPE and the per-step int64 rows):
// LarsLeaf, one a leaf; LarsPtrs, one a leaf (five int64 words);
// chunk_leaf (int32), one a chunk.
#include "common.cuh"

namespace ep {
namespace {

constexpr int LARS_THREADS = 256, LARS_WARPS = LARS_THREADS / 32;
constexpr int F32 = 0;  // the dtype code of float32; 1 is bfloat16

struct LarsLeaf {
  long long numel;
  int first_chunk, n_chunks;
  int scaled;  // ndim > 1: weight decay and the trust ratio
  float weight_decay, trust, momentum;
};
static_assert(sizeof(LarsLeaf) == 32, "ops/lars.py::LEAF_DTYPE");

struct LarsPtrs {
  const void* p;
  const void* g;      // null: zeros
  const void* mu_in;  // null: zeros
  void* mu_out;
  int dtypes;  // p | g << 2 | mu_in << 4 | mu_out << 6; 0 f32, 1 bf16
  int pad;
};
static_assert(sizeof(LarsPtrs) == 40, "ops/lars.py: five int64 a leaf");

__device__ __forceinline__ float load1(const void* base, int code,
                                       long long i) {
  if (base == nullptr) return 0.0f;
  if (code == F32) return static_cast<const float*>(base)[i];
  return __bfloat162float(static_cast<const bf16*>(base)[i]);
}

__device__ __forceinline__ float4 load4(const void* base, int code,
                                        long long i) {
  if (base == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (code == F32)
    return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
  const uint2 v =
      *reinterpret_cast<const uint2*>(static_cast<const bf16*>(base) + i);
  return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
}

__device__ __forceinline__ void store1(void* base, int code, long long i,
                                       float v) {
  if (code == F32)
    static_cast<float*>(base)[i] = v;
  else
    static_cast<bf16*>(base)[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(void* base, int code, long long i,
                                       float4 v) {
  if (code == F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) = v;
  } else {
    *reinterpret_cast<uint2*>(static_cast<bf16*>(base) + i) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// The chunk's elements [lo, hi) of its leaf, and whether they go four at a
// time (every pointer of the leaf 16-byte aligned, chunk % 4 == 0).
struct Span {
  long long lo, hi;
  bool vec;
};

__device__ __forceinline__ Span chunk_span(const LarsLeaf& L, const LarsPtrs& P,
                                           int c, int chunk) {
  Span s;
  s.lo = (long long)(c - L.first_chunk) * chunk;
  s.hi = s.lo + chunk < L.numel ? s.lo + chunk : L.numel;
  s.vec = aligned16(P.p) && aligned16(P.g) && aligned16(P.mu_in) &&
          aligned16(P.mu_out);
  return s;
}

// Sums of a and b over the block, the same order in every block; every
// thread gets them.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[LARS_WARPS];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < LARS_WARPS; ++w) s.x += part[w].x, s.y += part[w].y;
  __syncthreads();
  return s;
}

__device__ __forceinline__ float decayed(float g, float p, float wd) {
  return __fadd_rn(g, __fmul_rn(wd, p));
}

__global__ void __launch_bounds__(LARS_THREADS)
lars_norms_kernel(const LarsLeaf* __restrict__ leaves,
                  const LarsPtrs* __restrict__ ptrs,
                  const int* __restrict__ chunk_leaf,
                  float2* __restrict__ partials, int chunk) {
  const int c = blockIdx.x;
  const int leaf = chunk_leaf[c];
  const LarsLeaf L = leaves[leaf];
  if (!L.scaled) return;  // lars_apply reads no partials of this leaf
  const LarsPtrs P = ptrs[leaf];
  const int tp = P.dtypes & 3, tg = (P.dtypes >> 2) & 3;
  const Span s = chunk_span(L, P, c, chunk);
  const float wd = L.weight_decay;
  float sp = 0.f, sd = 0.f;
  long long i = s.lo + 4 * (long long)threadIdx.x;
  if (s.vec) {
    for (; i + 4 <= s.hi; i += 4 * LARS_THREADS) {
      const float4 p = load4(P.p, tp, i), g = load4(P.g, tg, i);
      const float d0 = decayed(g.x, p.x, wd), d1 = decayed(g.y, p.y, wd),
                  d2 = decayed(g.z, p.z, wd), d3 = decayed(g.w, p.w, wd);
      sp = fmaf(p.x, p.x, sp), sp = fmaf(p.y, p.y, sp);
      sp = fmaf(p.z, p.z, sp), sp = fmaf(p.w, p.w, sp);
      sd = fmaf(d0, d0, sd), sd = fmaf(d1, d1, sd);
      sd = fmaf(d2, d2, sd), sd = fmaf(d3, d3, sd);
    }
  }
  // the scalar walk: the whole chunk where it is not aligned, else the tail
  // of fewer than 4 elements that the vector walk left
  for (long long j = s.vec ? s.hi - (s.hi - s.lo) % 4 + threadIdx.x
                           : s.lo + threadIdx.x;
       j < s.hi; j += LARS_THREADS) {
    const float p = load1(P.p, tp, j), d = decayed(load1(P.g, tg, j), p, wd);
    sp = fmaf(p, p, sp);
    sd = fmaf(d, d, sd);
  }
  const float2 sum = block_sum2(sp, sd);
  if (threadIdx.x == 0) partials[c] = sum;
}

__device__ __forceinline__ float lars_elem(float p, float g, float mu_in,
                                           float& mu_out, bool scaled,
                                           float wd, float q, float momentum,
                                           float neg_lr) {
  float dp = g;
  if (scaled) dp = __fmul_rn(decayed(g, p, wd), q);
  mu_out = __fadd_rn(__fmul_rn(momentum, mu_in), dp);
  return __fadd_rn(p, __fmul_rn(mu_out, neg_lr));
}

__global__ void __launch_bounds__(LARS_THREADS)
lars_apply_kernel(const LarsLeaf* __restrict__ leaves,
                  const LarsPtrs* __restrict__ ptrs,
                  const int* __restrict__ chunk_leaf,
                  const float2* __restrict__ partials, int chunk,
                  float neg_lr) {
  const int c = blockIdx.x;
  const int leaf = chunk_leaf[c];
  const LarsLeaf L = leaves[leaf];
  const LarsPtrs P = ptrs[leaf];
  float q = 1.0f;
  if (L.scaled) {
    float sp = 0.f, sd = 0.f;
    for (int k = threadIdx.x; k < L.n_chunks; k += LARS_THREADS) {
      const float2 v = partials[L.first_chunk + k];
      sp += v.x;
      sd += v.y;
    }
    const float2 sum = block_sum2(sp, sd);
    const float pn = sqrtf(sum.x), un = sqrtf(sum.y);
    if (pn > 0.f && un > 0.f) q = __fdiv_rn(__fmul_rn(L.trust, pn), un);
  }
  const int tp = P.dtypes & 3, tg = (P.dtypes >> 2) & 3,
            tmi = (P.dtypes >> 4) & 3, tmo = (P.dtypes >> 6) & 3;
  const Span s = chunk_span(L, P, c, chunk);
  const bool scaled = L.scaled != 0;
  const float wd = L.weight_decay, mom = L.momentum;
  void* p_out = const_cast<void*>(P.p);
  long long i = s.lo + 4 * (long long)threadIdx.x;
  if (s.vec) {
    for (; i + 4 <= s.hi; i += 4 * LARS_THREADS) {
      const float4 p = load4(P.p, tp, i), g = load4(P.g, tg, i),
                   m = load4(P.mu_in, tmi, i);
      float4 mo, po;
      po.x = lars_elem(p.x, g.x, m.x, mo.x, scaled, wd, q, mom, neg_lr);
      po.y = lars_elem(p.y, g.y, m.y, mo.y, scaled, wd, q, mom, neg_lr);
      po.z = lars_elem(p.z, g.z, m.z, mo.z, scaled, wd, q, mom, neg_lr);
      po.w = lars_elem(p.w, g.w, m.w, mo.w, scaled, wd, q, mom, neg_lr);
      store4(P.mu_out, tmo, i, mo);
      store4(p_out, tp, i, po);
    }
  }
  for (long long j = s.vec ? s.hi - (s.hi - s.lo) % 4 + threadIdx.x
                           : s.lo + threadIdx.x;
       j < s.hi; j += LARS_THREADS) {
    float mo;
    const float po = lars_elem(load1(P.p, tp, j), load1(P.g, tg, j),
                               load1(P.mu_in, tmi, j), mo, scaled, wd, q, mom,
                               neg_lr);
    store1(P.mu_out, tmo, j, mo);
    store1(p_out, tp, j, po);
  }
}

}  // namespace
}  // namespace ep

// partials[c] = (sum p^2, sum (g + wd*p)^2) over chunk c of its leaf, for
// the chunks of leaves with ndim > 1; chunk % 4 == 0.
EP_EXPORT int ep_lars_norms(const void* leaves, const void* ptrs,
                            const void* chunk_leaf, void* partials,
                            int n_chunks, int chunk, void* stream) {
  using namespace ep;
  if (n_chunks <= 0 || chunk <= 0 || chunk % 4) return (int)cudaErrorInvalidValue;
  lars_norms_kernel<<<n_chunks, LARS_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LarsLeaf*>(leaves), static_cast<const LarsPtrs*>(ptrs),
      static_cast<const int*>(chunk_leaf), static_cast<float2*>(partials),
      chunk);
  return (int)cudaGetLastError();
}

// Each leaf's trust ratio from its partials, then mu = momentum*mu + dp*q
// (stored in mu_out's type) and p += mu * neg_lr, chunk by chunk.
EP_EXPORT int ep_lars_apply(const void* leaves, const void* ptrs,
                            const void* chunk_leaf, const void* partials,
                            int n_chunks, int chunk, float neg_lr,
                            void* stream) {
  using namespace ep;
  if (n_chunks <= 0 || chunk <= 0 || chunk % 4) return (int)cudaErrorInvalidValue;
  lars_apply_kernel<<<n_chunks, LARS_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LarsLeaf*>(leaves), static_cast<const LarsPtrs*>(ptrs),
      static_cast<const int*>(chunk_leaf),
      static_cast<const float2*>(partials), chunk, neg_lr);
  return (int)cudaGetLastError();
}
