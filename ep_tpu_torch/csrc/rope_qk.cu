// 2D axial RoPE on the fused qkv tensor, in place: the q and k columns of
// the patch rows of (B, T, 3*H*Dh), each head rotated by its patch's angles
// (models/vit.py::Attention, DINOv3's rope_apply). [CLS], the register
// tokens before the patches, and v are left as they are.
//
// Replaces: no TPU kernel. The JAX package has no RoPE; the plain chain on
//   this card (ops/rope.py::rope_qk_ref: the columns cast to f32, x * cos,
//   the rotated half times sin, their sum, the cast back, and the joins) is
//   about ten passes over the q and k columns.
//
// Bound on this card: bytes. Four multiplies and two adds an element against
//   4 bytes (read and written once in bf16), plus the f32 tables: at DINOv3
//   ViT-7B/16, 448 px, batch 8 (784 patches, 32 heads of 128), 206 MB a
//   call, 61.6 us at 3.35 TB/s.
// Design: one pass. A thread takes 8 columns of the first half of one head
//   of q or k in one patch row and the 8 columns Dh/2 further on, two 16-byte
//   vectors, so that x and its rotated half are both in its registers; the
//   8 sines and cosines of those columns come from the tables' first half
//   (the tables repeat after Dh/2, as rope_tables builds them), which a
//   row's 2H heads read from L1. Consecutive threads take consecutive vectors
//   of a head, so a warp reads and writes whole 256-byte rows of 4 heads.
//   The arithmetic rounds where the chain rounds: x * cos and x' * sin each
//   rounded in f32, then their sum (no fused multiply-add), then one
//   rounding to bf16, so the result equals the chain's bit for bit.
//
// Layouts: qkv (B, T, 3*H*Dh) row-major bf16, columns [q heads | k heads |
// v heads]; sin, cos (T - prefix, Dh) row-major f32. Requires Dh % 16 == 0
// and 16-byte aligned rows; checked by the Python wrapper (ops/rope.py).
#include "hopper.cuh"

namespace ep {
namespace {

constexpr int ROPE_THREADS = 256;

__device__ __forceinline__ float rot_lo(float x, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(-x2, s));
}
__device__ __forceinline__ float rot_hi(float x2, float x, float c, float s) {
  return __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x, s));
}

__global__ void __launch_bounds__(ROPE_THREADS)
rope_qk_kernel(bf16* __restrict__ qkv, const float* __restrict__ sin_t,
               const float* __restrict__ cos_t, int items, int N, int T,
               int prefix, int H, int Dh) {
  const int vh = Dh / 16;  // 8-column vectors in half a head
  const long long row_cols = 3LL * H * Dh;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const int j = i % vh, t = i / vh;
    const int head = t % (2 * H);  // q heads, then k heads
    const int r = t / (2 * H);     // image * N + patch
    const int n = r % N, b = r / N;
    bf16* lo = qkv + ((long long)b * T + prefix + n) * row_cols +
               head * Dh + 8 * j;
    bf16* hi = lo + Dh / 2;
    Pack8 x, x2, y, y2;
    x.u = *reinterpret_cast<const uint4*>(lo);
    x2.u = *reinterpret_cast<const uint4*>(hi);
    const long long at = (long long)n * Dh + 8 * j;
    const float4* sp = reinterpret_cast<const float4*>(sin_t + at);
    const float4* cp = reinterpret_cast<const float4*>(cos_t + at);
    const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
    const float4 c0 = __ldg(cp), c1 = __ldg(cp + 1);
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      y.set(e, rot_lo(x.get(e), x2.get(e), cv[e], sv[e]));
      y2.set(e, rot_hi(x2.get(e), x.get(e), cv[e], sv[e]));
    }
    *reinterpret_cast<uint4*>(lo) = y.u;
    *reinterpret_cast<uint4*>(hi) = y2.u;
  }
}

}  // namespace
}  // namespace ep

// qkv (B, T, 3*H*Dh) bf16, in place: RoPE on the q and k columns of rows
// prefix..T-1 of each image by sin, cos (T - prefix, Dh) f32; Dh % 16 == 0.
EP_EXPORT int ep_rope_qk(void* qkv, const void* sin_t, const void* cos_t,
                         int B, int T, int prefix, int H, int Dh,
                         void* stream) {
  using namespace ep;
  const int N = T - prefix;
  if (B <= 0 || N <= 0 || prefix < 0 || H <= 0 || Dh <= 0 || Dh % 16)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * N * 2 * H * (Dh / 16);
  if (items > 0x7fffffff - ROPE_THREADS) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rope_qk_kernel,
                                                ROPE_THREADS, 0);
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) *
                         hopper::sm_count();
  const long long need = (items + ROPE_THREADS - 1) / ROPE_THREADS;
  rope_qk_kernel<<<(int)(need < most ? need : most), ROPE_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<bf16*>(qkv), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), (int)items, N, T, prefix, H, Dh);
  return (int)cudaGetLastError();
}
