// SwiGLU's gate: h = silu(x1) * x2 on the two halves of w12's output rows,
// the MLP half of DINOv2's giant tower (models/vit.py::SwiGLUMlp).
//
// Replaces: no TPU kernel. The JAX package leaves the gate to XLA, which
//   fuses it into one pass; the plain bf16 chain on this card is three
//   kernels (the sigmoid, then two products), each reading and writing the
//   (M, H) halves again: about 16 bytes an element of h.
//
// Bound on this card: bytes. A few dozen operations an element against 6
//   bytes an element (x1 and x2 read once, h written once, all bf16): at
//   (128 * 261, 2 * 4096) 0.82 GB, 0.245 ms at 3.35 TB/s.
// Design: one pass. A block walks rows (grid-stride); its threads take a
//   row's 16-byte vectors of x1 and the matching vectors of x2, GATE_VPT
//   each, all loads made before any arithmetic, and store 16-byte vectors
//   of h. No division by the row width: a row's vectors are the inner loop.
//   The arithmetic rounds where the plain chain x1 * sigmoid(x1) * x2 in
//   bf16 rounds: s = bf16(1 / (1 + exp(-x1))) in f32 as PyTorch's sigmoid
//   computes it, then bf16(x1 * s), then bf16(that * x2). A product of two
//   bf16 values is exact in f32, so those two roundings are PyTorch's; the
//   sigmoid's may differ in its last f32 bit (another exp), which moves a
//   bf16 result by one step where it lands on a rounding boundary.
//
// Layouts: x12 (M, 2H) row-major bf16, each row [x1 | x2]; h (M, H)
// row-major bf16. Requires H % 8 == 0 and 16-byte aligned rows; checked by
// the Python wrapper (ops/swiglu.py).
#include "hopper.cuh"

namespace ep {
namespace {

constexpr int GATE_THREADS = 256, GATE_VPT = 2;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint4 gate8(const uint4& a, const uint4& b) {
  Pack8 x1, x2, h;
  x1.u = a;
  x2.u = b;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float v = x1.get(e);
    const float s = round_bf16(1.0f / (1.0f + expf(-v)));
    h.set(e, round_bf16(v * s) * x2.get(e));
  }
  return h.u;
}

__global__ void __launch_bounds__(GATE_THREADS)
swiglu_gate_kernel(const uint4* __restrict__ x12, uint4* __restrict__ h,
                   int M, int hv) {
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const uint4* x1 = x12 + (size_t)row * 2 * hv;
    const uint4* x2 = x1 + hv;
    uint4* out = h + (size_t)row * hv;
    for (int c0 = threadIdx.x; c0 < hv; c0 += GATE_VPT * GATE_THREADS) {
      uint4 a[GATE_VPT], b[GATE_VPT];
#pragma unroll
      for (int k = 0; k < GATE_VPT; ++k) {
        const int c = c0 + k * GATE_THREADS;
        if (c < hv) a[k] = __ldg(x1 + c), b[k] = __ldg(x2 + c);
      }
#pragma unroll
      for (int k = 0; k < GATE_VPT; ++k) {
        const int c = c0 + k * GATE_THREADS;
        if (c < hv) out[c] = gate8(a[k], b[k]);
      }
    }
  }
}

}  // namespace
}  // namespace ep

// h (M, H) bf16 = silu(x1) * x2 of x12 (M, 2H) bf16 rows [x1 | x2]; H % 8 == 0.
EP_EXPORT int ep_swiglu_gate(const void* x12, void* h, int M, int H,
                             void* stream) {
  using namespace ep;
  if (M <= 0 || H <= 0 || H % 8) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, swiglu_gate_kernel,
                                                GATE_THREADS, 0);
  const int most = (per_sm > 0 ? per_sm : 1) * hopper::sm_count();
  swiglu_gate_kernel<<<M < most ? M : most, GATE_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x12), static_cast<uint4*>(h), M, H / 8);
  return (int)cudaGetLastError();
}
