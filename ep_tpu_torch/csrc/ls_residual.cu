// LayerScale and the residual: out = x + gamma * y on (M, D) bf16 rows, the
// closing of both halves of a LayerScale block (models/vit.py::LayerScale:
// DINOv2, DINOv3, SimMIM).
//
// Replaces: no TPU kernel. The JAX package leaves LayerScale and the add to
//   XLA, which fuses them into one pass; the plain chain on this card is a
//   broadcast multiply (a kernel that is not vectorised) and an add, each
//   reading and writing (M, D) again: 10 bytes an element of out against 6.
//
// Bound on this card: bytes. Two operations an element against 6 bytes (x
//   and y read once, out written once, all bf16): at DINOv2-g/14's probe
//   shape (128 * 261, 1536) 308 MB, 92 us at 3.35 TB/s.
// Design: one pass. A block takes blockDim.y rows (more than one where a
//   row is narrower than LS_THREADS threads), a thread the 16-byte column
//   vectors c, c + blockDim.x, ... (LS_VPT of them at most) of its row: it
//   reads their gamma, rounded to bf16, into registers, issues all its loads
//   of x and y, then the arithmetic and the stores. No division by the row
//   width. One block per group of rows, not a persistent grid: on an H100 at
//   both probe cells' shapes the persistent grid-stride form ran at 85% of
//   the bound, this one at 87-90%, the level of PyTorch's vectorised add.
//   The arithmetic rounds where the chain x + y * gamma.to(bf16) rounds:
//   p = bf16(y * bf16(gamma)), exact in f32 before that rounding (a product
//   of two bf16 values), then bf16(x + p); so the result equals the chain's
//   bit for bit.
//
// Layouts: x, y, out (M, D) row-major bf16; gamma (D,) f32 or bf16. Requires
// D % 8 == 0, D <= 8 * LS_VPT * LS_THREADS and 16-byte aligned rows; checked
// by the Python wrapper (ops/layerscale.py).
#include "hopper.cuh"

namespace ep {
namespace {

constexpr int LS_THREADS = 256, LS_VPT = 2;

__device__ __forceinline__ uint4 ls8(const uint4& xa, const uint4& ya,
                                     const uint4& ga) {
  Pack8 x, y, g, out;
  x.u = xa;
  y.u = ya;
  g.u = ga;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float p = __bfloat162float(
        __float2bfloat16_rn(__fmul_rn(y.get(e), g.get(e))));
    out.set(e, __fadd_rn(x.get(e), p));
  }
  return out.u;
}

template <int VPT>
__global__ void __launch_bounds__(LS_THREADS)
ls_residual_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
                   const void* __restrict__ gamma, int gamma_f32,
                   uint4* __restrict__ out, int M, int dv) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= M) return;
  uint4 g[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    Pack8 p;
    p.u = zero_pack();
    if (c < dv) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (gamma_f32)
          p.set(e, static_cast<const float*>(gamma)[c * 8 + e]);
        else
          p.s[e] = static_cast<const unsigned short*>(gamma)[c * 8 + e];
      }
    }
    g[k] = p.u;
  }
  const size_t base = (size_t)row * dv;
  uint4 a[VPT], b[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < dv) a[k] = __ldg(x + base + c), b[k] = __ldg(y + base + c);
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < dv) out[base + c] = ls8(a[k], b[k], g[k]);
  }
}

template <int VPT>
int launch(const void* x, const void* y, const void* gamma, int gamma_f32,
           void* out, int M, int dv, cudaStream_t stream) {
  // a row's vectors over the fewest warps that hold them VPT a thread, and
  // as many rows a block as fit in LS_THREADS
  const int bx = ((dv + VPT - 1) / VPT + 31) / 32 * 32;
  const dim3 block(bx, LS_THREADS / bx);
  const int blocks = (M + (int)block.y - 1) / (int)block.y;
  ls_residual_kernel<VPT><<<blocks, block, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(y), gamma,
      gamma_f32, static_cast<uint4*>(out), M, dv);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ep

// out (M, D) bf16 = x + gamma * y, x and y (M, D) bf16, gamma (D,) f32
// (gamma_f32 = 1) or bf16 (0); D % 8 == 0, D <= 4096.
EP_EXPORT int ep_ls_residual(const void* x, const void* y, const void* gamma,
                             void* out, int M, int D, int gamma_f32,
                             void* stream) {
  using namespace ep;
  if (M <= 0 || D <= 0 || D % 8 || D > 8 * LS_VPT * LS_THREADS)
    return (int)cudaErrorInvalidValue;
  const int dv = D / 8;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dv <= LS_THREADS)
    return launch<1>(x, y, gamma, gamma_f32, out, M, dv, s);
  return launch<LS_VPT>(x, y, gamma, gamma_f32, out, M, dv, s);
}
