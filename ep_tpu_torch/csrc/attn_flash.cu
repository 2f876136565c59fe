// Kernel F (attn_flash): multi-head softmax attention for any sequence length
// on the natural-layout fused qkv tensor, (B, T, 3D) with columns
// [q heads | k heads | v heads], to (B, T, D) with each head written at its
// own column slice.
//
// Replaces: ep_tpu/ops/flash_attn_pallas.py::_flash_kernel (flash_attention,
//   reached through attn_fused_pallas.py::_fwd_flash), the long-sequence
//   route of 448 px probing (T=1025), and
//   ep_tpu/ops/attn_fused_pallas.py::_kernel_head_group_rowtile, the
//   query-row-tiled variant of the head-width-80 kernel at T=257. Both tile
//   the query rows and keep a (rows, T) f32 logits tile in the TPU's fast
//   memory; a 128 x 1025 f32 tile is 525 KB, over twice what a block has
//   here, so the keys are tiled too. The TPU route also splits the heads
//   first (three transposed copies of qkv); this kernel reads each head's
//   rows straight out of qkv, as kernel B does.
//
// Bound on this card: operations. At ViT-H/14, 448 px, batch 64 (T=1025, 16
//   heads of width 80) the two products are 4*64*16*1025^2*80 = 344 GFLOP,
//   0.348 ms at 989 TFLOP/s, against 672 MB of qkv in and o out, 0.200 ms.
// Design: one block per (query tile, head, image), a warp per 16 query rows
//   (8 warps, 128 rows: with 64 rows a block the kernel read 3.851 against
//   2.647 ms at T=1025 and 0.686 against 0.533 ms at T=257 on an H100, since
//   half as many rows share each K/V tile); the warp's q fragments stay in
//   registers. K and V stream through shared memory in
//   64-key tiles on a 3-stage cp.async ring, one __syncthreads a tile, with
//   mma.sync m16n8k16 (bf16 in, f32 accumulate, fed by ldmatrix) for both
//   products. The rounding points are the TPU kernels': f32 logits times
//   scale/temperature, the softmax normalised BEFORE PV, the normalised
//   probabilities rounded to bf16, PV summed in f32 and rounded once. An
//   online softmax that rescales its accumulator would normalise after PV
//   and round un-normalised probabilities, so the keys are swept twice, as
//   kernel E does for its row statistics: sweep 1 keeps each row's running
//   max and sum of exponentials, sweep 2 recomputes the logits, forms
//   exp(l - max) / sum, rounds to bf16 and feeds them to PV from the logits'
//   registers. That is three products where two are needed, half as many
//   again. Keys past T are masked to -inf in both sweeps (the TPU kernel:
//   -1e30) and their V rows are zero; query rows past T are not written, and
//   a warp whose 16 rows all lie past T only helps to load.
#include "common.cuh"

namespace ep {
namespace {

constexpr int BN = 64;     // keys per streamed tile
constexpr int STAGES = 3;  // tiles in flight
constexpr int WARPS = 8;   // a warp per 16 query rows: 128 rows a block

template <int DH>
__host__ __device__ constexpr int flash_smem_bytes() {
  return (STAGES * 2 * BN + 16 * WARPS) * (DH + 8) * 2;
}

template <int DH>
__global__ void __launch_bounds__(32 * WARPS)
attn_flash_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T,
                  int H, float coef) {
  constexpr int THREADS = 32 * WARPS;
  constexpr int BM = 16 * WARPS;  // query rows per block
  constexpr int LD = DH + 8;      // shared row stride (bf16)
  constexpr int CH = DH / 8;      // 16-byte chunks per head row
  constexpr int NT = BN / 8;      // 8-key tiles per streamed tile
  const int D = H * DH;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [STAGES][BN][LD]
  bf16* Vs = Ks + STAGES * BN * LD;          // [STAGES][BN][LD]
  bf16* Qs = Vs + STAGES * BN * LD;          // [BM][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* base = qkv + (size_t)b * T * 3 * D + h * DH;

  const int n_tiles = (T + BN - 1) / BN;
  const int total = 2 * n_tiles;  // sweep 1 (K), then sweep 2 (K and V)

  // Item i is key tile i % n_tiles; it brings V along in the second sweep.
  auto prefetch = [&](int i) {
    if (i < total) {
      const int k0 = (i % n_tiles) * BN;
      const bool with_v = i >= n_tiles;
      bf16* ks = Ks + (i % STAGES) * BN * LD;
      bf16* vs = Vs + (i % STAGES) * BN * LD;
      for (int idx = tid; idx < BN * CH; idx += THREADS) {
        const int r = idx / CH, c = (idx % CH) * 8;
        if (k0 + r < T) {
          const bf16* row = base + (size_t)(k0 + r) * 3 * D + c;
          cp_async16(ks + r * LD + c, row + D);
          if (with_v) cp_async16(vs + r * LD + c, row + 2 * D);
        } else {
          *reinterpret_cast<uint4*>(ks + r * LD + c) = zero_pack();
          if (with_v) *reinterpret_cast<uint4*>(vs + r * LD + c) = zero_pack();
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  for (int idx = tid; idx < BM * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    if (q0 + r < T)
      cp_async16(Qs + r * LD + c, base + (size_t)(q0 + r) * 3 * D + c);
    else
      *reinterpret_cast<uint4*>(Qs + r * LD + c) = zero_pack();
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) prefetch(i);
  cp_async_wait<STAGES - 1>();  // the q tile has landed
  __syncthreads();

  const int r0 = q0 + warp * 16;
  const bool active = r0 < T;  // warp-uniform
  unsigned qa[DH / 16][4];
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd)
    ldmatrix_x4(qa[kd], Qs + (warp * 16 + (lane & 15)) * LD + kd * 16 +
                            (lane >> 4) * 8);

  // Rows g and g+8 of the warp's tile: running max, this thread's share of
  // the running sum (its lane quad holds the rest), then 1 / sum.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();  // item i has landed (this thread's copies)
    __syncthreads();  // everyone's copies; and item i-1 has been consumed
    prefetch(i + STAGES - 1);  // into the stage that item i-1 used
    if (i == n_tiles) {  // between the sweeps: the rows' sums are complete
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, w);
        l1 += __shfl_xor_sync(0xffffffffu, l1, w);
      }
      l0 = 1.f / l0;
      l1 = 1.f / l1;
    }
    if (!active) continue;
    const bf16* ks = Ks + (i % STAGES) * BN * LD;
    const int k0 = (i % n_tiles) * BN;

    // Logits: s[j] is the 16x8 tile of keys k0+8j..k0+8j+7; this thread holds
    // rows g (s[j][0..1]) and g+8 (s[j][2..3]), columns 8j+2*t4 and +1.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) {
        unsigned kb[4];
        ldmatrix_x4(kb, ks + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * j2], qa[kd], kb[0], kb[1]);
        mma_bf16_16816(s[2 * j2 + 1], qa[kd], kb[2], kb[3]);
      }
    }
    const bool ragged = k0 + BN > T;  // only the last tile has keys past T
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = !ragged || k0 + j * 8 + 2 * t4 + e < T;
        s[j][e] = ok ? s[j][e] * coef : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * coef : -INFINITY;
      }

    if (i < n_tiles) {
      // Sweep 1: fold the tile into the rows' max and sum. Every tile holds
      // at least one real key, so the new max is finite.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      l0 *= __expf(m0 - mx0);
      l1 *= __expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l0 += __expf(s[j][e] - m0);
          l1 += __expf(s[j][2 + e] - m1);
        }
    } else {
      // Sweep 2: O += P V; the probabilities of keys 16kk..16kk+15 of the
      // tile form the A operand.
      const bf16* vs = Vs + (i % STAGES) * BN * LD;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const int ja = 2 * kk, jb = 2 * kk + 1;
        const unsigned pa[4] = {
            pack_bf16(__expf(s[ja][0] - m0) * l0, __expf(s[ja][1] - m0) * l0),
            pack_bf16(__expf(s[ja][2] - m1) * l1, __expf(s[ja][3] - m1) * l1),
            pack_bf16(__expf(s[jb][0] - m0) * l0, __expf(s[jb][1] - m0) * l0),
            pack_bf16(__expf(s[jb][2] - m1) * l1, __expf(s[jb][3] - m1) * l1)};
#pragma unroll
        for (int nd = 0; nd < DH / 16; ++nd) {
          unsigned vb[4];
          ldmatrix_x4_trans(
              vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      nd * 16 + (lane >> 4) * 8);
          mma_bf16_16816(o[2 * nd], pa, vb[0], vb[1]);
          mma_bf16_16816(o[2 * nd + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  if (!active) return;
  bf16* orow = out + ((size_t)b * T + r0 + g) * D + h * DH + 2 * t4;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (r0 + g < T)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][0], o[n][1]);
    if (r0 + g + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(orow + (size_t)8 * D + n * 8) =
          __floats2bfloat162_rn(o[n][2], o[n][3]);
  }
}

template <int DH>
int launch(const void* qkv, void* out, int B, int T, int H, float coef,
           cudaStream_t s) {
  constexpr int bytes = flash_smem_bytes<DH>();
  cudaFuncSetAttribute(attn_flash_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int BM = 16 * WARPS;
  attn_flash_kernel<DH><<<dim3((T + BM - 1) / BM, H, B), 32 * WARPS,
                                 bytes, s>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T, H, coef);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ep

// qkv (B, T, 3*H*Dh) bf16 -> out (B, T, H*Dh) bf16; coef = scale/temperature.
EP_EXPORT int ep_attn_flash(const void* qkv, void* out, int B, int T, int H,
                            int head_dim, float coef, void* stream) {
  if (T < 1 || B < 1 || B > 65535 || H > 65535 ||
      (head_dim != 64 && head_dim != 80))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? ep::launch<64>(qkv, out, B, T, H, coef, s)
                        : ep::launch<80>(qkv, out, B, T, H, coef, s);
}
