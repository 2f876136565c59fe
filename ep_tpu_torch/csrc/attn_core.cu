// Kernel B (attn_core): multi-head softmax attention on the natural-layout
// fused qkv tensor, (B, T, 3D) with columns [q heads | k heads | v heads], to
// (B, T, D) with each head written at its own column slice.
//
// Replaces: ep_tpu/ops/attn_fused_pallas.py::_kernel (attention_qkv_fused,
//   head width 64), which is also the core of the attention supercell in this
//   port, and ::_kernel_head_group (head width 80, ViT-H's 16 heads at T=257),
//   which the TPU needs only because 80 does not divide its 128 lanes; here
//   both head widths are one template.
//
// Bound on this card: at ViT-B (T=197, Dh=64) the two products are 61 GFLOP
//   per block at bs512 against 465 MB of qkv read, ~130 FLOP/byte, below the
//   bf16 ridge; the softmax's passes over the (T, T) logits cost instructions
//   and latency (with the logits in shared memory instead of registers the
//   kernel took 3.4 ms at bs512 on an H100, 8x this design).
// Design: one 128-thread block per (image, head). K and V of the head (keys
//   padded with zeros to the register tile) are staged once in shared memory
//   with cp.async 16-byte copies straight out of the qkv rows, so there is no
//   transpose copy and no (B,H,T,T) tensor in device memory. The 4 warps take
//   the 16-query-row tiles in turn. A warp keeps its whole 16 x T row block of
//   f32 logits in registers (mma.sync m16n8k16, bf16 in, f32 accumulate, fed
//   by ldmatrix), scales it by scale/temperature, masks the ragged key tail,
//   and runs the softmax there with quad shuffles. It normalises BEFORE PV, as
//   the TPU kernel does, and the bf16 probabilities go straight from the
//   logits' registers into the A operand of P @ V (the accumulator layout of
//   one m16n8 pair is the A layout of one k16 slice); PV accumulates in f32
//   and is rounded once to bf16. NT, the number of 8-key tiles held in
//   registers, is a template parameter (built for T <= 272), as is Dh (64 or
//   80). At ViT-H (Dh=80, T=257 -> NT=34) the logits take 136 registers a
//   thread and the PV accumulators 40; the build log's ptxas lines show
//   whether that spills.
#include "common.cuh"

namespace ep {
namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_T = 272;

// 8-key tiles held in registers for T keys: T padded to 16, in a few bins.
__host__ __device__ inline int key_tiles(int T) {
  return T <= 32 ? 4 : T <= 64 ? 8 : T <= 128 ? 16 : T <= 208 ? 26
       : T <= 256 ? 32 : 34;
}

template <int DH>
__host__ __device__ inline int smem_bytes(int T) {
  return (2 * key_tiles(T) * 8 + WARPS * 16) * (DH + 8) * 2;
}

template <int DH, int NT>
__global__ void __launch_bounds__(THREADS)
attn_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T,
                 int H, float coef) {
  constexpr int LD = DH + 8;  // shared row stride (bf16) of K, V and Q
  constexpr int CH = DH / 8;  // 16-byte chunks per head row
  constexpr int TK = NT * 8;  // keys staged, zero past T
  const int D = H * DH;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [TK][LD]
  bf16* Vs = Ks + TK * LD;                   // [TK][LD]
  bf16* Qs = Vs + TK * LD;                   // [WARPS][16][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bf16* base = qkv + (size_t)b * T * 3 * D + h * DH;

  for (int idx = tid; idx < TK * CH; idx += THREADS) {
    const int t = idx / CH, c = (idx % CH) * 8;
    if (t < T) {
      const bf16* row = base + (size_t)t * 3 * D + c;
      cp_async16(Ks + t * LD + c, row + D);
      cp_async16(Vs + t * LD + c, row + 2 * D);
    } else {
      *reinterpret_cast<uint4*>(Ks + t * LD + c) = zero_pack();
      *reinterpret_cast<uint4*>(Vs + t * LD + c) = zero_pack();
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  bf16* Qw = Qs + warp * 16 * LD;
  for (int r0 = warp * 16; r0 < T; r0 += WARPS * 16) {
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int r = idx / CH, c = (idx % CH) * 8;
      if (r0 + r < T)
        cp_async16(Qw + r * LD + c, base + (size_t)(r0 + r) * 3 * D + c);
      else
        *reinterpret_cast<uint4*>(Qw + r * LD + c) = zero_pack();
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    unsigned qa[DH / 16][4];
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd)
      ldmatrix_x4(qa[kd], Qw + (lane & 15) * LD + kd * 16 + (lane >> 4) * 8);

    // Logits: s[j] is the 16x8 tile of keys 8j..8j+7; this thread holds rows
    // g (s[j][0..1]) and g+8 (s[j][2..3]), columns 8j+2*t4 and +1.
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
        ldmatrix_x4(kb, Ks + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * j2], qa[kd], kb[0], kb[1]);
        mma_bf16_16816(s[2 * j2 + 1], qa[kd], kb[2], kb[3]);
      }
    }

    // f32 softmax of rows g and g+8; a row's 4 owners are one lane quad.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j * 8 + 2 * t4 + e < T;
        s[j][e] = ok ? s[j][e] * coef : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * coef : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = __expf(s[j][e] - mx0);
        s[j][2 + e] = __expf(s[j][2 + e] - mx1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;

    // O = P V: the probabilities of keys 16kk..16kk+15 form the A operand.
    float o[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0),
          pack_bf16(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1),
          pack_bf16(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0),
          pack_bf16(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1)};
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        unsigned vb[4];
        ldmatrix_x4_trans(
            vb, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    nd * 16 + (lane >> 4) * 8);
        mma_bf16_16816(o[2 * nd], pa, vb[0], vb[1]);
        mma_bf16_16816(o[2 * nd + 1], pa, vb[2], vb[3]);
      }
    }

    bf16* orow = out + ((size_t)b * T + r0 + g) * D + h * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      if (r0 + g < T)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[n][0], o[n][1]);
      if (r0 + g + 8 < T)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * D + n * 8) =
            __floats2bfloat162_rn(o[n][2], o[n][3]);
    }
    __syncwarp();
  }
}

template <int DH, int NT>
int launch(const void* qkv, void* out, int B, int T, int H, float coef,
           cudaStream_t s) {
  const int bytes = smem_bytes<DH>(T);
  cudaFuncSetAttribute(attn_core_kernel<DH, NT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  attn_core_kernel<DH, NT><<<dim3(H, B), THREADS, bytes, s>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T, H, coef);
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch(const void* qkv, void* out, int B, int T, int H, float coef,
             cudaStream_t s) {
  switch (key_tiles(T)) {
    case 4: return launch<DH, 4>(qkv, out, B, T, H, coef, s);
    case 8: return launch<DH, 8>(qkv, out, B, T, H, coef, s);
    case 16: return launch<DH, 16>(qkv, out, B, T, H, coef, s);
    case 26: return launch<DH, 26>(qkv, out, B, T, H, coef, s);
    case 32: return launch<DH, 32>(qkv, out, B, T, H, coef, s);
    default: return launch<DH, 34>(qkv, out, B, T, H, coef, s);
  }
}

}  // namespace
}  // namespace ep

// Dynamic shared memory the kernel needs at this T and head width; 0 when
// there is no instantiation for them (head width other than 64 or 80,
// T > 272).
EP_EXPORT int ep_attn_core_smem_bytes(int T, int head_dim) {
  if (T < 1 || T > ep::MAX_T) return 0;
  if (head_dim == 64) return ep::smem_bytes<64>(T);
  if (head_dim == 80) return ep::smem_bytes<80>(T);
  return 0;
}

// qkv (B, T, 3*H*Dh) bf16 -> out (B, T, H*Dh) bf16; coef = scale/temperature.
EP_EXPORT int ep_attn_core(const void* qkv, void* out, int B, int T, int H,
                           int head_dim, float coef, void* stream) {
  if (ep_attn_core_smem_bytes(T, head_dim) == 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? ep::dispatch<64>(qkv, out, B, T, H, coef, s)
                        : ep::dispatch<80>(qkv, out, B, T, H, coef, s);
}
