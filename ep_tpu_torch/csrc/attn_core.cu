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
// Rounding points, the TPU kernels': f32 logits times scale/temperature, an
//   exact f32 softmax normalised BEFORE PV, the probabilities rounded to bf16,
//   PV summed in f32 and rounded once. A 64-row query tile holds its whole
//   row of logits in registers, so there is one sweep, two products and one
//   exponential a (query, key) pair.
//
// Bound on this card: bytes. At ViT-B (bs512, T=197, 12 heads of width 64)
//   the two products are 61 GFLOP, 0.062 ms at 989 TFLOP/s, against 620 MB of
//   qkv in and o out, 0.185 ms; at ViT-H (bs128, T=257, 16 x 80) 0.055 against
//   0.101 ms. The padded work is larger: the query rows come in tiles of 64
//   (256 of 197 rows, 320 of 257) and the keys in the bins below (208 of 197,
//   272 of 257), and 16 exponentials a clock an SM take 0.05-0.07 ms.
// Design: the producer / consumer shape of hopper.cuh. Persistent blocks, one
//   an SM, walk the (image, head) items. One producer thread loads an item's
//   K and V (16-row boxes of a 3-D tensor map (images, T, 3D), zero-filled
//   past T inside each image) into one of two stages, so the next head's keys
//   arrive while this one runs, and each query tile (a 64-row box) into a
//   two-slot ring of the consumer that takes it. Two consumer warpgroups take
//   the query tiles of the block's items in turn, so that the 59 padded rows
//   of T=197 (4 tiles) cost no idle warpgroup and the 5th tile of T=257 (one
//   real row) goes to whichever is free; both share one staging of K and V.
//   A tile's query rows go to registers once (ldmatrix through the swizzle)
//   and the logits run in the RS form: chunks of 64 keys (m64n64k16), the
//   keys past the last 64 one m64n16 or m64n32 chunk, each chunk an
//   accumulator of its own shape. The mask (keys past T to -inf, as the TPU's
//   -1e30), scale, max, exponentials, sum and 1/sum work in place on the
//   accumulators; the normalised probabilities, packed to bf16, are the A
//   fragments of P V (the logits' accumulator layout is the A fragment's),
//   with V read N-major through the transpose bit. A head of width 80 is two
//   boxes of every tile, columns 0..63 in the 128-byte swizzle and 64..79 in
//   the 32-byte one: the logits take 4 + 1 K steps, P V an N=64 and an N=16
//   product. O leaves through the tile's own query slot: rounded to bf16 in
//   the swizzled layout, one TMA store a box, rows past T not written.
//   What ptxas's serialisation rules (PERF.md) shaped: the warpgroup index is
//   broadcast by a shuffle so that no wgmma sits behind a branch ptxas takes
//   for divergent; every accumulator keeps one N; the logits are one buffer
//   and P one buffer, never two of either live around a wgmma. ptxas
//   serialises none of them.
// Measured on an H100 (PERF.md): 0.295 ms at ViT-B (SDPA 0.336) and 0.189
//   at ViT-H (SDPA 0.309), 1.6 and 1.9 times the bytes bound; at T=256 ViT-H
//   takes 0.146, so the fifth query tile of T=257 (one real row) and the
//   N=16 chunk cost about a quarter.
#include "hopper.cuh"

namespace ep {
namespace {

using namespace hopper;

constexpr int NC = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (NC + 1);  // and one producer warpgroup
constexpr int BQ = 64;                   // query rows of a tile
constexpr int BOX_K = 16;                // key rows of a TMA box
constexpr int QSLOTS = 2;                // query tiles in flight a consumer
constexpr int MAX_T = 272;
constexpr float LOG2E = 1.4426950408889634f;

// Keys held in registers for T keys: T rounded up into one of six bins.
__host__ __device__ constexpr int bin_keys(int T) {
  return T <= 32 ? 32 : T <= 64 ? 64 : T <= 128 ? 128 : T <= 208 ? 208
       : T <= 256 ? 256 : 272;
}

// A block's shared memory: two stages of [K0][V0][K1][V1] for KEYS keys, then
// the consumers' query slots [Q0][Q1] (also their output staging), then the
// barriers. X0 are columns 0..63 (rows of 128 bytes), X1 columns 64..DH-1.
template <int DH, int KEYS>
struct Core {
  static constexpr int NB = KEYS / 64, NT = KEYS % 64;  // full chunks, tail
  static constexpr int R1 = DH - 64;
  static constexpr int K0 = KEYS * 128, K1 = KEYS * R1 * 2;
  static constexpr int STAGE = 2 * (K0 + K1);
  static constexpr int Q0 = BQ * 128, QSLOT = Q0 + BQ * R1 * 2;
  static constexpr int BARS = 4 + 2 * NC * QSLOTS;
  static constexpr int SMEM = 1024 + 2 * STAGE + NC * QSLOTS * QSLOT + BARS * 8;
};
static_assert(Core<80, MAX_T>::SMEM <= MAX_SMEM, "kernel B fits a block");

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DH, int KEYS>
__global__ void __launch_bounds__(THREADS, 1)
attn_core_kernel(const __grid_constant__ CUtensorMap map_q0,
                 const __grid_constant__ CUtensorMap map_q1,
                 const __grid_constant__ CUtensorMap map_kv0,
                 const __grid_constant__ CUtensorMap map_kv1,
                 const __grid_constant__ CUtensorMap map_o0,
                 const __grid_constant__ CUtensorMap map_o1, int B, int T,
                 int H, float coef) {
  using L = Core<DH, KEYS>;
  constexpr int NB = L::NB, NT = L::NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qbase = smem + 2 * L::STAGE;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(qbase + NC * QSLOTS * L::QSLOT);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* q_full = kv_empty + 2;          // [NC][QSLOTS]
  uint64_t* q_empty = q_full + NC * QSLOTS;  // [NC][QSLOTS]
  auto k0_s = [&](int s) { return smem + s * L::STAGE; };
  auto v0_s = [&](int s) { return smem + s * L::STAGE + L::K0; };
  auto k1_s = [&](int s) { return smem + s * L::STAGE + 2 * L::K0; };
  auto v1_s = [&](int s) { return smem + s * L::STAGE + 2 * L::K0 + L::K1; };
  auto q_s = [&](int w, int slot) { return qbase + (w * QSLOTS + slot) * L::QSLOT; };

  const int tid = threadIdx.x;
  const int D = H * DH;
  const int nq = (T + BQ - 1) / BQ;
  const int items = B * H;
  const int n_local = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(kv_full + s, 1);
      mbar_init(kv_empty + s, 4 * NC);  // an arrival a consumer warp
    }
    for (int i = 0; i < NC * QSLOTS; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 1);  // the thread that stored the tile's O
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, broadcast so that the compiler sees that it is uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == NC) {
    // registers move only within the block: 128 x 144 freed here, 256 x 72
    // taken by the consumers
    setmaxnreg_dec<24>();
    if (tid == 128 * NC) {
      int u = 0;  // tiles of the block so far; consumer u % NC takes tile u
      for (int j = 0; j < n_local; ++j) {
        const int item = blockIdx.x + j * gridDim.x;
        const int h = item % H, b = item / H, st = j & 1;
        if (j >= 2) mbar_wait(kv_empty + st, ((j - 2) >> 1) & 1);
        mbar_expect_tx(kv_full + st, L::STAGE);
        for (int r = 0; r < KEYS; r += BOX_K) {
          tma_load_3d(k0_s(st) + r * 128, &map_kv0, kv_full + st, D + h * DH, r, b);
          tma_load_3d(v0_s(st) + r * 128, &map_kv0, kv_full + st, 2 * D + h * DH,
                      r, b);
          if constexpr (L::R1 > 0) {
            tma_load_3d(k1_s(st) + r * L::R1 * 2, &map_kv1, kv_full + st,
                        D + h * DH + 64, r, b);
            tma_load_3d(v1_s(st) + r * L::R1 * 2, &map_kv1, kv_full + st,
                        2 * D + h * DH + 64, r, b);
          }
        }
        for (int qt = 0; qt < nq; ++qt, ++u) {
          const int w = u % NC, k = u / NC;  // the k-th tile of consumer w
          const int slot = k % QSLOTS, use = k / QSLOTS;
          uint64_t* full = q_full + w * QSLOTS + slot;
          if (use > 0) mbar_wait(q_empty + w * QSLOTS + slot, (use - 1) & 1);
          mbar_expect_tx(full, L::QSLOT);
          tma_load_3d(q_s(w, slot), &map_q0, full, h * DH, qt * BQ, b);
          if constexpr (L::R1 > 0)
            tma_load_3d(q_s(w, slot) + L::Q0, &map_q1, full, h * DH + 64,
                        qt * BQ, b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int t = lane & 3;
  const float c2 = coef * LOG2E;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int released = 0;  // items whose K and V this consumer has handed back

  for (int u = wg; u < n_local * nq; u += NC) {
    const int j = u / nq, qt = u % nq, k = u / NC;
    const int item = blockIdx.x + j * gridDim.x;
    const int h = item % H, b = item / H, st = j & 1;
    for (; released < j; ++released) release(kv_empty + (released & 1));
    const int slot = k % QSLOTS;
    unsigned char* qs = q_s(wg, slot);
    mbar_wait(q_full + wg * QSLOTS + slot, (k / QSLOTS) & 1);
    unsigned qf[DH / 16][4];
    load_head_rows<DH>(qf, qs, qs + L::Q0, 0, warp, lane);
    mbar_wait(kv_full + st, (j >> 1) & 1);

    // Logits: s[c] holds keys 64c.. of the tile's rows, sl the keys past the
    // last full chunk. Thread (warp, g, t) holds rows 16*warp + g (elements
    // e with e & 2 == 0) and + 8, keys 8*(e / 4) + 2t + (e & 1) of a chunk.
    float s[NB > 0 ? NB : 1][32], sl[NT > 0 ? NT / 2 : 1];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const uint64_t dk0 = smem_desc(k0_s(st) + c * 64 * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_rs<64>(s[c], qf[kk], dk0 + kk * DESC_K_STEP, kk);
      if constexpr (L::R1 > 0)
        wgmma_bf16_rs<64>(s[c], qf[4], smem_desc_32(k1_s(st) + c * 64 * 32), 1);
    }
    if constexpr (NT > 0) {
      const uint64_t dk0 = smem_desc(k0_s(st) + NB * 64 * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_rs<NT>(sl, qf[kk], dk0 + kk * DESC_K_STEP, kk);
      if constexpr (L::R1 > 0)
        wgmma_bf16_rs<NT>(sl, qf[4], smem_desc_32(k1_s(st) + NB * 64 * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NB; ++c) keep_all(s[c]);
    if constexpr (NT > 0) keep_all(sl);

    // f32 softmax of the two rows, in place: scaled logits (keys past T at
    // -inf), then exponentials; a row's four owners are one lane quad.
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
    auto scale_max = [&](float& v, int key, int e) {
      v = key < T ? v * c2 : -INFINITY;
      float& m = mx[(e >> 1) & 1][(e >> 2) & 1];
      m = fmaxf(m, v);
    };
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        scale_max(s[c][e], 64 * c + 8 * (e >> 2) + 2 * t + (e & 1), e);
#pragma unroll
    for (int e = 0; e < NT / 2; ++e)
      scale_max(sl[e], 64 * NB + 8 * (e >> 2) + 2 * t + (e & 1), e);
    float m[2], sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(mx[r][0], mx[r][1]);
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
    // key 0 is in every tile's row, so m is finite
    auto expo = [&](float& v, int e) {
      v = exp2_approx(v - m[(e >> 1) & 1]);
      sum[(e >> 1) & 1][(e >> 2) & 1] += v;
    };
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) expo(s[c][e], e);
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) expo(sl[e], e);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = sum[r][0] + sum[r][1];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      inv[r] = 1.f / v;
    }

    // P, normalised and rounded to bf16: keys 16ks..16ks+15 form the A
    // fragment of P V's K step ks.
    unsigned pf[KEYS / 16][4];
    auto pack = [&](unsigned (&f)[4], const auto& v, int o) {
      f[0] = pack_bf16(v[o] * inv[0], v[o + 1] * inv[0]);
      f[1] = pack_bf16(v[o + 2] * inv[1], v[o + 3] * inv[1]);
      f[2] = pack_bf16(v[o + 4] * inv[0], v[o + 5] * inv[0]);
      f[3] = pack_bf16(v[o + 6] * inv[1], v[o + 7] * inv[1]);
    };
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack(pf[4 * c + kk], s[c], 8 * kk);
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk) pack(pf[4 * NB + kk], sl, 8 * kk);

    float o0[32], o1[8];
#pragma unroll
    for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) o1[i] = 0.f;
    {
      const uint64_t dv0 = smem_desc(v0_s(st)), dv1 = smem_desc_32(v1_s(st));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KEYS / 16; ++ks) {
        wgmma_bf16_rs_tb<64>(o0, pf[ks], dv0 + ks * (16 * 128 >> 4), 1);
        if constexpr (L::R1 > 0)
          wgmma_bf16_rs_tb<16>(o1, pf[ks], dv1 + ks * (16 * 32 >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep_all(o0);
      keep_all(o1);
#pragma unroll
      for (int ks = 0; ks < KEYS / 16; ++ks) keep_all(pf[ks]);
    }

    // O through the query slot: every warp of the warpgroup is past its
    // reads of Q (the first wgmma needed all four), rows past T are clipped
    // by the store.
    named_barrier(1 + wg, 128);
    stage_head_rows<DH>(qs, qs + L::Q0, o0, o1, warp, lane);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if ((tid & 127) == 0) {
      tma_store_3d(&map_o0, qs, h * DH, qt * BQ, b);
      if constexpr (L::R1 > 0)
        tma_store_3d(&map_o1, qs + L::Q0, h * DH + 64, qt * BQ, b);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(q_empty + wg * QSLOTS + slot);
    }
  }
  for (; released < n_local; ++released) release(kv_empty + (released & 1));
  if ((tid & 127) == 0) bulk_wait();
}

template <int DH, int KEYS>
int launch(const void* qkv, void* out, int B, int T, int H, float coef,
           cudaStream_t s) {
  using L = Core<DH, KEYS>;
  CUtensorMap mq[2], mkv[2], mo[2];
  int rc = make_head_maps(mq, qkv, DH, B, T, 3 * H * DH, BQ);
  if (rc == 0) rc = make_head_maps(mkv, qkv, DH, B, T, 3 * H * DH, BOX_K);
  if (rc == 0) rc = make_head_maps(mo, out, DH, B, T, H * DH, BQ);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(attn_core_kernel<DH, KEYS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  const long long items = (long long)B * H;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items < sm_count() ? (int)items : sm_count();
  attn_core_kernel<DH, KEYS><<<grid, THREADS, L::SMEM, s>>>(
      mq[0], mq[1], mkv[0], mkv[1], mo[0], mo[1], B, T, H, coef);
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch(const void* qkv, void* out, int B, int T, int H, float coef,
             cudaStream_t s) {
  switch (bin_keys(T)) {
    case 32: return launch<DH, 32>(qkv, out, B, T, H, coef, s);
    case 64: return launch<DH, 64>(qkv, out, B, T, H, coef, s);
    case 128: return launch<DH, 128>(qkv, out, B, T, H, coef, s);
    case 208: return launch<DH, 208>(qkv, out, B, T, H, coef, s);
    case 256: return launch<DH, 256>(qkv, out, B, T, H, coef, s);
    default: return launch<DH, 272>(qkv, out, B, T, H, coef, s);
  }
}

template <int DH>
int smem_bytes(int T) {
  switch (bin_keys(T)) {
    case 32: return Core<DH, 32>::SMEM;
    case 64: return Core<DH, 64>::SMEM;
    case 128: return Core<DH, 128>::SMEM;
    case 208: return Core<DH, 208>::SMEM;
    case 256: return Core<DH, 256>::SMEM;
    default: return Core<DH, 272>::SMEM;
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
  if (ep_attn_core_smem_bytes(T, head_dim) == 0 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? ep::dispatch<64>(qkv, out, B, T, H, coef, s)
                        : ep::dispatch<80>(qkv, out, B, T, H, coef, s);
}
