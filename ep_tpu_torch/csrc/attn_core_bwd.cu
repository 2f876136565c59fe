// Kernel E (attn_core_bwd): the backward of kernel B. From the fused qkv
// tensor (B, T, 3D) and the output cotangent dO (B, T, D), both bf16 in their
// natural layout, it writes dqkv (B, T, 3D) bf16 with columns
// [dq heads | dk heads | dv heads], at the TPU kernel's cast points:
//   A  = softmax(coef * q k^T)                   f32, normalised
//   dV = bf16(A)^T dO,  dA = dO V^T              f32 sums
//   dL = bf16(A * (dA - rowsum(A * dA)) * coef)
//   dQ = dL K,  dK = dL^T Q                      f32 sums, one bf16 rounding
// with coef = scale / temperature; rowsum(A * dA) is an f32 sum of the f32 A
// times dA (not dO . O, which went through bf16(A) and a bf16 rounding).
//
// Replaces: ep_tpu/ops/attn_fused_pallas.py::_bwd_kernel (head width 64) and
//   ::_bwd_kernel_head_group (head width 80, ViT-H), the in-VMEM Pallas
//   backward that the attention supercell's backward runs under --finetuning.
//
// Bound on this card: bytes. The five products are 10*T*T*Dh FLOP an (image,
//   head) against 14*T*Dh bytes in and out: at ViT-B (bs512, T=197, 12 x 64)
//   0.153 ms of products at 989 TFLOP/s against 0.324 ms of bytes, at ViT-H
//   (bs128, T=257, 16 x 80) 0.135 against 0.176. The padded products the
//   kernel runs are more: 7 of them on tiles of 64 rows (256 x 256 at T=197,
//   320 x 320 at T=257).
// Design: 7 products an (image, head), each issued as wgmma, where the
//   function needs 5. Persistent blocks, one an SM, walk the (image, head)
//   items; one producer thread loads Q, K, V and dO of the item's head into
//   shared memory by TMA (64-row boxes of 3-D tensor maps (images, T, cols),
//   zero-filled past T inside each image), each 64-row tile of Q and dO on a
//   barrier of its own so that pass 1 starts on the first tile. Two consumer
//   warpgroups of 240 registers a thread:
//   Pass 1, query-stationary, 3 products: both warpgroups take the same 64
//     query rows and split the keys (R/2 each, R the staged rows), so that a
//     warpgroup holds its logits S and dA = dO V^T for its keys in registers
//     at once (S and dA for a whole row would need twice the registers a
//     thread has). Each forms its rows' max, sum of exponentials and sum of
//     exp * dA over its keys; one exchange through shared memory gives both
//     the row's max, 1/sum and rowsum(A * dA) in the same order; each forms
//     dL = bf16(A * (dA - rowsum) * coef) for its keys in registers (the
//     accumulator layout is the A fragment's) and runs dQ += dL K with K read
//     N-major. The two partial dQ meet in shared memory and are summed in a
//     fixed order, warpgroup 0's keys then warpgroup 1's, so E is
//     deterministic; dQ leaves by TMA store. The row statistics go to shared
//     memory.
//   Pass 2, key-stationary, 4 products: each warpgroup takes 64-key tiles in
//     turn, with its K and V rows in registers, and sweeps the queries in
//     64-row blocks: S^T = K Q^T and dA^T = V dO^T, A^T and dL^T from the row
//     statistics, dV += bf16(A^T) dO and dK += dL^T Q with dO and Q read
//     N-major. dK and dV leave through shared memory by TMA store.
//   Seven products and not five: holding S and dA for a row once (pass 1)
//   gives dQ but not dK and dV, whose sums run over queries; summing those
//   across query tiles in a fixed order would need an f32 dK and dV of the
//   whole head in shared memory, which at T=257 does not fit beside the
//   staged head. The K and V of the next item come in under pass 2, once
//   both warpgroups hold their last K and V rows in registers; its Q and dO
//   when pass 2 is over. The staged head and a 64 x Dh f32 exchange take
//   4 * R * Dh * 2 + 256 * Dh bytes: T <= 320 at head width 80 and T <= 384
//   at 64, the limits of the mma.sync design this one replaces.
//   What ptxas's serialisation rules (PERF.md) shaped: the warpgroup index
//   is broadcast by a shuffle (the key split is an address, not a branch);
//   every accumulator keeps one N (pass 1's keys past the last 64 are a
//   chunk of their own); pass 2 issues its next S^T only after the products
//   of the current block have retired. ptxas serialises none of them but the
//   384-row bin's (head width 64, T > 320: S and dA of 192 keys a thread).
// Measured on an H100 (PERF.md): 1.021 ms at ViT-B (SDPA's backward 1.317)
//   and 0.613 at ViT-H (0.947), 3.2 and 3.5 times the bytes bound. Neither
//   the exponentials in flight under the next product nor sharing ViT-H's
//   odd key tile between the warpgroups changed that: the two warpgroups
//   share the SM's issue slots, exponentials and shared-memory loads.
#include "hopper.cuh"

namespace ep {
namespace {

using namespace hopper;

constexpr int NC = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (NC + 1);  // and one producer warpgroup
constexpr int BT = 64;                   // rows of a tile
constexpr int MAX_TILES = 6;             // 64-row tiles of the longest head
constexpr float LOG2E = 1.4426950408889634f;

// Rows staged for T: T rounded up into one of four bins (a multiple of 128
// up to 256, then of 64), so that the two halves of pass 1 are multiples of
// 32 keys.
__host__ __device__ constexpr int bin_rows(int T) {
  return T <= 128 ? 128 : T <= 256 ? 256 : T <= 320 ? 320 : 384;
}

// A block's shared memory: the staged head [Q0][K0][V0][G0][Q1][K1][V1][G1]
// (G is dO; X0 columns 0..63 as rows of 128 bytes, X1 columns 64..DH-1 as
// rows of 32 bytes), the scratch for pass 1's dQ exchange and the output
// staging, pass 1's statistics exchange, the row statistics, the barriers.
template <int DH, int R>
struct Bwd {
  static constexpr int KW = R / 2;                    // pass 1 keys a consumer
  static constexpr int NB = KW / 64, NT = KW % 64;    // full chunks, tail
  static constexpr int R1 = DH - 64;
  static constexpr int A0 = R * 128, A1 = R * R1 * 2;  // bytes of an array
  static constexpr int HEAD = 4 * (A0 + A1);
  static constexpr int TILE0 = BT * 128, TILE = BT * DH * 2;  // a staging tile
  static constexpr int SCRATCH = NC * TILE;  // = 128 threads x DH/2 f32
  static constexpr int XSTAT = NC * BT * 3 * 4;
  static constexpr int RSTAT = 3 * R * 4;
  static constexpr int BARS = 3 + MAX_TILES;
  static constexpr int SMEM = 1024 + HEAD + SCRATCH + XSTAT + RSTAT + BARS * 8;
};
static_assert(Bwd<80, 320>::SMEM <= MAX_SMEM, "kernel E fits a block at Dh=80");
static_assert(Bwd<64, 384>::SMEM <= MAX_SMEM, "kernel E fits a block at Dh=64");
static_assert(Bwd<80, 320>::SCRATCH == 128 * 40 * 4, "dQ exchange fits");

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DH, int R>
__global__ void __launch_bounds__(THREADS, 1)
attn_core_bwd_kernel(const __grid_constant__ CUtensorMap map_x0,
                     const __grid_constant__ CUtensorMap map_x1,
                     const __grid_constant__ CUtensorMap map_g0,
                     const __grid_constant__ CUtensorMap map_g1,
                     const __grid_constant__ CUtensorMap map_d0,
                     const __grid_constant__ CUtensorMap map_d1, int B, int T,
                     int H, float coef) {
  using L = Bwd<DH, R>;
  constexpr int KW = L::KW, NB = L::NB, NT = L::NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  // arrays 0..3 (Q, K, V, dO): columns 0..63 at a0(i), 64..DH-1 at a1(i)
  auto a0 = [&](int i) { return smem + i * L::A0; };
  auto a1 = [&](int i) { return smem + 4 * L::A0 + i * L::A1; };
  unsigned char* scratch = smem + L::HEAD;
  float* xstat = reinterpret_cast<float*>(scratch + L::SCRATCH);  // [NC][3][BT]
  float* row_max = xstat + NC * 3 * BT;  // [R] max of the scaled logits
  float* row_inv = row_max + R;          // [R] 1 / sum, 0 past T
  float* row_dot = row_inv + R;          // [R] rowsum(A * dA)
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(row_dot + R);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* qd_empty = kv_full + 2;
  uint64_t* qd_full = kv_full + 3;  // [MAX_TILES]

  const int tid = threadIdx.x;
  const int D = H * DH;
  const int nt = (T + BT - 1) / BT;  // 64-row tiles of queries and of keys
  const int items = B * H;
  const int n_local = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * NC);  // an arrival a consumer warp
    mbar_init(qd_empty, 4 * NC);
    for (int i = 0; i < MAX_TILES; ++i) mbar_init(qd_full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == NC) {
    // registers move only within the block: 128 x 144 freed here, 256 x 72
    // taken by the consumers
    setmaxnreg_dec<24>();
    if (tid == 128 * NC) {
      for (int j = 0; j < n_local; ++j) {
        const int item = blockIdx.x + j * gridDim.x;
        const int h = item % H, b = item / H;
        // K and V of all R rows: pass 1 reads keys up to R, zero past T
        if (j > 0) mbar_wait(kv_empty, (j - 1) & 1);
        mbar_expect_tx(kv_full, 2 * (L::A0 + L::A1));
        for (int r = 0; r < R; r += BT)
#pragma unroll
          for (int x = 1; x <= 2; ++x) {
            tma_load_3d(a0(x) + r * 128, &map_x0, kv_full, x * D + h * DH, r, b);
            if constexpr (L::R1 > 0)
              tma_load_3d(a1(x) + r * L::R1 * 2, &map_x1, kv_full,
                          x * D + h * DH + 64, r, b);
          }
        // Q and dO, a barrier a 64-row tile
        if (j > 0) mbar_wait(qd_empty, (j - 1) & 1);
        for (int qt = 0; qt < nt; ++qt) {
          const int r = qt * BT;
          mbar_expect_tx(qd_full + qt, 2 * L::TILE);
          tma_load_3d(a0(0) + r * 128, &map_x0, qd_full + qt, h * DH, r, b);
          tma_load_3d(a0(3) + r * 128, &map_g0, qd_full + qt, h * DH, r, b);
          if constexpr (L::R1 > 0) {
            tma_load_3d(a1(0) + r * L::R1 * 2, &map_x1, qd_full + qt,
                        h * DH + 64, r, b);
            tma_load_3d(a1(3) + r * L::R1 * 2, &map_g1, qd_full + qt,
                        h * DH + 64, r, b);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int ct = tid & 127;  // thread of the warpgroup
  const int warp = ct >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c2 = coef * LOG2E;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // The 64 x DH staging tile of warpgroup w, and a TMA store of it at
  // column col, row row0 of dqkv.
  auto stage = [&](int w) { return scratch + w * L::TILE; };
  auto store = [&](int w, int col, int row0, int b) {
    fence_proxy_async();
    named_barrier(3 + w, 128);
    if (ct == 0) {
      tma_store_3d(&map_d0, stage(w), col, row0, b);
      if constexpr (L::R1 > 0)
        tma_store_3d(&map_d1, stage(w) + L::TILE0, col + 64, row0, b);
      bulk_commit();
      bulk_wait_read();
    }
    named_barrier(3 + w, 128);
  };

  for (int j = 0; j < n_local; ++j) {
    const int item = blockIdx.x + j * gridDim.x;
    const int h = item % H, b = item / H;
    const unsigned par = j & 1;
    const int kbase = wg * KW;  // this consumer's keys in pass 1
    mbar_wait(kv_full, par);

    // ---- pass 1: a 64-row query tile at a time, the keys split in two ------
    // Thread (warp, g, t) holds rows 16*warp + g (elements e with
    // e & 2 == 0) and + 8 of the tile, keys kbase + 64c + 8*(e/4) + 2t +
    // (e & 1) of chunk c.
    for (int qt = 0; qt < nt; ++qt) {
      mbar_wait(qd_full + qt, par);
      float s[NB][32], da[NB][32], sl[NT > 0 ? NT / 2 : 1], dal[NT > 0 ? NT / 2 : 1];
      {
        unsigned qf[DH / 16][4], gf[DH / 16][4];
        load_head_rows<DH>(qf, a0(0), a1(0), qt * BT, warp, lane);
        load_head_rows<DH>(gf, a0(3), a1(3), qt * BT, warp, lane);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const int k0 = kbase + 64 * c;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_bf16_rs<64>(s[c], qf[kk], smem_desc(a0(1) + k0 * 128) + kk * DESC_K_STEP, kk);
            wgmma_bf16_rs<64>(da[c], gf[kk], smem_desc(a0(2) + k0 * 128) + kk * DESC_K_STEP, kk);
          }
          if constexpr (L::R1 > 0) {
            wgmma_bf16_rs<64>(s[c], qf[4], smem_desc_32(a1(1) + k0 * 32), 1);
            wgmma_bf16_rs<64>(da[c], gf[4], smem_desc_32(a1(2) + k0 * 32), 1);
          }
        }
        if constexpr (NT > 0) {
          const int k0 = kbase + 64 * NB;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_bf16_rs<NT>(sl, qf[kk], smem_desc(a0(1) + k0 * 128) + kk * DESC_K_STEP, kk);
            wgmma_bf16_rs<NT>(dal, gf[kk], smem_desc(a0(2) + k0 * 128) + kk * DESC_K_STEP, kk);
          }
          if constexpr (L::R1 > 0) {
            wgmma_bf16_rs<NT>(sl, qf[4], smem_desc_32(a1(1) + k0 * 32), 1);
            wgmma_bf16_rs<NT>(dal, gf[4], smem_desc_32(a1(2) + k0 * 32), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          keep_all(s[c]);
          keep_all(da[c]);
        }
        if constexpr (NT > 0) {
          keep_all(sl);
          keep_all(dal);
        }
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          keep_all(qf[kk]);
          keep_all(gf[kk]);
        }
      }

      // this consumer's share of the rows' max, sum of exp and sum of
      // exp * dA, in place: scaled logits (keys past T at -inf), then
      // exponentials against this share's max
      float m[2] = {-INFINITY, -INFINITY};
      auto scale_max = [&](float& v, int key, int e) {
        v = key < T ? v * c2 : -INFINITY;
        m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], v);
      };
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          scale_max(s[c][e], kbase + 64 * c + 8 * (e >> 2) + 2 * t + (e & 1), e);
#pragma unroll
      for (int e = 0; e < NT / 2; ++e)
        scale_max(sl[e], kbase + 64 * NB + 8 * (e >> 2) + 2 * t + (e & 1), e);
      float ms[2], l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
        ms[r] = m[r] == -INFINITY ? 0.f : m[r];  // a share with no key below T
      }
      auto expo = [&](float& v, float dav, int e) {
        const int r = (e >> 1) & 1;
        v = exp2_approx(v - ms[r]);
        l[r] += v;
        d[r] = fmaf(v, dav, d[r]);
      };
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) expo(s[c][e], da[c][e], e);
#pragma unroll
      for (int e = 0; e < NT / 2; ++e) expo(sl[e], dal[e], e);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
      }
      // the exchange: both consumers combine the two shares in the same
      // order, so both hold the same max, 1/sum and rowsum(A * dA)
      const int row[2] = {16 * warp + g, 16 * warp + g + 8};
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          xstat[(wg * 3 + 0) * BT + row[r]] = m[r];
          xstat[(wg * 3 + 1) * BT + row[r]] = l[r];
          xstat[(wg * 3 + 2) * BT + row[r]] = d[r];
        }
      }
      named_barrier(1, 256);
      float own[2], inv[2], dot[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mw[NC], f[NC], mx = -INFINITY, lsum = 0.f, dsum = 0.f;
#pragma unroll
        for (int w = 0; w < NC; ++w) {
          mw[w] = xstat[(w * 3) * BT + row[r]];
          mx = fmaxf(mx, mw[w]);
        }
#pragma unroll
        for (int w = 0; w < NC; ++w) {
          f[w] = mw[w] == -INFINITY ? 0.f : exp2_approx(mw[w] - mx);
          lsum = fmaf(xstat[(w * 3 + 1) * BT + row[r]], f[w], lsum);
          dsum = fmaf(xstat[(w * 3 + 2) * BT + row[r]], f[w], dsum);
        }
        inv[r] = 1.f / lsum;
        dot[r] = dsum * inv[r];
        own[r] = (wg == 0 ? f[0] : f[1]) * inv[r];  // exp -> A for this share
        if (wg == 0 && t == 0) {
          const int q = qt * BT + row[r];
          row_max[q] = mx;
          row_inv[q] = q < T ? inv[r] : 0.f;  // rows past T drop out of pass 2
          row_dot[q] = dot[r];
        }
      }

      // dL = bf16(A * (dA - rowsum) * coef): keys 16ks..16ks+15 of this
      // share form the A fragment of dQ's K step ks
      unsigned lf[KW / 16][4];
      auto dl = [&](float v, float dav, int e) {
        const int r = (e >> 1) & 1;
        return v * own[r] * (dav - dot[r]) * coef;
      };
      auto pack = [&](unsigned (&f)[4], const auto& v, const auto& dav, int o) {
        f[0] = pack_bf16(dl(v[o], dav[o], 0), dl(v[o + 1], dav[o + 1], 1));
        f[1] = pack_bf16(dl(v[o + 2], dav[o + 2], 2), dl(v[o + 3], dav[o + 3], 3));
        f[2] = pack_bf16(dl(v[o + 4], dav[o + 4], 4), dl(v[o + 5], dav[o + 5], 5));
        f[3] = pack_bf16(dl(v[o + 6], dav[o + 6], 6), dl(v[o + 7], dav[o + 7], 7));
      };
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) pack(lf[4 * c + kk], s[c], da[c], 8 * kk);
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk) pack(lf[4 * NB + kk], sl, dal, 8 * kk);

      float q0[32], q1[8];
#pragma unroll
      for (int i = 0; i < 32; ++i) q0[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) q1[i] = 0.f;
      {
        const uint64_t dk0 = smem_desc(a0(1) + kbase * 128);
        const uint64_t dk1 = smem_desc_32(a1(1) + kbase * 32);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KW / 16; ++ks) {
          wgmma_bf16_rs_tb<64>(q0, lf[ks], dk0 + ks * (16 * 128 >> 4), 1);
          if constexpr (L::R1 > 0)
            wgmma_bf16_rs_tb<16>(q1, lf[ks], dk1 + ks * (16 * 32 >> 4), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        keep_all(q0);
        keep_all(q1);
#pragma unroll
        for (int ks = 0; ks < KW / 16; ++ks) keep_all(lf[ks]);
      }

      // dQ = warpgroup 0's keys + warpgroup 1's, through the scratch
      float* xq = reinterpret_cast<float*>(scratch);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) xq[i * 128 + ct] = q0[i];
#pragma unroll
        for (int i = 0; i < DH / 2 - 32; ++i) xq[(32 + i) * 128 + ct] = q1[i];
      }
      named_barrier(2, 256);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) q0[i] += xq[i * 128 + ct];
#pragma unroll
        for (int i = 0; i < DH / 2 - 32; ++i) q1[i] += xq[(32 + i) * 128 + ct];
        named_barrier(3, 128);  // the partial is read: the scratch is free
        stage_head_rows<DH>(stage(0), stage(0) + L::TILE0, q0, q1, warp, lane);
        store(0, h * DH, qt * BT, b);
      }
    }
    named_barrier(1, 256);  // the row statistics are complete

    // ---- pass 2: a 64-key tile a consumer, the queries swept ---------------
    // Thread (warp, g, t) holds keys k0 + 16*warp + g and + 8, queries
    // q0 + 8*(e/4) + 2t + (e & 1) of the block.
    bool kv_held = true;
    for (int kt = wg; kt < nt; kt += NC) {
      const int k0 = kt * BT;
      unsigned kf[DH / 16][4], vf[DH / 16][4];
      load_head_rows<DH>(kf, a0(1), a1(1), k0, warp, lane);
      load_head_rows<DH>(vf, a0(2), a1(2), k0, warp, lane);
      if (kt + NC >= nt) {  // the last K and V rows this consumer reads
        release(kv_empty);
        kv_held = false;
      }
      float dk0[32], dk1[8], dv0[32], dv1[8];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk0[i] = dv0[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dk1[i] = dv1[i] = 0.f;
      for (int qb = 0; qb < nt; ++qb) {
        const int r0 = qb * BT;
        float st[32], dt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_bf16_rs<64>(st, kf[kk], smem_desc(a0(0) + r0 * 128) + kk * DESC_K_STEP, kk);
          wgmma_bf16_rs<64>(dt, vf[kk], smem_desc(a0(3) + r0 * 128) + kk * DESC_K_STEP, kk);
        }
        if constexpr (L::R1 > 0) {
          wgmma_bf16_rs<64>(st, kf[4], smem_desc_32(a1(0) + r0 * 32), 1);
          wgmma_bf16_rs<64>(dt, vf[4], smem_desc_32(a1(3) + r0 * 32), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        keep_all(st);
        keep_all(dt);

        // A^T and dL^T: query q's statistics; rows (keys) past T are never
        // stored, queries past T have 1/sum = 0
        unsigned af[4][4], lf[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          float av[8], lv[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int e = 8 * ks + x;
            const int q = r0 + 8 * (e >> 2) + 2 * t + (e & 1);
            const float a = exp2_approx(fmaf(st[e], c2, -row_max[q])) * row_inv[q];
            av[x] = a;
            lv[x] = a * (dt[e] - row_dot[q]) * coef;
          }
          af[ks][0] = pack_bf16(av[0], av[1]);
          af[ks][1] = pack_bf16(av[2], av[3]);
          af[ks][2] = pack_bf16(av[4], av[5]);
          af[ks][3] = pack_bf16(av[6], av[7]);
          lf[ks][0] = pack_bf16(lv[0], lv[1]);
          lf[ks][1] = pack_bf16(lv[2], lv[3]);
          lf[ks][2] = pack_bf16(lv[4], lv[5]);
          lf[ks][3] = pack_bf16(lv[6], lv[7]);
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int off = (r0 + 16 * ks) * 128 >> 4, off1 = (r0 + 16 * ks) * 32 >> 4;
          wgmma_bf16_rs_tb<64>(dv0, af[ks], smem_desc(a0(3)) + off, 1);
          wgmma_bf16_rs_tb<64>(dk0, lf[ks], smem_desc(a0(0)) + off, 1);
          if constexpr (L::R1 > 0) {
            wgmma_bf16_rs_tb<16>(dv1, af[ks], smem_desc_32(a1(3)) + off1, 1);
            wgmma_bf16_rs_tb<16>(dk1, lf[ks], smem_desc_32(a1(0)) + off1, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        keep_all(dk0);
        keep_all(dk1);
        keep_all(dv0);
        keep_all(dv1);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          keep_all(af[ks]);
          keep_all(lf[ks]);
        }
      }
      stage_head_rows<DH>(stage(wg), stage(wg) + L::TILE0, dk0, dk1, warp, lane);
      store(wg, D + h * DH, k0, b);
      stage_head_rows<DH>(stage(wg), stage(wg) + L::TILE0, dv0, dv1, warp, lane);
      store(wg, 2 * D + h * DH, k0, b);
    }
    if (kv_held) release(kv_empty);
    release(qd_empty);  // Q and dO are read
  }
  if (ct == 0) bulk_wait();
}

template <int DH, int R>
int launch_bwd(const void* qkv, const void* gout, void* dqkv, int B, int T,
               int H, float coef, cudaStream_t s) {
  using L = Bwd<DH, R>;
  CUtensorMap mx[2], mg[2], md[2];
  int rc = make_head_maps(mx, qkv, DH, B, T, 3 * H * DH, BT);
  if (rc == 0) rc = make_head_maps(mg, gout, DH, B, T, H * DH, BT);
  if (rc == 0) rc = make_head_maps(md, dqkv, DH, B, T, 3 * H * DH, BT);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(attn_core_bwd_kernel<DH, R>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  const long long items = (long long)B * H;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items < sm_count() ? (int)items : sm_count();
  attn_core_bwd_kernel<DH, R><<<grid, THREADS, L::SMEM, s>>>(
      mx[0], mx[1], mg[0], mg[1], md[0], md[1], B, T, H, coef);
  return (int)cudaGetLastError();
}

// The instantiations: rows 128, 256 and 320 at both head widths, 384 at 64.
template <int DH>
int bwd_smem_bytes(int T) {
  switch (bin_rows(T)) {
    case 128: return Bwd<DH, 128>::SMEM;
    case 256: return Bwd<DH, 256>::SMEM;
    case 320: return Bwd<DH, 320>::SMEM;
    default: return DH == 64 ? Bwd<64, 384>::SMEM : 0;
  }
}

template <int DH>
int dispatch_bwd(const void* qkv, const void* gout, void* dqkv, int B, int T,
                 int H, float coef, cudaStream_t s) {
  switch (bin_rows(T)) {
    case 128: return launch_bwd<DH, 128>(qkv, gout, dqkv, B, T, H, coef, s);
    case 256: return launch_bwd<DH, 256>(qkv, gout, dqkv, B, T, H, coef, s);
    case 320: return launch_bwd<DH, 320>(qkv, gout, dqkv, B, T, H, coef, s);
    default:
      if constexpr (DH == 64)
        return launch_bwd<64, 384>(qkv, gout, dqkv, B, T, H, coef, s);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ep

// Dynamic shared memory the backward needs at this T and head width; 0 when
// there is no instantiation for them: head widths 64 (T <= 384) and 80
// (T <= 320) are built.
EP_EXPORT int ep_attn_core_bwd_smem_bytes(int T, int head_dim) {
  if (T < 1) return 0;
  if (head_dim == 64 && T <= 384) return ep::bwd_smem_bytes<64>(T);
  if (head_dim == 80 && T <= 320) return ep::bwd_smem_bytes<80>(T);
  return 0;
}

// qkv (B, T, 3*H*Dh) and dO (B, T, H*Dh) bf16 -> dqkv (B, T, 3*H*Dh) bf16;
// coef = scale/temperature.
EP_EXPORT int ep_attn_core_bwd(const void* qkv, const void* gout, void* dqkv,
                               int B, int T, int H, int head_dim, float coef,
                               void* stream) {
  if (ep_attn_core_bwd_smem_bytes(T, head_dim) == 0 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64
             ? ep::dispatch_bwd<64>(qkv, gout, dqkv, B, T, H, coef, s)
             : ep::dispatch_bwd<80>(qkv, gout, dqkv, B, T, H, coef, s);
}
