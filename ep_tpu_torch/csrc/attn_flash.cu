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
//   rows straight out of qkv.
//
// Rounding points, the TPU kernels': f32 logits times scale/temperature, the
//   softmax normalised BEFORE PV, the normalised probabilities rounded to
//   bf16, PV summed in f32 and rounded once. An online softmax that rescales
//   its accumulator would normalise after PV and round un-normalised
//   probabilities, so the keys are swept twice: sweep 1 keeps each row's
//   running max and sum of exponentials, sweep 2 recomputes the logits and
//   feeds exp(l - max) / sum, rounded to bf16, to PV. Three products where two
//   are needed, and two exponentials a (query, key) pair.
//
// Bound on this card: operations. At ViT-H/14, 448 px, batch 64 (T=1025, 16
//   heads of width 80) the two products are 4*64*16*1025^2*80 = 344 GFLOP,
//   0.348 ms at 989 TFLOP/s, against 672 MB of qkv in and o out, 0.200 ms.
//   The three products the kernel runs take about 0.52 ms at that rate, the
//   2.2e9 exponentials about as long on the SFU (16 a clock an SM), and the
//   logits' operands alone would fill shared memory's 128 bytes a clock.
// Design: the producer / consumer shape of hopper.cuh. Persistent blocks, one
//   an SM, walk (192-row query tile, head, image) items (128 rows at head
//   width 128, below), the query tiles of a head side by side so that its K
//   and V come from L2. One producer thread keeps key tiles in flight on a
//   7-stage mbarrier ring (5 at head width 128): a 3-D tensor map
//   (images, T, 3D) whose boxes of 64 keys are zero-filled past T inside each
//   image, K alone in sweep 1, K and V in sweep 2; the query rows of the next
//   item come into a second buffer while this one runs. Three consumer
//   warpgroups own 64 query rows each and issue wgmma for both products: the
//   logits as m64n64k16 with the query rows in registers (read once an item
//   through the swizzle) and K K-major in shared memory, P V with P from
//   registers (the logits' accumulator layout is the A fragment's once packed
//   to bf16) and V read N-major through the transpose bit. A head of width 80
//   is 160 bytes a row, wider than the 128-byte swizzle, so every tile is two
//   boxes: columns 0..63 in the 128-byte swizzle, 64..79 in the 32-byte one;
//   the logits take 4 + 1 K steps and P V an N=64 and an N=16 product. A
//   warpgroup waits for its own logits; the other two warpgroups' products and
//   exponentials keep the SM busy meanwhile. log2(e) is folded into the scale
//   and the exponentials are ex2. Keys past T are masked to -inf when the
//   logits are read (the TPU kernel: -1e30), so p = 0 exactly, and their V
//   rows are zero; the last key tile's P V runs only over its keys rounded up
//   to 16 (T=1025 and T=257: one K step of four). Query rows come in 64-row
//   units: a warpgroup whose rows all lie past T only hands the ring's stages
//   back, and rows past T are not written.
//   What shaped it, on an H100 (PERF.md): ptxas serialises every wgmma of the
//   kernel when a branch around them depends on threadIdx (the warpgroup
//   index is broadcast by a shuffle so that it is uniform), when the logits'
//   N changes from tile to tile (so the last tile's logits keep N=64), and
//   when the registers of two logits tiles, O and two P buffers are live
//   around them (so the logits of tile i+1 are not issued under the
//   exponentials of tile i; three warpgroups hide the latency instead). Two
//   blocks an SM would need more registers than setmaxnreg can move inside
//   one block.
// Head width 128 (DINOv3 ViT-7B/16: T=789, 32 heads): a row is 256 bytes,
//   two boxes of 64 columns, both in the 128-byte swizzle; the logits take
//   4 + 4 K steps and P V two N=64 products. O is then 64 floats a thread
//   and the query rows' fragments 32 registers, 144 for the arrays alone,
//   which three consumer warpgroups at 160 registers cannot hold. So two
//   consumer warpgroups (128 query rows an item) take 240 registers each,
//   the producer 24 (384 threads: 168 each at launch, 18,432 registers moved
//   each way), and a K/V stage of 32 KB leaves room for 5 stages beside two
//   query buffers of 32 KB.
// Head width 72 (SigLIP2 SO400M/14: T=729, 16 heads; 144 bytes a row, not a
//   multiple of wgmma's 16-column K step) keeps width 80's layout: every tile
//   is the same two boxes, columns 0..63 and a 16-column box from column 64
//   on, so the second box also holds the row's next 8 columns (the next
//   head's, k's or v's first, or, past the last v head, TMA's zero fill). The
//   query fragment's columns 72..79 are zeroed in registers once they are
//   read: the logits' fifth K step then adds q * 0 for those columns, exact
//   zeros whatever finite values the key box holds there. A non-finite value
//   in a neighbouring column (an Inf or NaN in another head's k or v of the
//   same token) would make that product NaN, and with it this head's logits;
//   such a row gives a non-finite output in its own head already. P V's
//   N=16 product computes columns 64..79 and only the first 8 are stored.
//   The kernel thus spends 80/72 of the minimum tensor work on the last K
//   step and on the second P V product.
#include <type_traits>

#include "hopper.cuh"

namespace ep {
namespace {

using namespace hopper;

constexpr int BQ = 64;      // query rows of a consumer warpgroup
constexpr int BN = 64;      // keys of a tile
constexpr float LOG2E = 1.4426950408889634f;

// A block's shape and shared memory at head width DH: the ring, each stage
// [K cols 0..63][V cols 0..63][K cols 64..][V cols 64..], then two query
// buffers, each [Q0 of each consumer][Q1 of each]. Columns 0..63 are rows of
// 128 bytes in the 128-byte swizzle (1024-byte aligned); the 16 columns past
// them (DH = 72 and 80) rows of 32 bytes in the 32-byte swizzle, the 64 past
// them (DH = 128) rows of 128 bytes in the 128-byte swizzle.
template <int DH>
struct Flash {
  static constexpr bool WIDE = DH == 128;       // a second 64-column box
  static constexpr int NC = WIDE ? 2 : 3;       // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);  // and one producer warpgroup
  static constexpr int REGS = WIDE ? 240 : 160;   // a consumer thread's
  static constexpr int STAGES = WIDE ? 5 : 7;   // key tiles in flight
  static constexpr int R1 = DH - 64;            // columns past 64: 0, 8, 16, 64
  static constexpr int W1 = WIDE ? 64 : (R1 > 0 ? 16 : 0);  // their box's
  static constexpr int O1 = WIDE ? 32 : 8;      // their accumulators a thread
  static constexpr int K0 = BN * 128;           // bytes of a key tile, cols < 64
  static constexpr int K1 = BN * W1 * 2;        // and past 64
  static constexpr int Q0 = BQ * 128, Q1 = BQ * W1 * 2;
  static constexpr int STAGE = 2 * (K0 + K1);   // K and V
  static constexpr int QBUF = NC * (Q0 + Q1);   // the consumers' query rows
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * QBUF +
                              (2 * STAGES + 4) * 8;
  // setmaxnreg moves registers only within the block: the producer
  // warpgroup frees what the consumers take, from the launch bound's share
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr bool BALANCED =
      NC * (REGS - LAUNCH_REGS) <= LAUNCH_REGS - 24;
};
static_assert(Flash<72>::SMEM <= MAX_SMEM && Flash<72>::BALANCED,
              "kernel F fits a block at head width 72");
static_assert(Flash<80>::SMEM <= MAX_SMEM && Flash<80>::BALANCED,
              "kernel F fits a block at head width 80");
static_assert(Flash<128>::SMEM <= MAX_SMEM && Flash<128>::BALANCED,
              "kernel F fits a block at head width 128");

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
__global__ void __launch_bounds__(Flash<DH>::THREADS, 1)
attn_flash_kernel(const __grid_constant__ CUtensorMap map_q0,
                  const __grid_constant__ CUtensorMap map_q1,
                  const __grid_constant__ CUtensorMap map_kv0,
                  const __grid_constant__ CUtensorMap map_kv1,
                  bf16* __restrict__ out, int B, int T, int H, float coef) {
  using L = Flash<DH>;
  constexpr int NC = L::NC, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qbase = smem + STAGES * L::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(qbase + 2 * L::QBUF);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;  // [2]
  uint64_t* q_empty = q_full + 2;     // [2]
  auto k0_s = [&](int s) { return smem + s * L::STAGE; };
  auto v0_s = [&](int s) { return smem + s * L::STAGE + L::K0; };
  auto k1_s = [&](int s) { return smem + s * L::STAGE + 2 * L::K0; };
  auto v1_s = [&](int s) { return smem + s * L::STAGE + 2 * L::K0 + L::K1; };
  auto q0_s = [&](int buf, int w) { return qbase + buf * L::QBUF + w * L::Q0; };
  auto q1_s = [&](int buf, int w) {
    return qbase + buf * L::QBUF + NC * L::Q0 + w * L::Q1;
  };

  const int tid = threadIdx.x;
  const int D = H * DH;
  const int n = (T + BN - 1) / BN;             // key tiles
  const int nq = (T + NC * BQ - 1) / (NC * BQ);  // 192- (128-) row query tiles
  const int n_items = nq * H * B;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NC);  // an arrival a consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 4 * NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, broadcast so that the compiler sees that it is uniform:
  // wgmma behind a branch on a value it takes for divergent are serialised
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == NC) {
    // registers move only within the block: 128 x 104 freed here, 384 x 32
    // taken by the consumers (head width 128: 128 x 144, 256 x 72)
    setmaxnreg_dec<24>();
    if (tid == 128 * NC) {
      RingPos pos, qpos;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int h = (item / nq) % H, b = item / (nq * H);
        const int q0 = (item % nq) * NC * BQ;
        const int groups = min(NC, (T - q0 + BQ - 1) / BQ);  // with query rows
        mbar_wait(q_empty + qpos.stage, qpos.phase ^ 1);
        mbar_expect_tx(q_full + qpos.stage, groups * (L::Q0 + L::Q1));
        for (int w = 0; w < groups; ++w) {
          tma_load_3d(q0_s(qpos.stage, w), &map_q0, q_full + qpos.stage,
                      h * DH, q0 + w * BQ, b);
          if constexpr (L::W1 > 0)
            tma_load_3d(q1_s(qpos.stage, w), &map_q1, q_full + qpos.stage,
                        h * DH + 64, q0 + w * BQ, b);
        }
        qpos.advance(2);
        // items 0..n-1: K of tile i (sweep 1); n..2n-1: K and V (sweep 2)
        for (int i = 0; i < 2 * n; ++i) {
          const int k0 = (i % n) * BN;
          const bool with_v = i >= n;
          uint64_t* bar = full + pos.stage;
          mbar_wait(empty + pos.stage, pos.phase ^ 1);
          mbar_expect_tx(bar, (with_v ? 2 : 1) * (L::K0 + L::K1));
          tma_load_3d(k0_s(pos.stage), &map_kv0, bar, D + h * DH, k0, b);
          if constexpr (L::W1 > 0)
            tma_load_3d(k1_s(pos.stage), &map_kv1, bar, D + h * DH + 64, k0, b);
          if (with_v) {
            tma_load_3d(v0_s(pos.stage), &map_kv0, bar, 2 * D + h * DH, k0, b);
            if constexpr (L::W1 > 0)
              tma_load_3d(v1_s(pos.stage), &map_kv1, bar, 2 * D + h * DH + 64,
                          k0, b);
          }
          pos.advance(STAGES);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<L::REGS>();
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c2 = coef * LOG2E;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  RingPos pos, qpos;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int h = (item / nq) % H, b = item / (nq * H);
    const int q0 = (item % nq) * NC * BQ + wg * BQ;  // this warpgroup's rows
    mbar_wait(q_full + qpos.stage, qpos.phase);
    if (q0 >= T) {  // no query rows here: hand the stages back unread
      for (int i = 0; i < 2 * n; ++i) {
        mbar_wait(full + pos.stage, pos.phase);
        release(empty + pos.stage);
        pos.advance(STAGES);
      }
      release(q_empty + qpos.stage);
      qpos.advance(2);
      continue;
    }
    // The warpgroup's query rows go to registers once an item, as the A
    // fragments of the logits' 4 (+ 1) K steps: wgmma with A from shared
    // memory reads 4 KB a 64-column K step, the whole 128 bytes a clock of
    // shared memory at the tensor cores' rate.
    unsigned qf[(DH + 15) / 16][4];
    load_head_rows<DH>(qf, q0_s(qpos.stage, wg), q1_s(qpos.stage, wg), 0, warp,
                       lane);
    if constexpr (L::R1 == 8) {
      // head width 72: the fifth K step's columns 8..15 (the head's 72..79,
      // the row's next columns) are fragment registers 2 and 3
      qf[4][2] = 0u;
      qf[4][3] = 0u;
    }
    release(q_empty + qpos.stage);
    qpos.advance(2);

    // Thread (warp, g, t) holds rows 16*warp + g and + 8 of the warpgroup's
    // 64: the logits in s[4j], s[4j+1] and s[4j+2], s[4j+3] at keys 8j + 2t
    // and + 1 of the tile, o0 the same for head columns 8j + 2t (j < 8), o1
    // for columns 64 + 8j + 2t (j < W1 / 8; those with j < R1 / 8 are the
    // head's and are stored); m and l: the rows' running max
    // times coef*log2(e) and this thread's share of the sum of exponentials.
    float s[BN / 2], o0[32], o1[L::O1];
    unsigned p[BN / 16][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < L::O1; ++i) o1[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
    int held = -1;

    // The logits of a key tile, always all BN columns: narrowing the last
    // tile's N gives its wgmma a second accumulator shape, and ptxas then
    // serialises every wgmma of the kernel. The keys past T are masked
    // instead.
    // The second box's descriptor: the 128-byte swizzle at head width 128,
    // the 32-byte one at 72 and 80.
    auto desc1 = [&](const unsigned char* p) {
      if constexpr (L::WIDE)
        return smem_desc(p);
      else
        return smem_desc_32(p);
    };
    auto issue_s = [&](int stage) {
      const uint64_t dk0 = smem_desc(k0_s(stage));
      const uint64_t dk1 = desc1(k1_s(stage));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_rs<BN>(s, qf[kk], dk0 + kk * DESC_K_STEP, kk);
      if constexpr (L::WIDE) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_rs<BN>(s, qf[4 + kk], dk1 + kk * DESC_K_STEP, 1);
      } else if constexpr (L::R1 > 0) {
        wgmma_bf16_rs<BN>(s, qf[4], dk1, 1);
      }
      wgmma_commit();
    };
    // O += P V over the tile's first `cols` keys (the last tile: its keys
    // rounded up to 16): 16 keys a K step, 16 rows of 128 (or 32) bytes
    // further into V.
    auto issue_pv = [&](int stage, int cols) {
      const uint64_t dv0 = smem_desc(v0_s(stage));
      const uint64_t dv1 = desc1(v1_s(stage));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        if (kk * 16 < cols) {
          wgmma_bf16_rs_tb<64>(o0, p[kk], dv0 + kk * (16 * 128 >> 4), 1);
          if constexpr (L::WIDE)
            wgmma_bf16_rs_tb<64>(o1, p[kk], dv1 + kk * (16 * 128 >> 4), 1);
          else if constexpr (L::R1 > 0)
            wgmma_bf16_rs_tb<16>(o1, p[kk], dv1 + kk * (16 * 32 >> 4), 1);
        }
      wgmma_commit();
    };

    // What item i does with its logits: fold them into the rows' max and sum
    // (sweep 1), or turn them into probabilities and issue P V (sweep 2).
    // With `ragged`, keys past T count as -inf. The accumulators are only
    // read here: masking them in place would put lane-dependent writes
    // between the wgmma that use them.
    auto process = [&](int i, int st, auto ragged) {
      const int lim = T - (i % n) * BN - 2 * t;  // this lane's keys below T
      auto sv = [&](int e) -> float {
        if constexpr (decltype(ragged)::value)
          return (e >> 2) * 8 + (e & 1) < lim ? s[e] : -INFINITY;
        else
          return s[e];
      };
      if (i < n) {
        release(empty + st);  // K has been read
        // four partial maxima and sums a row: short chains of dependent
        // instructions, which two warps an SMSP cannot hide
        float a0[4], a1[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) a0[k] = a1[k] = -INFINITY;
#pragma unroll
        for (int e = 0; e < BN / 2; e += 4) {
          a0[(e >> 2) & 3] = fmaxf(a0[(e >> 2) & 3], fmaxf(sv(e), sv(e + 1)));
          a1[(e >> 2) & 3] = fmaxf(a1[(e >> 2) & 3], fmaxf(sv(e + 2), sv(e + 3)));
        }
        float mx0 = fmaxf(fmaxf(a0[0], a0[1]), fmaxf(a0[2], a0[3]));
        float mx1 = fmaxf(fmaxf(a1[0], a1[1]), fmaxf(a1[2], a1[3]));
#pragma unroll
        for (int w = 1; w < 4; w <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
        }
        // every tile holds a real key, so the max is finite from tile 0 on;
        // coef > 0, so max(s) * c2 is the max of the scaled logits
        const float n0 = fmaxf(m[0], mx0 * c2), n1 = fmaxf(m[1], mx1 * c2);
#pragma unroll
        for (int k = 0; k < 4; ++k) a0[k] = a1[k] = 0.f;
#pragma unroll
        for (int e = 0; e < BN / 2; e += 4) {
          a0[(e >> 2) & 3] += exp2_approx(fmaf(sv(e), c2, -n0)) +
                              exp2_approx(fmaf(sv(e + 1), c2, -n0));
          a1[(e >> 2) & 3] += exp2_approx(fmaf(sv(e + 2), c2, -n1)) +
                              exp2_approx(fmaf(sv(e + 3), c2, -n1));
        }
        l[0] = l[0] * exp2_approx(m[0] - n0) + ((a0[0] + a0[1]) + (a0[2] + a0[3]));
        l[1] = l[1] * exp2_approx(m[1] - n1) + ((a1[0] + a1[1]) + (a1[2] + a1[3]));
        m[0] = n0;
        m[1] = n1;
        if (i == n - 1) {  // between the sweeps: the rows' sums are complete
#pragma unroll
          for (int w = 1; w < 4; w <<= 1) {
            l[0] += __shfl_xor_sync(0xffffffffu, l[0], w);
            l[1] += __shfl_xor_sync(0xffffffffu, l[1], w);
          }
          inv[0] = 1.f / l[0];
          inv[1] = 1.f / l[1];
        }
      } else {
        // p = exp(l - max) / sum rounded to bf16: keys 16kk..16kk+15 of the
        // tile form the A fragment of K step kk
        auto prob = [&](int e, int r) {
          return exp2_approx(fmaf(sv(e), c2, -m[r])) * inv[r];
        };
        const int rest = T - (i % n) * BN;
        const int cols = rest < BN ? (rest + 15) / 16 * 16 : BN;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          if (kk * 16 < cols) {
            p[kk][0] = pack_bf16(prob(8 * kk, 0), prob(8 * kk + 1, 0));
            p[kk][1] = pack_bf16(prob(8 * kk + 2, 1), prob(8 * kk + 3, 1));
            p[kk][2] = pack_bf16(prob(8 * kk + 4, 0), prob(8 * kk + 5, 0));
            p[kk][3] = pack_bf16(prob(8 * kk + 6, 1), prob(8 * kk + 7, 1));
          }
        issue_pv(st, cols);
        held = st;
      }
    };

    // Item i of 2n: key tile i % n, sweep 1 for i < n, sweep 2 after. The
    // warpgroup waits for its own logits; the other warpgroups' products and
    // exponentials fill the SM meanwhile.
    for (int i = 0; i < 2 * n; ++i) {
      mbar_wait(full + pos.stage, pos.phase);
      const int st = pos.stage;
      issue_s(st);
      pos.advance(STAGES);
      wgmma_wait<0>();  // the logits, and the P V of the item before
      keep_all(s);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) keep_all(p[kk]);
      if (held >= 0) release(empty + held);
      held = -1;
      if ((i % n) * BN + BN > T)
        process(i, st, std::true_type{});
      else
        process(i, st, std::false_type{});
    }
    wgmma_wait<0>();
    keep_all(o0);
    keep_all(o1);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) keep_all(p[kk]);
    release(empty + held);

    const int r0 = q0 + 16 * warp + g;
    bf16* orow = out + ((size_t)b * T + r0) * D + h * DH + 2 * t;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (r0 < T)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
            __floats2bfloat162_rn(o0[4 * jj], o0[4 * jj + 1]);
      if (r0 + 8 < T)
        *reinterpret_cast<__nv_bfloat162*>(orow + (size_t)8 * D + 8 * jj) =
            __floats2bfloat162_rn(o0[4 * jj + 2], o0[4 * jj + 3]);
    }
    if constexpr (L::R1 > 0) {
#pragma unroll
      for (int jj = 0; jj < L::R1 / 8; ++jj) {
        if (r0 < T)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 + 8 * jj) =
              __floats2bfloat162_rn(o1[4 * jj], o1[4 * jj + 1]);
        if (r0 + 8 < T)
          *reinterpret_cast<__nv_bfloat162*>(orow + (size_t)8 * D + 64 + 8 * jj) =
              __floats2bfloat162_rn(o1[4 * jj + 2], o1[4 * jj + 3]);
      }
    }
  }
}

template <int DH>
int launch(const void* qkv, void* out, int B, int T, int H, float coef,
           cudaStream_t s) {
  using L = Flash<DH>;
  // boxes of BQ query rows or BN keys, columns 0..63 (128-byte swizzle) and,
  // at DH = 72 and 80, 64..79 (32-byte swizzle), at DH = 128 64..127 (the
  // first map, 64 columns on); DH = 64 reads no second box
  CUtensorMap mq[2], mkv[2];
  int rc = make_head_maps(mq, qkv, DH, B, T, 3 * H * DH, BQ);
  if (rc == 0) rc = make_head_maps(mkv, qkv, DH, B, T, 3 * H * DH, BN);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(attn_flash_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  const long long items =
      (long long)((T + L::NC * BQ - 1) / (L::NC * BQ)) * H * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items < sm_count() ? (int)items : sm_count();
  attn_flash_kernel<DH><<<grid, L::THREADS, L::SMEM, s>>>(
      mq[0], mq[1], mkv[0], mkv[1], static_cast<bf16*>(out), B, T, H, coef);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ep

// qkv (B, T, 3*H*Dh) bf16 -> out (B, T, H*Dh) bf16, Dh 64, 72, 80 or 128;
// coef = scale/temperature > 0.
EP_EXPORT int ep_attn_flash(const void* qkv, void* out, int B, int T, int H,
                            int head_dim, float coef, void* stream) {
  if (T < 1 || B < 1 || H < 1 || !(coef > 0.f) ||
      (head_dim != 64 && head_dim != 72 && head_dim != 80 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return ep::launch<64>(qkv, out, B, T, H, coef, s);
  if (head_dim == 72) return ep::launch<72>(qkv, out, B, T, H, coef, s);
  if (head_dim == 80) return ep::launch<80>(qkv, out, B, T, H, coef, s);
  return ep::launch<128>(qkv, out, B, T, H, coef, s);
}
