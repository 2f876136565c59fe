// The int8 MLP half: out = x + fc2(gelu(fc1(LN2(x)))) with both products on
// the int8 tensor cores, as three kernels: ln_quant, fc1, fc2.
//
// Replaces: ep_tpu/ops/mlp_int8_pallas.py::_kernel (one program an image,
//   both weights resident) and its split form _kernel_fc1 / _kernel_fc2. The
//   TPU kernels hold one image's rows and a whole weight in VMEM; one block
//   of an H100 has 227 KB of shared memory, so here the rows are tiled across
//   images (LN and both scales are per token) and the weights stream. What is
//   kept is the contract: no LN output and no hidden activation wider than
//   int8 reaches device memory. Between the kernels pass only int8 codes with
//   their f32 scales: hq (M, D) with sx (M), then aq (M, DH) with sa (M, S),
//   where M = B*T and S is the stripe count. S is part of the result: the
//   hidden activation is requantised per token and per stripe of DH/S
//   columns, exactly as the TPU kernels do at the same shape.
//
// Bound on this card: operations. One block's two products are 4*M*D*DH
//   int8 operations against about M*(4*D + 2*DH) bytes of activations, far
//   above the int8 ridge of an H100. ln_quant alone is bound by its bytes:
//   it reads x once and writes a code an element (3 bytes an element).
// Design:
//   * ln_quant: one warp a row, read once into registers (a lane's 16-byte
//     chunks; rows wider than 2048 once into shared memory); f32 statistics,
//     h = LN(x) kept in registers, sx = max|h|/127, hq = rint(h / sx) by the
//     inverse of sx, dividing only where a quotient lies near a half, so the
//     codes are the division's. Persistent warps load the next row under
//     this row's reductions; gamma and beta are read once a block.
//   * fc1: one product. The requantisation scale needs the whole stripe's
//     max|gelu| before any code can be written, so the stripe's GELU outputs
//     wait on chip, as bf16 in shared memory, until it is known. A block owns
//     128 rows and up to three tiles of 128 or 160 columns of one stripe; a
//     stripe wider than that (3072 columns at ViT-B) is shared by a cluster
//     of up to 8 blocks on neighbouring SMs, which split its columns. The
//     product is the main loop of hopper.cuh with s8 operands: 128-byte K
//     slices of hq and W1 through a TMA ring, wgmma m64nBNk32 (s32
//     accumulators) in two consumer warpgroups of 64 rows each. Clusters are
//     persistent and take (panel, stripe) items in turn, the ring running on
//     from tile to tile and item to item. Each tile's epilogue dequantises,
//     takes the GELU (the tanh form on the bf16-rounded pre-activation,
//     rounded to bf16 after every elementary operation: a function from bf16
//     to bf16, read from a table that this arithmetic filled), writes it to
//     the block's bf16 buffer and folds the row maxima in registers. The
//     blocks of a cluster push their maxima into each other's shared memory
//     (red.shared::cluster.max on the bits of a non-negative f32), meet at a
//     cluster barrier, and each quantises its own buffer, aq = rint(gelu /
//     sa), with 16-byte stores. Both elementwise passes are free of branches
//     and calls (table, a product with 1/sa checked against the division's
//     rounding), because with 8 warps an SM their time is latency, not work.
//   * fc2: the main loop of hopper.cuh as fc1 runs it: 128-byte K slices of
//     aq and W2 (both K-major) through a 5-stage TMA ring, wgmma m64n128k32
//     in two consumer warpgroups of 64 rows, persistent blocks over (row
//     panel, 128-column tile) items, so that one tile's epilogue runs under
//     the next tile's loads. A stripe is DH/S/128 slices (24 at ViT-B, 5 at
//     ViT-H, 4 at ViT-L): at its end the s32 sums retire and are dequantised
//     once, acc*(sa[:, s]*s2), into an f32 running sum (the scale changes per
//     stripe, so the s32 sum cannot run across stripes), and the next
//     stripe's first slice overwrites the accumulators. The epilogue is
//     kernel C's: the producer brings the residual tile in by TMA, in the
//     128-byte swizzle, into a buffer of the warpgroup; bias and residual are
//     added in the JAX tier's order (resident: x + (y + b2), two-kernel:
//     (x + y) + b2), each rounded once to bf16 in place, and TMA stores the
//     tile, dropping rows past M.
//   Every f32 step uses the round-to-nearest intrinsics so that no
//   multiply-add is contracted: the kernels round where the plain version
//   (ops/mlp_int8.py::mlp_int8_ref) rounds, and the s32 sums are exact in any
//   order, so fc1's codes and scales equal the plain version's bit for bit.
//
// Layouts: x, out (M, D) bf16; w1q (DH, D) and w2q (D, DH) int8, the
// nn.Linear layout (K contiguous per output channel, the "col" operand of the
// mma); s1 (DH), s2 (D), b1, b2, gamma, beta f32. Requires D % 128 == 0 and
// (DH / S) % 128 == 0; fc1 also that the stripe splits into C <= 8 blocks of
// 384, 320, 256 or 128 columns (ops/mlp_int8.py::fc1_tiling; checked by the
// Python wrapper); M may be ragged.
#include "hopper.cuh"

namespace ep {
namespace {

constexpr int BM = 128, BK = 128;
constexpr float GELU_K0 = 0.044677734375f;  // bf16(0.044715)
constexpr float GELU_K1 = 0.796875f;        // bf16(sqrt(2/pi))

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// tanh-form GELU of a bf16-representable value, every operation rounded to
// bf16 with bf16 constants: the arithmetic of gelu_tanh_bf16 in mlp_int8.py.
__device__ __forceinline__ float gelu_bf16(float a) {
  const float x3 = round_bf16(__fmul_rn(round_bf16(__fmul_rn(a, a)), a));
  const float inner = round_bf16(__fadd_rn(a, round_bf16(__fmul_rn(x3, GELU_K0))));
  const float th = round_bf16(tanhf(round_bf16(__fmul_rn(inner, GELU_K1))));
  const float cdf = round_bf16(__fmul_rn(round_bf16(__fadd_rn(th, 1.0f)), 0.5f));
  return round_bf16(__fmul_rn(a, cdf));
}

__device__ __forceinline__ int quantise(float v, float scale) {
  return (int)rintf(__fdiv_rn(v, scale));  // half to even; |v/scale| <= 127
}

// quantise(v, scale) for |v / scale| <= 127 without a division: t = v *
// fl(1 / scale) lies within 127 * 2^-23 = 1.5e-5 of the quotient, so rint(t)
// is the rounded quotient unless t is that close to a half. `doubt` is set
// then, and the caller divides; the test stays out of the chain of
// dependent instructions, so the elements of an unrolled loop overlap.
__device__ __forceinline__ int quantise_by_inverse(float v, float inv_scale,
                                                   bool& doubt) {
  // Adding 1.5 * 2^23 leaves rint(t), half to even, in the sum's low bits:
  // plain additions, where rintf and the cast are conversions at a fraction
  // of their rate.
  constexpr float MAGIC = 12582912.0f;
  const float t = __fmul_rn(v, inv_scale);
  const float m = __fadd_rn(t, MAGIC);
  doubt |= fabsf(fabsf(__fsub_rn(t, __fsub_rn(m, MAGIC))) - 0.5f) < 4e-5f;
  return __float_as_int(m) - __float_as_int(MAGIC);
}

// ---- ln_quant -------------------------------------------------------------
// One warp a row. Lane l holds the row's 16-byte chunks at columns l*8 +
// 256*c, and every per-lane sum runs over them in that order, then the warp's
// butterfly: the statistics, and so the codes and scales, do not depend on
// where the row is kept.
constexpr int LNQ_WARPS = 8;        // rows in flight a block
constexpr int LNQ_MAX_CHUNKS = 8;   // chunks a lane holds in registers: D <= 2048

__device__ __forceinline__ float chunk_value(const uint4& u, int e) {
  const unsigned w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
  return e & 1 ? bf16_hi(w) : bf16_lo(w);
}
__device__ __forceinline__ void chunk_sum(const uint4& u, float& s) {
#pragma unroll
  for (int e = 0; e < 8; ++e) s += chunk_value(u, e);
}
__device__ __forceinline__ void chunk_sq_dev(const uint4& u, float mean,
                                             float& ss) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float d = __fsub_rn(chunk_value(u, e), mean);
    ss = __fadd_rn(ss, __fmul_rn(d, d));
  }
}
// h = LN(x) for one chunk, with its 8 gammas and betas; am = max(am, |h|)
__device__ __forceinline__ void chunk_ln(const uint4& u, float mean, float rstd,
                                         const float4 (&gb)[4], float (&h)[8],
                                         float& am) {
  const float g[8] = {gb[0].x, gb[0].y, gb[0].z, gb[0].w,
                      gb[1].x, gb[1].y, gb[1].z, gb[1].w};
  const float b[8] = {gb[2].x, gb[2].y, gb[2].z, gb[2].w,
                      gb[3].x, gb[3].y, gb[3].z, gb[3].w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    h[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(chunk_value(u, e), mean),
                                         rstd), g[e]), b[e]);
    am = fmaxf(am, fabsf(h[e]));
  }
}
// The 8 codes rint(h / scale), packed: by the inverse, or where that is in
// doubt for any of them (doubt_out), by the division.
__device__ __forceinline__ uint2 chunk_codes(const float (&h)[8], float scale,
                                             float inv, bool& doubt_out) {
  bool doubt = false;
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e >> 2] |= (unsigned)(quantise_by_inverse(h[e], inv, doubt) & 0xff)
                 << (8 * (e & 3));
  if (doubt) {  // some quotient lies at a half
    w[0] = w[1] = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e >> 2] |= (unsigned)(quantise(h[e], scale) & 0xff) << (8 * (e & 3));
  }
  doubt_out |= doubt;
  return make_uint2(w[0], w[1]);
}
__device__ __forceinline__ float row_scale(float am) {
  return __fdiv_rn(fmaxf(warp_max(am), 1e-8f), 127.0f);
}

// LN2 with f32 statistics (the variance as the mean squared deviation), the
// row's scale sx = max(max|h|, 1e-8) / 127 and its codes rint(h / sx). The
// row is read once, into registers (NC chunks a lane, D <= 256 * NC), and h
// stays there from the LN to the codes. Persistent warps take rows
// row, row + warps, ... and load the next row's chunks before this row's
// reductions, so a warp keeps two rows of loads in flight. gamma and beta
// sit in shared memory, read once a block.
template <int NC>
__global__ void __launch_bounds__(LNQ_WARPS * 32)
ln_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, int8_t* __restrict__ hq,
                float* __restrict__ sx, int M, int D, float eps) {
  extern __shared__ float4 gb_s[];  // gamma [D / 4], then beta [D / 4]
  for (int i = threadIdx.x; i < D / 4; i += blockDim.x) {
    gb_s[i] = __ldg(reinterpret_cast<const float4*>(gamma) + i);
    gb_s[D / 4 + i] = __ldg(reinterpret_cast<const float4*>(beta) + i);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * LNQ_WARPS;
  auto load = [&](uint4 (&v)[NC], int row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * (D / 8);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      v[c] = row < M && lane * 8 + 256 * c < D ? __ldg(xr + lane + 32 * c)
                                               : zero_pack();
  };
  int row = blockIdx.x * LNQ_WARPS + (threadIdx.x >> 5);
  uint4 cur[NC];
  load(cur, row);
  for (; row < M; row += stride) {
    uint4 next[NC];
    load(next, row + stride);
    float s = 0.f, ss = 0.f, am = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane * 8 + 256 * c < D) chunk_sum(cur[c], s);
    const float mean = warp_sum(s) / (float)D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane * 8 + 256 * c < D) chunk_sq_dev(cur[c], mean, ss);
    const float rstd = rsqrtf(warp_sum(ss) / (float)D + eps);
    float h[NC][8];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = (lane * 8 + 256 * c) / 4;
      if (i < D / 4) {
        const float4 gb[4] = {gb_s[i], gb_s[i + 1], gb_s[D / 4 + i],
                              gb_s[D / 4 + i + 1]};
        chunk_ln(cur[c], mean, rstd, gb, h[c], am);
      }
    }
    const float scale = row_scale(am);
    const float inv = __fdiv_rn(1.0f, scale);
    bool doubt = false;
    uint2* out = reinterpret_cast<uint2*>(hq + (size_t)row * D);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane * 8 + 256 * c < D)
        out[lane + 32 * c] = chunk_codes(h[c], scale, inv, doubt);
    if (lane == 0) sx[row] = scale;
#pragma unroll
    for (int c = 0; c < NC; ++c) cur[c] = next[c];
  }
}

// The same for rows wider than the registers hold (D > 256 * LNQ_MAX_CHUNKS):
// the warp stages its row in shared memory (read once from device memory),
// and h is computed twice from there, for its max and for its codes.
__global__ void __launch_bounds__(LNQ_WARPS * 32)
ln_quant_wide_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, int8_t* __restrict__ hq,
                     float* __restrict__ sx, int M, int D, float eps) {
  extern __shared__ uint4 rows_s[];  // [warps][D / 8]
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int chunks = D / 8;
  uint4* row_s = rows_s + (threadIdx.x >> 5) * chunks;
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  for (int row = blockIdx.x * warps + (threadIdx.x >> 5); row < M;
       row += gridDim.x * warps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * chunks;
    for (int i = lane; i < chunks; i += 32) row_s[i] = __ldg(xr + i);
    float s = 0.f, ss = 0.f, am = 0.f, h[8];
    for (int i = lane; i < chunks; i += 32) chunk_sum(row_s[i], s);
    const float mean = warp_sum(s) / (float)D;
    for (int i = lane; i < chunks; i += 32) chunk_sq_dev(row_s[i], mean, ss);
    const float rstd = rsqrtf(warp_sum(ss) / (float)D + eps);
    for (int i = lane; i < chunks; i += 32) {
      const float4 gb[4] = {__ldg(g4 + 2 * i), __ldg(g4 + 2 * i + 1),
                            __ldg(b4 + 2 * i), __ldg(b4 + 2 * i + 1)};
      chunk_ln(row_s[i], mean, rstd, gb, h, am);
    }
    const float scale = row_scale(am);
    const float inv = __fdiv_rn(1.0f, scale);
    bool doubt = false;
    uint2* out = reinterpret_cast<uint2*>(hq + (size_t)row * D);
    for (int i = lane; i < chunks; i += 32) {
      const float4 gb[4] = {__ldg(g4 + 2 * i), __ldg(g4 + 2 * i + 1),
                            __ldg(b4 + 2 * i), __ldg(b4 + 2 * i + 1)};
      float unused = 0.f;
      chunk_ln(row_s[i], mean, rstd, gb, h, unused);
      out[i] = chunk_codes(h, scale, inv, doubt);
    }
    if (lane == 0) sx[row] = scale;
    __syncwarp();  // the row's chunks are read before the next row lands
  }
}

template <int NC>
int launch_ln_quant(const bf16* x, const float* gamma, const float* beta,
                    int8_t* hq, float* sx, int M, int D, float eps,
                    cudaStream_t stream) {
  // as many blocks as the card runs at once (asked once a chunk count, at the
  // widest row of that count), fewer where M has fewer rows
  static int resident = 0;
  if (!resident) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, ln_quant_kernel<NC>, LNQ_WARPS * 32,
            NC * 256 * 2 * sizeof(float)) != cudaSuccess || n < 1)
      n = 1;
    resident = n * hopper::sm_count();
  }
  const int blocks = (M + LNQ_WARPS - 1) / LNQ_WARPS;
  ln_quant_kernel<NC><<<blocks < resident ? blocks : resident, LNQ_WARPS * 32,
                        D * 2 * sizeof(float), stream>>>(x, gamma, beta, hq, sx,
                                                         M, D, eps);
  return (int)cudaGetLastError();
}

// Warps a block of ln_quant_wide_kernel: as many rows of D as shared memory
// holds, up to LNQ_WARPS (0: not one).
inline int ln_quant_wide_warps(int D) {
  const int w = hopper::MAX_SMEM / (D * 2);
  return w < LNQ_WARPS ? w : LNQ_WARPS;
}

// The GELU above is a function from bf16 to bf16, so a table holds it: for
// every bf16 value with 2^-14 <= |a| < 8, the result of gelu_bf16 itself,
// filled once by gelu_table_kernel. fc1's epilogue looks it up: one shared
// memory load in place of a chain of ~50 dependent instructions and tanhf's
// branch, which kept 8 warps an SM waiting on latency.
constexpr int GELU_EXP0 = 127 - 14, GELU_EXPS = 17;  // biased exponents covered
constexpr int GELU_TABLE = GELU_EXPS * 256;           // entries, 2 bytes each

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(unsigned short bits) {
  return __uint_as_float((unsigned)bits << 16);
}


// Entry (e, sign, mantissa) at (e - GELU_EXP0) * 256 + sign * 128 + mantissa.
__global__ void gelu_table_kernel(unsigned short* __restrict__ table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= GELU_TABLE) return;
  const unsigned bits = ((unsigned)((i >> 7) & 1) << 15) |
                        ((unsigned)(GELU_EXP0 + (i >> 8)) << 7) | (i & 127);
  table[i] = bf16_bits(gelu_bf16(bf16_value((unsigned short)bits)));
}

// bf16 bits of gelu_bf16(a) for the bf16 value with bits `a`, without a
// branch, so that the lookups of an unrolled loop overlap. Inside the table's
// range it is the table's entry. Past it (|a| >= 8) the arithmetic of
// gelu_bf16 gives tanh = +-1 exactly, so the result is a for a > 0 and -0 for
// a < 0. Below it (|a| < 2^-14) the cubic term vanishes against a, tanh(u)
// rounds to u and 1 + u to 1, so the result is bf16(a * 0.5), `half` here.
// (Only -inf and NaN, which no finite input produces, come out as -0 and a
// instead of NaN.) gelu_check_kernel holds this against gelu_bf16 for every
// bf16 value.
__device__ __forceinline__ unsigned gelu_select(
    const unsigned short* __restrict__ table, unsigned a, unsigned half) {
  const int e = (int)((a >> 7) & 0xffu) - GELU_EXP0;
  const unsigned entry = table[(min(max(e, 0), GELU_EXPS - 1) << 8) |
                               ((a >> 8) & 0x80u) | (a & 0x7fu)];
  const unsigned big = (a & 0x8000u) ? 0x8000u : a;
  return e < 0 ? half : e >= GELU_EXPS ? big : entry;
}

// The GELUs of bf16(fa) and bf16(fb), packed (fa's in the low half). The two
// roundings to bf16 are one conversion each for the pair.
__device__ __forceinline__ unsigned gelu_lookup2(
    const unsigned short* __restrict__ table, float fa, float fb) {
  const unsigned ab = pack_bf16(fa, fb);
  const unsigned half = pack_bf16(__fmul_rn(bf16_lo(ab), 0.5f),
                                  __fmul_rn(bf16_hi(ab), 0.5f));
  return gelu_select(table, ab & 0xffffu, half & 0xffffu) |
         (gelu_select(table, ab >> 16, half >> 16) << 16);
}

// mismatches[0] += the finite bf16 values at which gelu_lookup2 and gelu_bf16
// differ (it must stay 0); one thread a value.
__global__ void gelu_check_kernel(const unsigned short* __restrict__ table,
                                  int* __restrict__ mismatches) {
  const unsigned a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= 65536u || ((a >> 7) & 0xffu) == 0xffu) return;
  const float v = bf16_value((unsigned short)a);
  const unsigned want = bf16_bits(gelu_bf16(v));
  if (gelu_lookup2(table, v, v) != (want | (want << 16)))
    atomicAdd(mismatches, 1);
}

// fc1's shared memory: the ring, the block's GELU buffer (128 rows of
// tiles*BN bf16 values, 16 bytes of padding a row against bank conflicts),
// the GELU table, the ring's barriers, the rows' sx and the rows' maxima
// over the whole stripe.
__host__ __device__ constexpr int fc1_stage_bytes(int bn) {
  return hopper::A_STAGE_BYTES + bn * hopper::SLICE_BYTES;
}
__host__ __device__ constexpr int fc1_row_bytes(int nb) { return nb * 2 + 16; }
constexpr int FC1_MAX_STAGES = 4, FC1_BAR_BYTES = 2 * FC1_MAX_STAGES * 8;
__host__ __device__ constexpr int fc1_smem_bytes(int bn, int tiles, int stages) {
  return 1024 + stages * fc1_stage_bytes(bn) + BM * fc1_row_bytes(bn * tiles) +
         GELU_TABLE * 2 + FC1_BAR_BYTES + 2 * BM * 4;  // last: the maxima
}
inline int fc1_stages(int bn, int tiles) {
  int st = FC1_MAX_STAGES;
  while (fc1_smem_bytes(bn, tiles, st) > hopper::MAX_SMEM) --st;
  return st;
}

// Persistent clusters of C blocks along x. A cluster takes work items
// (panel, stripe) in turn: rows 128*panel.., and of the stripe's columns block
// `rank` takes stripe*ds + rank*tiles*BN... The ring runs on from one item
// into the next, so the next item's slices land while this one is quantised.
template <int BN>
__global__ void __launch_bounds__(hopper::BLOCK_THREADS, 1)
fc1_kernel(const __grid_constant__ CUtensorMap map_hq,
           const __grid_constant__ CUtensorMap map_w,
           const float* __restrict__ sx, const float* __restrict__ s1,
           const float* __restrict__ b1,
           const unsigned short* __restrict__ gelu_table,
           int8_t* __restrict__ aq, float* __restrict__ sa, int M, int D, int DH,
           int S, int C, int tiles, int stages) {
  using namespace hopper;
  constexpr int STAGE = fc1_stage_bytes(BN);
  const int NB = tiles * BN;  // this block's columns
  const int ROW = fc1_row_bytes(NB);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* gelu_s = smem + stages * STAGE;  // [BM][ROW]
  unsigned short* table_s = reinterpret_cast<unsigned short*>(gelu_s + BM * ROW);
  uint64_t* bars = reinterpret_cast<uint64_t*>(table_s + GELU_TABLE);
  // the rows' maxima over the stripe as bits of a non-negative f32, which
  // order as the values do; one array for even items, one for odd
  unsigned* amax_s = reinterpret_cast<unsigned*>(bars + 2 * FC1_MAX_STAGES);
  const Ring ring{smem, bars, bars + FC1_MAX_STAGES, stages, STAGE};

  const int tid = threadIdx.x;
  const unsigned rank = cluster_rank();
  const int n_work = ((M + BM - 1) / BM) * S;
  const int n_clusters = gridDim.x / C, cluster_id = blockIdx.x / C;
  const int nk = D / BK;

  if (tid == 0) ring_init(ring);
  if (tid < 2 * BM) amax_s[tid] = 0u;
  for (int i = tid; i < GELU_TABLE * 2 / 16; i += BLOCK_THREADS)
    reinterpret_cast<uint4*>(table_s)[i] =
        __ldg(reinterpret_cast<const uint4*>(gelu_table) + i);
  __syncthreads();
  // every block's maxima are zeroed before a peer of its cluster reaches them
  cluster_arrive();
  cluster_wait();

  const int wg = tid >> 7;
  if (wg == 2) {
    // The producer meets the cluster's barrier once an item like everyone,
    // but waits for it only after the next item's loads are on their way.
    setmaxnreg_dec<40>();
    RingPos pos;
    bool arrived = false;
    for (int work = cluster_id; work < n_work; work += n_clusters) {
      if (tid == 256) {
        const int col0 = (work % S) * (DH / S) + (int)rank * NB;
        for (int tile = 0; tile < tiles; ++tile)
          produce_tile(ring, pos, &map_hq, &map_w, (work / S) * BM,
                       col0 + tile * BN, 0, nk, BK, STAGE);
      }
      __syncwarp();
      if (arrived) cluster_wait();
      cluster_arrive();
      arrived = true;
    }
    if (arrived) cluster_wait();
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g;  // and row0 + 8
  RingPos pos;
  int parity = 0;
  for (int work = cluster_id; work < n_work; work += n_clusters, parity ^= 1) {
    const int stripe = work % S, m0 = (work / S) * BM;
    const int col0 = stripe * (DH / S) + (int)rank * NB;
    unsigned* amax = amax_s + parity * BM;
    const float sxr[2] = {m0 + row0 < M ? __ldg(sx + m0 + row0) : 0.f,
                          m0 + row0 + 8 < M ? __ldg(sx + m0 + row0 + 8) : 0.f};
    float rmax[2] = {0.f, 0.f};
#pragma unroll 1
    for (int tile = 0; tile < tiles; ++tile) {
      // this thread's columns' scales and biases, asked for before the loop
      // that hides their way from L2 (the cluster barrier empties L1)
      float2 s1v[BN / 8], b1v[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = col0 + tile * BN + 8 * j + 2 * t;
        s1v[j] = __ldg(reinterpret_cast<const float2*>(s1 + c));
        b1v[j] = __ldg(reinterpret_cast<const float2*>(b1 + c));
      }
      int acc[BN / 2];
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(ring.full + pos.stage, pos.phase);
        const uint64_t da = smem_desc(ring.a(pos.stage) + wg * 64 * SLICE_BYTES);
        const uint64_t db = smem_desc(ring.b(pos.stage));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8<BN>(acc, da + kk * DESC_K_STEP, db + kk * DESC_K_STEP,
                       (kt | kk) != 0);
        wgmma_commit();
        const int cur = pos.stage;
        pos.advance(stages);
        wgmma_wait<1>();
        if (prev >= 0) release(ring, prev, lane);
        prev = cur;
      }
      wgmma_wait<0>();
      keep_all(acc);
      release(ring, prev, lane);

      // a = acc*(sx*s1) + b1 in f32, rounded to bf16, then its GELU
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const unsigned gg = gelu_lookup2(
              table_s,
              __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half]),
                                  __fmul_rn(sxr[half], s1v[j].x)), b1v[j].x),
              __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]),
                                  __fmul_rn(sxr[half], s1v[j].y)), b1v[j].y));
          rmax[half] = fmaxf(rmax[half], fmaxf(fabsf(bf16_lo(gg)),
                                               fabsf(bf16_hi(gg))));
          *reinterpret_cast<unsigned*>(gelu_s + (row0 + 8 * half) * ROW +
                                       (tile * BN + 8 * j + 2 * t) * 2) = gg;
        }
    }

    // The row's max over this block's columns goes to every block of the
    // cluster; the other array is zeroed for the next item (its last readers
    // passed the barrier that ended the item before).
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = rmax[half];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) {
        for (int peer = 0; peer < C; ++peer)
          cluster_max_u32(amax + row0 + 8 * half, peer, __float_as_uint(v));
        amax_s[(parity ^ 1) * BM + row0 + 8 * half] = 0u;
      }
    }
    cluster_arrive();  // also orders this block's writes of gelu_s
    cluster_wait();

    // aq = rint(gelu / sa): 16 codes a chunk, two chunks a thread and turn
    // (their instructions interleave), each stored with one 16-byte write.
    // 128 rows of NB / 16 chunks are a multiple of the 512 chunks of a turn.
    const int chunks = NB / 16;
    for (int idx = tid; idx < BM * chunks; idx += 2 * 2 * 128) {
      int r[2], c[2];
      float sar[2];
      unsigned pair[2][8], w[2][4];
      bool doubt[2] = {false, false};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        r[k] = (idx + k * 2 * 128) / chunks;
        c[k] = ((idx + k * 2 * 128) % chunks) * 16;
        sar[k] = __fdiv_rn(fmaxf(__uint_as_float(amax[r[k]]), 1e-8f), 127.0f);
        const uint4* src =
            reinterpret_cast<const uint4*>(gelu_s + r[k] * ROW + c[k] * 2);
        const uint4 u0 = src[0], u1 = src[1];
        pair[k][0] = u0.x, pair[k][1] = u0.y, pair[k][2] = u0.z, pair[k][3] = u0.w;
        pair[k][4] = u1.x, pair[k][5] = u1.y, pair[k][6] = u1.z, pair[k][7] = u1.w;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float inv = __fdiv_rn(1.0f, sar[k]);
#pragma unroll
        for (int e = 0; e < 4; ++e) w[k][e] = 0u;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int lo = quantise_by_inverse(bf16_lo(pair[k][e]), inv, doubt[k]);
          const int hi = quantise_by_inverse(bf16_hi(pair[k][e]), inv, doubt[k]);
          w[k][e >> 1] |= ((unsigned)(lo & 0xff) | ((unsigned)(hi & 0xff) << 8))
                          << (16 * (e & 1));
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (doubt[k]) {  // some quotient lies at a half: divide
#pragma unroll
          for (int e = 0; e < 4; ++e) w[k][e] = 0u;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int lo = quantise(bf16_lo(pair[k][e]), sar[k]);
            const int hi = quantise(bf16_hi(pair[k][e]), sar[k]);
            w[k][e >> 1] |= ((unsigned)(lo & 0xff) | ((unsigned)(hi & 0xff) << 8))
                            << (16 * (e & 1));
          }
        }
        if (m0 + r[k] >= M) continue;
        if (rank == 0 && c[k] == 0)
          sa[(size_t)(m0 + r[k]) * S + stripe] = sar[k];
        *reinterpret_cast<uint4*>(aq + (size_t)(m0 + r[k]) * DH + col0 + c[k]) =
            make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
      }
    }
    named_barrier(1, 2 * 128);  // the GELU buffer is free for the next item
  }
}

template <int BN>
int launch_fc1(const int8_t* hq, const float* sx, const int8_t* w1q,
               const float* s1, const float* b1, const unsigned short* table,
               int8_t* aq, float* sa, int M, int D, int DH, int S, int C,
               int tiles, cudaStream_t stream) {
  CUtensorMap map_hq, map_w;
  int rc = hopper::make_map(&map_hq, hq, 1, M, D, BM);
  if (rc == 0) rc = hopper::make_map(&map_w, w1q, 1, DH, D, BN);
  if (rc != 0) return rc;
  const int stages = fc1_stages(BN, tiles);
  const int smem = fc1_smem_bytes(BN, tiles, stages);
  cudaFuncSetAttribute(fc1_kernel<BN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       hopper::MAX_SMEM);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(hopper::BLOCK_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // as many clusters as the card runs at once (asked once a cluster size)
  static int resident[9] = {};
  if (!resident[C]) {
    cfg.gridDim = dim3(C * hopper::sm_count());
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, fc1_kernel<BN>, &cfg) != cudaSuccess ||
        n < 1)
      n = hopper::sm_count() / C;
    resident[C] = n;
  }
  const int n_work = ((M + BM - 1) / BM) * S;
  cfg.gridDim = dim3(C * (n_work < resident[C] ? n_work : resident[C]));
  rc = (int)cudaLaunchKernelEx(&cfg, fc1_kernel<BN>, map_hq, map_w, sx, s1, b1,
                               table, aq, sa, M, D, DH, S, C, tiles, stages);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// fc2: 128 x 128 output tiles, 5 stages of 32 KB (a 128-byte slice of 128
// rows of aq and of 128 rows of W2), the residual / output tile (per
// consumer warpgroup two chunks of 64 rows x 64 bf16 columns, each a TMA box
// in the 128-byte swizzle) and the barriers.
constexpr int FC2_BN = 128, FC2_STAGES = 5;
constexpr int FC2_STAGE = hopper::A_STAGE_BYTES + FC2_BN * hopper::SLICE_BYTES;
constexpr int FC2_CHUNKS = FC2_BN / 64, FC2_CHUNK_BYTES = 64 * 64 * 2;
constexpr int FC2_OUT_BYTES = 2 * FC2_CHUNKS * FC2_CHUNK_BYTES;
constexpr int FC2_SMEM =
    1024 + FC2_STAGES * FC2_STAGE + FC2_OUT_BYTES + (2 * FC2_STAGES + 4) * 8;
static_assert(FC2_SMEM <= hopper::MAX_SMEM, "fc2 fits a block");

// Persistent blocks take (panel, column tile) items in turn, the column tiles
// of a panel side by side so that its rows of aq come from L2.
__global__ void __launch_bounds__(hopper::BLOCK_THREADS, 1)
fc2_kernel(const __grid_constant__ CUtensorMap map_aq,
           const __grid_constant__ CUtensorMap map_w,
           const __grid_constant__ CUtensorMap map_x,
           const __grid_constant__ CUtensorMap map_out,
           const float* __restrict__ sa, const float* __restrict__ s2,
           const float* __restrict__ b2, int M, int D, int DH, int S,
           int bias_last) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* out_s = smem + FC2_STAGES * FC2_STAGE;  // [2][CHUNKS][64][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_s + FC2_OUT_BYTES);
  const Ring ring{smem, bars, bars + FC2_STAGES, FC2_STAGES, FC2_STAGE};
  uint64_t* x_full = bars + 2 * FC2_STAGES;  // [2]: a warpgroup's x landed
  uint64_t* out_free = x_full + 2;           // [2]: its store has read the buffer

  const int tid = threadIdx.x;
  if (tid == 0) {
    ring_init(ring);
    for (int i = 0; i < 2; ++i) {
      mbar_init(x_full + i, 1);
      mbar_init(out_free + i, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid >> 7;
  const int n_tiles = D / FC2_BN;
  const int n_items = ((M + BM - 1) / BM) * n_tiles;
  const int nk = DH / BK, per_stripe = nk / S;

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (tid == 256) {
      RingPos pos;
      unsigned free_phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int m0 = (item / n_tiles) * BM, n0 = (item % n_tiles) * FC2_BN;
        // the residual follows half of the tile's slices, when the store of
        // the tile before has long read the buffer it lands in
        produce_tile(ring, pos, &map_aq, &map_w, m0, n0, 0, nk / 2, BK,
                     FC2_STAGE);
        for (int w = 0; w < 2; ++w) {
          mbar_wait(out_free + w, free_phase ^ 1);
          const bool rows = m0 + w * 64 < M;
          mbar_expect_tx(x_full + w, rows ? FC2_CHUNKS * FC2_CHUNK_BYTES : 0);
          if (rows)
            for (int c = 0; c < FC2_CHUNKS; ++c)
              tma_load_2d(out_s + (w * FC2_CHUNKS + c) * FC2_CHUNK_BYTES, &map_x,
                          x_full + w, n0 + c * 64, m0 + w * 64);
        }
        free_phase ^= 1;
        produce_tile(ring, pos, &map_aq, &map_w, m0, n0, nk / 2, nk, BK,
                     FC2_STAGE);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g;  // and row0 + 8
  unsigned char* out_wg = out_s + wg * FC2_CHUNKS * FC2_CHUNK_BYTES;
  RingPos pos;
  unsigned x_phase = 0;
  int acc[FC2_BN / 2];
  float y[FC2_BN / 2];  // the stripes' dequantised sums, in acc's layout

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int m0 = (item / n_tiles) * BM, n0 = (item % n_tiles) * FC2_BN;
    // this thread's columns 8j + 2t, + 1 of the tile
    float2 s2v[FC2_BN / 8];
#pragma unroll
    for (int j = 0; j < FC2_BN / 8; ++j)
      s2v[j] = __ldg(reinterpret_cast<const float2*>(s2 + n0 + 8 * j + 2 * t));
    for (int s = 0; s < S; ++s) {
      const float sar[2] = {
          m0 + row0 < M ? __ldg(sa + (size_t)(m0 + row0) * S + s) : 0.f,
          m0 + row0 + 8 < M ? __ldg(sa + (size_t)(m0 + row0 + 8) * S + s) : 0.f};
      int prev = -1;
      for (int kt = 0; kt < per_stripe; ++kt) {
        mbar_wait(ring.full + pos.stage, pos.phase);
        const uint64_t da = smem_desc(ring.a(pos.stage) + wg * 64 * SLICE_BYTES);
        const uint64_t db = smem_desc(ring.b(pos.stage));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8<FC2_BN>(acc, da + kk * DESC_K_STEP, db + kk * DESC_K_STEP,
                           (kt | kk) != 0);
        wgmma_commit();
        const int cur = pos.stage;
        pos.advance(FC2_STAGES);
        wgmma_wait<1>();
        if (prev >= 0) release(ring, prev, lane);
        prev = cur;
      }
      wgmma_wait<0>();
      keep_all(acc);
      release(ring, prev, lane);
      // y += acc * (sa[:, s] * s2): the stripe's s32 sums dequantised once
#pragma unroll
      for (int j = 0; j < FC2_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float part =
              __fmul_rn(__int2float_rn(acc[4 * j + e]),
                        __fmul_rn(sar[e >> 1], (e & 1) ? s2v[j].y : s2v[j].x));
          y[4 * j + e] = s == 0 ? part : __fadd_rn(y[4 * j + e], part);
        }
    }

    // out = bf16(x + (y + b2)) at the resident tier, bf16((x + y) + b2) at
    // the two-kernel tier, in place of x in the warpgroup's buffer, and from
    // there to device memory by TMA, which drops rows past M and runs on under
    // the next tile's loop.
    mbar_wait(x_full + wg, x_phase);
    x_phase ^= 1;
#pragma unroll
    for (int j = 0; j < FC2_BN / 8; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(b2 + n0 + 8 * j + 2 * t));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // row warp*16 + g + 8*half of the chunk, 16-byte unit j % 8 of it
        unsigned* at = reinterpret_cast<unsigned*>(
            out_wg + (j >> 3) * FC2_CHUNK_BYTES +
            (warp * 16 + g + 8 * half) * SLICE_BYTES + (((j & 7) ^ g) << 4) +
            4 * t);
        const unsigned xr = *at;
        const float y0 = y[4 * j + 2 * half], y1 = y[4 * j + 2 * half + 1];
        const float lo = bias_last
                             ? __fadd_rn(__fadd_rn(bf16_lo(xr), y0), b.x)
                             : __fadd_rn(bf16_lo(xr), __fadd_rn(y0, b.x));
        const float hi = bias_last
                             ? __fadd_rn(__fadd_rn(bf16_hi(xr), y1), b.y)
                             : __fadd_rn(bf16_hi(xr), __fadd_rn(y1, b.y));
        *at = pack_bf16(lo, hi);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (warp == 0 && lane == 0) {
      if (m0 + wg * 64 < M)
        for (int c = 0; c < FC2_CHUNKS; ++c)
          tma_store_2d(&map_out, out_wg + c * FC2_CHUNK_BYTES, n0 + c * 64,
                       m0 + wg * 64);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(out_free + wg);
    }
  }
  if (warp == 0 && lane == 0) bulk_wait();
}

int launch_fc2(const int8_t* aq, const float* sa, const int8_t* w2q,
               const float* s2, const float* b2, const bf16* x, bf16* out,
               int M, int D, int DH, int S, int bias_last, cudaStream_t stream) {
  CUtensorMap map_aq, map_w, map_x, map_out;
  int rc = hopper::make_map(&map_aq, aq, 1, M, DH, BM);
  if (rc == 0) rc = hopper::make_map(&map_w, w2q, 1, D, DH, FC2_BN);
  if (rc == 0) rc = hopper::make_map(&map_x, x, 2, M, D, 64);
  if (rc == 0) rc = hopper::make_map(&map_out, out, 2, M, D, 64);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(fc2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       FC2_SMEM);
  const int n_items = ((M + BM - 1) / BM) * (D / FC2_BN);
  const int grid = n_items < hopper::sm_count() ? n_items : hopper::sm_count();
  fc2_kernel<<<grid, hopper::BLOCK_THREADS, FC2_SMEM, stream>>>(
      map_aq, map_w, map_x, map_out, sa, s2, b2, M, D, DH, S, bias_last);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ep

// x (M, D) bf16 -> hq (M, D) int8 and sx (M) f32; D % 128 == 0.
EP_EXPORT int ep_mlp_int8_ln_quant(const void* x, const void* gamma,
                                   const void* beta, void* hq, void* sx, int M,
                                   int D, float eps, void* stream) {
  using namespace ep;
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  int8_t* hp = static_cast<int8_t*>(hq);
  float* sp = static_cast<float*>(sx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || D < 128 || D % 128) return (int)cudaErrorInvalidValue;
  switch ((D + 255) / 256) {
    case 1: return launch_ln_quant<1>(xp, gp, bp, hp, sp, M, D, eps, s);
    case 2: return launch_ln_quant<2>(xp, gp, bp, hp, sp, M, D, eps, s);
    case 3: return launch_ln_quant<3>(xp, gp, bp, hp, sp, M, D, eps, s);
    case 4: return launch_ln_quant<4>(xp, gp, bp, hp, sp, M, D, eps, s);
    case 5: return launch_ln_quant<5>(xp, gp, bp, hp, sp, M, D, eps, s);
    case 6: return launch_ln_quant<6>(xp, gp, bp, hp, sp, M, D, eps, s);
    case 7: return launch_ln_quant<7>(xp, gp, bp, hp, sp, M, D, eps, s);
    case 8: return launch_ln_quant<8>(xp, gp, bp, hp, sp, M, D, eps, s);
  }
  static_assert(LNQ_MAX_CHUNKS == 8, "a case a chunk count");
  const int warps = ln_quant_wide_warps(D);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int smem = warps * D * 2;
  cudaFuncSetAttribute(ln_quant_wide_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int blocks = (M + warps - 1) / warps;
  const int grid = blocks < 2 * hopper::sm_count() ? blocks : 2 * hopper::sm_count();
  ln_quant_wide_kernel<<<grid, warps * 32, smem, s>>>(xp, gp, bp, hp, sp, M, D,
                                                      eps);
  return (int)cudaGetLastError();
}

// The GELU table fc1 reads: GELU_TABLE entries of 2 bytes, filled once.
EP_EXPORT int ep_mlp_int8_gelu_table(void* table, void* stream) {
  using namespace ep;
  gelu_table_kernel<<<(GELU_TABLE + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned short*>(table));
  return (int)cudaGetLastError();
}
EP_EXPORT int ep_mlp_int8_gelu_table_entries() { return ep::GELU_TABLE; }

// Adds to *mismatches (an int32 on the device) the finite bf16 values at
// which fc1's table-driven GELU differs from the GELU arithmetic itself.
EP_EXPORT int ep_mlp_int8_gelu_check(const void* table, void* mismatches,
                                     void* stream) {
  using namespace ep;
  gelu_check_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(table), static_cast<int*>(mismatches));
  return (int)cudaGetLastError();
}

// hq (M, D), sx (M), w1q (DH, D), s1/b1 (DH), the GELU table -> aq (M, DH)
// int8, sa (M, S). A block takes `tiles` tiles of `bn` columns, a cluster of
// DH / S / (tiles * bn) blocks one stripe (ops/mlp_int8.py::fc1_tiling).
EP_EXPORT int ep_mlp_int8_fc1(const void* hq, const void* sx, const void* w1q,
                              const void* s1, const void* b1,
                              const void* gelu_table, void* aq, void* sa, int M,
                              int D, int DH, int S, int bn, int tiles,
                              void* stream) {
  using namespace ep;
  const int ds = DH / S;
  if (D % BK || tiles < 1 || ds % (bn * tiles) || ds / (bn * tiles) > 8)
    return (int)cudaErrorInvalidValue;
  if (bn != 160 && bn != 128) return (int)cudaErrorInvalidValue;
  const auto launch = bn == 160 ? launch_fc1<160> : launch_fc1<128>;
  return launch(static_cast<const int8_t*>(hq), static_cast<const float*>(sx),
                static_cast<const int8_t*>(w1q), static_cast<const float*>(s1),
                static_cast<const float*>(b1),
                static_cast<const unsigned short*>(gelu_table),
                static_cast<int8_t*>(aq), static_cast<float*>(sa), M, D, DH, S,
                ds / (bn * tiles), tiles, static_cast<cudaStream_t>(stream));
}

// aq (M, DH), sa (M, S), w2q (D, DH), s2/b2 (D), x (M, D) -> out (M, D) bf16;
// bias_last: the two-kernel tier's (x + y) + b2, else x + (y + b2).
EP_EXPORT int ep_mlp_int8_fc2(const void* aq, const void* sa, const void* w2q,
                              const void* s2, const void* b2, const void* x,
                              void* out, int M, int D, int DH, int S,
                              int bias_last, void* stream) {
  using namespace ep;
  if (M < 1 || S < 1 || D % FC2_BN || DH % S || (DH / S) % BK)
    return (int)cudaErrorInvalidValue;
  return launch_fc2(static_cast<const int8_t*>(aq), static_cast<const float*>(sa),
                    static_cast<const int8_t*>(w2q), static_cast<const float*>(s2),
                    static_cast<const float*>(b2), static_cast<const bf16*>(x),
                    static_cast<bf16*>(out), M, D, DH, S, bias_last,
                    static_cast<cudaStream_t>(stream));
}
