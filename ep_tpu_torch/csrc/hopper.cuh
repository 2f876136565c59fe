// The Hopper GEMM main loop shared by the supercell's products (kernels A and
// C, attn_block_gemm.cu), the int8 fc1 and fc2 (mlp_int8.cu) and the EP pool
// with its projection (kernel G, ep_pool_proj.cu): PTX wrappers for TMA loads
// and stores, mbarrier, wgmma, setmaxnreg, cluster barriers and distributed
// shared memory, the tensor-map encoders, and the producer's half of the
// loop. The attention kernels B, E and F (attn_core.cu, attn_core_bwd.cu,
// attn_flash.cu) and the EP pool D (ep_pool.cu) run loops of their own on the
// same wrappers and the helpers below.
//
// The loop: a ring of K slices in shared memory, each 128 bytes deep (64 bf16
// or 128 int8 values) and laid out by TMA with the 128-byte swizzle that
// wgmma reads; a "full" and an "empty" mbarrier per stage. One thread of the
// producer warpgroup waits for a stage to be empty, announces the slice's
// bytes on its full barrier and issues two TMA loads (rows of the activation,
// rows of the nn.Linear weight: both are K-major, so nothing is transposed).
// Two consumer warpgroups of 4 warps each own 64 of the tile's 128 rows: they
// wait for the stage to be full, issue the slice's wgmma.mma_async (B always
// from shared memory, A from shared memory or, for kernel A, from registers),
// keep one group in flight and release the stage before when its group has
// retired. Out-of-range rows are zero-filled by TMA, so ragged M and N cost
// nothing in the loop. (Sharing a slice among the blocks of a cluster by TMA
// multicast was tried for both users and lost: the blocks then wait for each
// other at every stage, and L2 was not what held the loop back.)
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

namespace ep {
namespace hopper {

constexpr int TILE_M = 128;        // rows of an output tile (2 x wgmma's 64)
constexpr int SLICE_BYTES = 128;   // depth of a K slice, one swizzle row
constexpr int A_STAGE_BYTES = TILE_M * SLICE_BYTES;
constexpr int CONSUMER_WARPS = 8;
constexpr int BLOCK_THREADS = 384; // 2 consumer warpgroups + 1 producer
constexpr int MAX_SMEM = 232448;   // bytes a block may use on an H100

// The first 1024-byte boundary of the block's dynamic shared memory (the
// 128-byte swizzle repeats every 1024 bytes of address). Offsetting the array
// itself keeps the pointer in the shared address space for the compiler.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* smem_raw) {
  return smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
}

// ---- mbarrier -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes freshly initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spins until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------
// One box of the tensor behind `map` at (c0 innermost, c1) into shared
// memory; its bytes are counted on `bar`. Out-of-range parts are zero-filled.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 3-D tensor at (c0 innermost, c1, c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One box from shared memory to the tensor behind `map`; parts out of range
// are not written. Completion is tracked by the thread's bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// The same for a 3-D tensor at (c0 innermost, c1, c2).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until the thread's stores have read their shared memory (it may be reused).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Until the thread's stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Orders this thread's writes of shared memory before a TMA store reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1..15) among `threads` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps a register that an in-flight wgmma reads or writes alive, and in
// place, up to this point of the program.
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void keep(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }
template <class T, int N>
__device__ __forceinline__ void keep_all(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(r[i]);
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart. A step of 32
// bytes along K (16 bf16, 32 int8) adds 2 to the descriptor.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
constexpr int DESC_K_STEP = 2;

// The same for the 32-byte swizzle: rows of 32 bytes (16 bf16, one K step),
// groups of 8 rows 256 bytes apart. Read N-major (wgmma's transpose bit), a
// 32-byte swizzled tile is 16 columns wide and the 8-row groups step along K;
// the same holds for smem_desc with 64 columns.
__device__ __forceinline__ uint64_t smem_desc_32(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(256 >> 4) << 32) | (uint64_t(3) << 62);
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---- clusters ---------------------------------------------------------------
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// max into the u32 at the same shared-memory offset in block `rank` of the
// cluster (distributed shared memory).
__device__ __forceinline__ void cluster_max_u32(unsigned* local, unsigned rank,
                                                unsigned v) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("red.relaxed.cluster.shared::cluster.max.u32 [%0], %1;\n" ::"r"(
                   remote),
               "r"(v)
               : "memory");
}

// The address of `local`'s twin in block `rank` of the cluster, and f32
// stores and loads there (distributed shared memory).
__device__ __forceinline__ unsigned cluster_addr(const void* local,
                                                 unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  return remote;
}
__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr)
               : "memory");
  return v;
}

// ---- the ring ---------------------------------------------------------------
// Stage and phase of a walk around a ring of `stages` slots.
struct RingPos {
  int stage = 0;
  unsigned phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

struct Ring {
  unsigned char* slots;  // [stages][stage_bytes], 1024-byte aligned
  uint64_t* full;        // [stages], one arrival (the producer) plus bytes
  uint64_t* empty;       // [stages], one arrival a consumer warp
  int stages, stage_bytes;
  __device__ __forceinline__ unsigned char* a(int s) const {
    return slots + s * stage_bytes;
  }
  __device__ __forceinline__ unsigned char* b(int s) const {
    return slots + s * stage_bytes + A_STAGE_BYTES;
  }
};

// One thread, before the block's first __syncthreads().
__device__ __forceinline__ void ring_init(const Ring& r) {
  for (int s = 0; s < r.stages; ++s) {
    mbar_init(r.full + s, 1);
    mbar_init(r.empty + s, CONSUMER_WARPS);
  }
  fence_barrier_init();
}

// Producer thread: slices kt_begin..kt_end-1 of one tile, rows m0.. of A and
// rows n0.. of W, both maps with boxes SLICE_BYTES deep.
__device__ __forceinline__ void produce_tile(const Ring& r, RingPos& pos,
                                             const CUtensorMap* map_a,
                                             const CUtensorMap* map_w, int m0,
                                             int n0, int kt_begin, int kt_end,
                                             int k_per_slice,
                                             unsigned slice_bytes) {
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    mbar_wait(r.empty + pos.stage, pos.phase ^ 1);
    mbar_expect_tx(r.full + pos.stage, slice_bytes);
    tma_load_2d(r.a(pos.stage), map_a, r.full + pos.stage, kt * k_per_slice, m0);
    tma_load_2d(r.b(pos.stage), map_w, r.full + pos.stage, kt * k_per_slice, n0);
    pos.advance(r.stages);
  }
}

// A consumer warp hands a stage back once its own reads of it are over.
__device__ __forceinline__ void release(const Ring& r, int stage, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(r.empty + stage);
}

// ---- tensor maps (host) -------------------------------------------------------
// cuTensorMapEncodeTiled belongs to libcuda, not to the CUDA runtime; it is
// taken from the libcuda the process has already loaded, so the link needs no
// -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Map of a row-major (rows, cols) matrix of 1- or 2-byte elements with boxes
// of box_rows x SLICE_BYTES, 128-byte swizzle, zero fill out of range.
// Returns 0 or a cudaError_t.
inline int make_map(CUtensorMap* map, const void* ptr, int elem_bytes,
                    uint64_t rows, uint64_t cols, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(SLICE_BYTES / elem_bytes), box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = fn(
      map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Map of a (depth, rows, cols) bf16 tensor with boxes of box_rows x box_cols
// in one (row, col) plane, the given swizzle, zero fill past each of the
// three bounds (a box never reads rows of the next plane). Returns 0 or a
// cudaError_t.
inline int make_map_3d(CUtensorMap* map, const void* ptr, uint64_t depth,
                       uint64_t rows, uint64_t cols, uint32_t box_rows,
                       uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box,
                         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// ---- wgmma.mma_async ----------------------------------------------------------
// d (+)= a * b for one warpgroup: 64 rows, N columns, 32 bytes of K. Thread
// (warp w, g = lane / 4, t = lane % 4) holds d[4j], d[4j+1]: row 16w + g,
// columns 8j + 2t, 8j + 2t + 1, and d[4j+2], d[4j+3]: row 16w + g + 8. With
// scale_d == 0 the product overwrites d. `_rs` takes A as the four registers
// of an m16k16 fragment per warp (the mma.sync layout), `_ss` as a descriptor.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d);

__device__ __forceinline__ void wgmma_bf16_rs_n256(float (&d)[128], const unsigned (&a)[4], uint64_t b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_ss_n256(float (&d)[128], uint64_t a, uint64_t b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same with N = 128 (kernel G's projection, W's rows as A, tokens as B).
__device__ __forceinline__ void wgmma_bf16_ss_n128(float (&d)[64], uint64_t a,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The attention kernels' logits tiles (B, E, F): A (query, key or value
// rows) from registers, an m16k16 fragment per warp, B K-major in shared
// memory; N = 64, or 32 and 16 for the keys past the last 64.
template <int N>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 2],
                                              const unsigned (&a)[4], uint64_t b,
                                              int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16_rs<16>(float (&d)[8],
                                                  const unsigned (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<32>(float (&d)[16],
                                                  const unsigned (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<64>(float (&d)[32],
                                                  const unsigned (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
// The attention kernels' products over keys or queries (P V, dQ, dK, dV): A
// from registers (an m16k16 fragment per warp), B N-major in shared memory
// (the transpose bit), N = 64 or 16.
template <int N>
__device__ __forceinline__ void wgmma_bf16_rs_tb(float (&d)[N / 2],
                                                 const unsigned (&a)[4],
                                                 uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16_rs_tb<64>(float (&d)[32],
                                                     const unsigned (&a)[4],
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs_tb<16>(float (&d)[8],
                                                     const unsigned (&a)[4],
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The EP kernels' small products (D's logits and value boxes, G's logits):
// d (+)= a * b for one warpgroup: 64 rows, N = 2 * (size of d) columns, 16
// bf16 of K, both operands from shared memory (K-major; with TB = 1, b is
// read N-major).
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, %7;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// ---- attention tiles ----------------------------------------------------------
// Tiles of 64 rows of one head of width DH (64, 72, 80 or 128), as the
// attention kernels stage them: columns 0..63 as rows of 128 bytes in the
// 128-byte swizzle at s0, columns 64..79 at s1 as rows of 32 bytes in the
// 32-byte swizzle (DH = 80; at DH = 72, kernel F only, the box is 16 columns
// wide too and its last 8 are the next columns of the row), or as a second
// box of 128-byte rows in the 128-byte swizzle (DH = 128, kernel F only).
// Both swizzles repeat every 8 rows, so any tile that starts on a multiple of
// 8 rows of a 1024-byte aligned array reads the same way.

// The A fragments of rows row0 + 16*warp .. + 15 for the ceil(DH / 16) K
// steps of a product over the head's columns: 16-byte unit u of row r lies at
// u ^ (r % 8) in a 128-byte row, at u ^ (r / 4 % 2) in a 32-byte row.
template <int DH>
__device__ __forceinline__ void load_head_rows(unsigned (&f)[(DH + 15) / 16][4],
                                               const unsigned char* s0,
                                               const unsigned char* s1,
                                               int row0, int warp, int lane) {
  const int r = row0 + 16 * warp + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(f[kk], reinterpret_cast<const bf16*>(
                           s0 + r * 128 + (((kk * 2 + (lane >> 4)) ^ (r & 7)) << 4)));
  if constexpr (DH == 128) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(f[4 + kk],
                  reinterpret_cast<const bf16*>(
                      s1 + r * 128 + (((kk * 2 + (lane >> 4)) ^ (r & 7)) << 4)));
  } else if constexpr (DH > 64) {
    ldmatrix_x4(f[4], reinterpret_cast<const bf16*>(
                          s1 + r * 32 + (((lane >> 4) ^ ((r >> 2) & 1)) << 4)));
  }
}

// A 64-row accumulator pair (a0: columns 0..63, a1: 64..79, in wgmma's
// layout) rounded to bf16 into a staging tile of the same layout, for a TMA
// store: thread (warp, g, t) writes rows 16*warp + g and + 8, 4 bytes at
// column 8j + 2t, every quad of lanes a different bank.
template <int DH>
__device__ __forceinline__ void stage_head_rows(unsigned char* s0,
                                                unsigned char* s1,
                                                const float (&a0)[32],
                                                const float (&a1)[8], int warp,
                                                int lane) {
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    unsigned char* p = s0 + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t;
    *reinterpret_cast<unsigned*>(p) = pack_bf16(a0[4 * j], a0[4 * j + 1]);
    *reinterpret_cast<unsigned*>(p + 8 * 128) =
        pack_bf16(a0[4 * j + 2], a0[4 * j + 3]);
  }
  if constexpr (DH > 64) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      unsigned char* p = s1 + r * 32 + ((j ^ ((r >> 2) & 1)) << 4) + 4 * t;
      *reinterpret_cast<unsigned*>(p) = pack_bf16(a1[4 * j], a1[4 * j + 1]);
      *reinterpret_cast<unsigned*>(p + 8 * 32) =
          pack_bf16(a1[4 * j + 2], a1[4 * j + 3]);
    }
  }
}

// The maps of one head's tiles in a (depth, rows, cols) bf16 tensor: boxes of
// box_rows x 64 columns in the 128-byte swizzle and, for DH = 72 and 80, of
// box_rows x 16 in the 32-byte swizzle (for DH = 64 the second is a copy of
// the first and is never used; for DH = 128 it is a copy of the first, read
// 64 columns further on). Returns 0 or a cudaError_t.
inline int make_head_maps(CUtensorMap (&maps)[2], const void* ptr, int DH,
                          uint64_t depth, uint64_t rows, uint64_t cols,
                          uint32_t box_rows) {
  int rc = make_map_3d(maps, ptr, depth, rows, cols, box_rows, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  if (DH == 64 || DH == 128) {
    maps[1] = maps[0];
    return 0;
  }
  return make_map_3d(maps + 1, ptr, depth, rows, cols, box_rows, 16,
                     CU_TENSOR_MAP_SWIZZLE_32B);
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<160>(int (&d)[80], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(a), "l"(b), "r"(scale_d));
}

}  // namespace hopper
}  // namespace ep
