// Hopper tensor-core building blocks shared by flash_fwd.cu, fused_trunk.cu
// and flash_bwd.cu: swizzled shared-memory tiles, their wgmma descriptors,
// asynchronous copies, the warpgroup matrix multiplies, whole-tile products
// over an m64n64 fragment, and the attention tile step (S = Q·Kᵀ, online
// softmax, O += P·V) that the two forward kernels run.
//
// Everything here works on one warpgroup (128 threads, 4 warps) that owns
// 64 query rows. A wgmma m64nN accumulator gives thread t (warp w, lane l)
// rows r0 = 16w + l/4 and r0 + 8, and in each 8-column block j the columns
// 8j + 2(l%4) and + 1: register 4j + e holds row r0 + 8·(e/2), column
// 8j + 2(l%4) + e%2. The bf16 A fragment of one k16 step has the same
// layout over 16 columns, so the softmax turns S's accumulator into P's A
// operand in registers, with no trip through shared memory.
//
// Tiles. A "K-major" tile is R rows of 64 or 128 bytes (32 or 64 bf16, or
// 64 int8, of the reduction dimension), stored with the 64B or 128B swizzle
// that wgmma's descriptor names: 16-byte chunk c of row r sits at chunk
// c ^ ((r >> 1) & 3) (64B) or c ^ (r & 7) (128B). The swizzle is a function
// of the shared-memory address bits, so every tile starts on a 1024-byte
// boundary. The same bytes read as an MN-major operand with the transpose
// bit (V in P·V, whose rows are keys and whose contiguous dimension is the
// head dim). A descriptor's stride between 8-row groups (SBO) is 8 rows;
// a k16 step (32 bytes of bf16, or k32 of int8) advances the start address
// by 32 bytes inside the swizzled row, and a transposed k16 step by 16 rows.
//
// Copies. Tiles arrive by cp.async (16 bytes a thread, zero-filled past the
// ragged end through the copy's source size), in commit groups: the copying
// threads are the consuming warpgroup, so a group's wait, a proxy fence
// (cp.async writes through the generic proxy, wgmma reads through the async
// one) and a CTA barrier hand a tile to wgmma.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int kThreads = 128;            // one warpgroup
constexpr float kNegInf = -1e30f;        // the TPU kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (dynamic shared memory is
// sized with 1 KB of slack for it)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of RB-byte rows
template <int RB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(RB == 64 || RB == 128, "tiles have 64- or 128-byte rows");
  if constexpr (RB == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  else return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// byte offset of element `col` (of `eb` bytes) of row r
template <int RB>
__device__ __forceinline__ uint32_t swz_elem(int r, int col, int eb) {
  const int byte = col * eb;
  return swz<RB>(r, byte >> 4) + (byte & 15);
}

// wgmma shared-memory descriptor of a swizzled tile at shared address `a`:
// start >> 4 (bits 0-13), leading offset 1 (unused by the swizzled modes,
// bits 16-29), stride between 8-row groups (bits 32-45), swizzle mode
// (bits 62-63: 1 = 128B, 2 = 64B)
template <int RB>
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16)
         | (static_cast<uint64_t>((8 * RB) >> 4) << 32)
         | (static_cast<uint64_t>(RB == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// order this thread's generic-proxy shared writes (plain stores, completed
// cp.async) before later async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cp.async ROWS rows of RB bytes into a swizzled tile at `dst` (128 rows
// are two 64-row tiles one after the other), shared by THREADS threads: row
// r from src + (row0 + r)·stride bytes; rows at or past `n` read as zeros
template <int RB, int ROWS = 64, int THREADS = kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const uint8_t* src, int64_t stride,
                                          int row0, int n) {
  constexpr int kCh = RB / 16;
  for (int i = threadIdx.x; i < ROWS * kCh; i += THREADS) {
    const int r = i / kCh, c = i % kCh, row = row0 + r;
    const bool ok = row < n;
    cp_async16(dst + swz<RB>(r, c), src + (ok ? row * stride : 0) + c * 16, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The warpgroup matrix multiplies, D(64×N) += A·B: mma_bf16_ss with A and B
// K-major in shared memory (f32 accumulators); mma_bf16_rs with A (bf16) in
// registers and B transposed (MN-major) in shared memory; mma_s8_ss with
// int8 A and B K-major in shared memory (exact int32 accumulators). N is
// the accumulator's size: N/2 registers a thread. scale_d = 0 ignores D.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_bf16_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_bf16_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_bf16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_bf16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_s8_ss(int32_t (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_s8_ss(int32_t (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_s8_ss(int32_t (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Whole-tile products over an m64n64 fragment (the backward kernels)
// ---------------------------------------------------------------------------

// 4-byte cp.async (through L1, for rows of f32 vectors that are not 16-byte
// aligned); bytes = 0 zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// row and column (0..63) of register i of this thread's m64n64 fragment
__device__ __forceinline__ int frag_row(int i) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// d(64×64) += A·Bᵀ over the head dim D: A and B are 64-row K-major tiles
// of D bf16, given by their descriptors (d is zeroed by the caller, before
// the wgmma fence)
template <int D>
__device__ __forceinline__ void mma_tile_nt(float (&d)[32], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_bf16_ss(d, da + 2 * kk, db + 2 * kk, 1);
}

// the bf16 A operands of the four k16 steps over an m64n64 fragment's 64
// columns (round to nearest even, as torch's .to(bfloat16))
__device__ __forceinline__ void to_a_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// acc(64×D) += A·B over 64 rows of B: A the four k16 register operands, B a
// 64-row tile of D bf16 at shared address `b_tile` whose rows are the
// reduction dimension, read MN-major through the transpose bit (as V in P·V)
template <int D>
__device__ __forceinline__ void mma_tile_rs(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                            uint32_t b_tile) {
  const uint64_t db = desc<2 * D>(b_tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_bf16_rs(acc, a[kk], db + kk * 2 * D, 1);
}

// ---------------------------------------------------------------------------
// The attention tile step
// ---------------------------------------------------------------------------

// Online-softmax state of the warpgroup's 64 query rows for head dim D
template <int D>
struct Attn {
  float o[D / 2];  // the O accumulator (m64nD fragment)
  float m[2];      // running row max of rows r0 and r0 + 8, in log2 units
  float l[2];      // this thread's share of their denominators
};

template <int D>
__device__ __forceinline__ void attn_init(Attn<D>& a) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) a.o[i] = 0.f;
  a.m[0] = a.m[1] = kNegInf;
  a.l[0] = a.l[1] = 0.f;
}

// Fold one tile of 64 keys into the state. dq: the descriptor of the Q tile
// (64 rows × D bf16, K-major); k_tile, v_tile: shared addresses of the K and
// V tiles (64 keys × D bf16, rows are keys); key columns >= n_valid are
// masked to -1e30; scale_log2 = scale·log2(e), so that exp2 of the scaled
// logits minus the running max is the softmax numerator. p is rounded to
// bf16 before P·V (it becomes the A operand), and the denominator sums the
// unrounded p, as the plain version does.
template <int D>
__device__ __forceinline__ void attn_step(Attn<D>& a, uint64_t dq, uint32_t k_tile,
                                          uint32_t v_tile, int n_valid, float scale_log2) {
  static_assert(D == 32 || D == 64, "head dim must be 32 or 64");
  constexpr int RB = 2 * D;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  const uint64_t dk = desc<RB>(k_tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_bf16_ss(s, dq + 2 * kk, dk + 2 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  const int quad = threadIdx.x & 3;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
    const float x = col < n_valid ? s[i] * scale_log2 : kNegInf;
    s[i] = x;
    if (i & 2) mx1 = fmaxf(mx1, x);
    else mx0 = fmaxf(mx0, x);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(a.m[0], mx0), mn1 = fmaxf(a.m[1], mx1);
  const float al0 = exp2f(a.m[0] - mn0), al1 = exp2f(a.m[1] - mn1);
  a.m[0] = mn0;
  a.m[1] = mn1;
  float l0 = 0.f, l1 = 0.f;
  uint32_t p[4][4];  // P as the A operand of the four k16 steps over the tile's keys
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e;
      const float mn = (e & 1) ? mn1 : mn0;
      const float p0 = exp2f(s[i] - mn), p1 = exp2f(s[i + 1] - mn);
      if (e & 1) l1 += p0 + p1;
      else l0 += p0 + p1;
      p[kk][e] = pack_bf16(p0, p1);
    }
  a.l[0] = a.l[0] * al0 + l0;
  a.l[1] = a.l[1] * al1 + l1;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) a.o[i] *= ((i >> 1) & 1) ? al1 : al0;

  const uint64_t dv = desc<RB>(v_tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_bf16_rs(a.o, p[kk], dv + kk * RB, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(a.o);
}

// After the last tile: the denominators l (summed over the quad that
// shares a row) and lse = m + log l (natural units) of rows r0 and r0 + 8;
// O is o / l
template <int D>
__device__ __forceinline__ void attn_finish(const Attn<D>& a, float (&l)[2], float (&lse)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = a.l[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    l[r] = t;
    lse[r] = a.m[r] * kLn2 + logf(t);
  }
}

}  // namespace wg
