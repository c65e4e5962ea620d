// Hopper tensor-core GEMM mainloop shared by dequant_mm.cu and mlp_fused.cu:
// the int8-weight (and float-weight) products of the quantized trunk on
// their bfloat16 paths.
//
// A CTA owns 128 rows and works on a tile of 128 output columns at a time.
// Each of its two consumer warpgroups owns 64 of the rows and computes
// D(64 x 128) += A·Bᵀ with wgmma: A is the warpgroup's rows of a K-major
// operand (x, or the Mlp's hidden activation) that the CTA holds whole in
// shared memory, and B is the tile's 128 weight rows in torch's (out, in)
// layout, K-major too, read by both warpgroups. The weights stream through
// a ring of chunks of 64 reduction elements (one chunk: 128 rows of 128
// bytes for bf16, 64 bytes for int8 codes), so a weight of any size passes
// through a few tens of KB: a 256 x 256 weight widened to bf16 is 128 KB,
// a 384 x 384 one 288 KB, too much to hold beside the activation.
//
// What binds the mainloop on an H100 is shared-memory bandwidth, not the
// tensor cores: an SS wgmma reads A and B from shared memory, and an
// m64n128k16 reads 6 KB for its 131,072 MACs, so at the tensor cores' 2,048
// MACs a clock it takes 96 of the 128 bytes a clock that an SM's shared
// memory moves (an m64n64k16 would take all 128). Every other shared access
// of a step (storing the weight chunk, the epilogue's staging) competes
// with it. The design keeps that other traffic small: 128-row tiles store
// each weight chunk once for 128 rows, and the codes are widened from
// registers straight into the operand stage, with no copy of the codes in
// shared memory.
//
// Operand kinds (the weight's form in device memory and in shared memory):
// * kBf16: bf16 weights (the float Mlp, cast by the caller), copied;
// * kWiden: int8 codes widened to bf16 (w8a16; exact, |code| <= 127);
// * kS8: int8 codes copied as they are, for wgmma .s32.s8.s8 against int8
//   activations (w8a8; exact int32 sums).
// Tiles use attn_wgmma.cuh's swizzled K-major layout: 128-byte rows with the
// 128B swizzle (bf16), 64-byte rows with the 64B swizzle (int8), every tile
// on a 1024-byte boundary.
//
// The ring. kWiden holds two operand stages, fed through registers: each
// thread loads its share of chunk i + 2 (two 16-byte pieces of 16 codes)
// from L2 while the wgmma of chunk i runs and widens chunk i + 1 into the
// other stage; the widening is integer work (byte permutes, one FADD a
// code), because the conversion instructions run at a quarter of the
// integer rate. kBf16 and kS8 need no widening and copy chunks straight
// into a ring of 2 to 4 operand stages with cp.async, as many chunks ahead
// as the stages allow. Each step ends (kWiden) or starts (the others) with
// one CTA barrier. The chunk sequence is any function of the step index
// (Src), so one pipeline runs through several weight matrices (fc1, then
// fc2) or output tiles without draining.
//
// The epilogue stages a warpgroup's 64 x 128 output tile in shared memory
// (rows padded by 8 elements: conflict-free fragment stores) and writes it
// to device memory with coalesced 16-byte stores where the output's rows
// are 16-byte aligned, element by element where they are not.

#pragma once

#include <type_traits>

#include "attn_wgmma.cuh"

namespace gm {

constexpr int kGroups = 2;                        // consumer warpgroups a CTA
constexpr int kThreads = kGroups * wg::kThreads;  // 256
constexpr int kRows = kGroups * 64;               // rows a CTA: 64 a warpgroup
constexpr int kBN = 128;                          // output columns a tile
constexpr int kBK = 64;                           // reduction elements a chunk
constexpr int kMaxStages = 4;                     // copied chunks in flight, at most

enum Kind { kBf16 = 0, kWiden = 1, kS8 = 2 };

// bytes of a row of a K-major tile of this kind (64 elements of the
// reduction dimension), and of one weight chunk (kBN rows)
template <int KIND> __host__ __device__ constexpr int row_bytes() { return KIND == kS8 ? 64 : 128; }
template <int KIND> __host__ __device__ constexpr int chunk_bytes() { return kBN * row_bytes<KIND>(); }
template <int KIND> using Acc = std::conditional_t<KIND == kS8, int32_t, float>;

// bytes of the weight ring with `stages` operand stages (kWiden: always 2)
template <int KIND> __host__ __device__ constexpr size_t ring_bytes(int stages) {
  return static_cast<size_t>(KIND == kWiden ? 2 : stages) * chunk_bytes<KIND>();
}

// bytes of one warpgroup's staged 64 x kBN output tile (rows padded by 8
// elements)
template <typename OT> __host__ __device__ constexpr int stage_row_bytes() {
  return (kBN + 8) * static_cast<int>(sizeof(OT));
}
template <typename OT> __host__ __device__ constexpr int stage_bytes() {
  return 64 * stage_row_bytes<OT>();
}

__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) { wg::mma_bf16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma(int32_t (&d)[64], uint64_t a, uint64_t b) { wg::mma_s8_ss(d, a, b, 1); }

// this thread's warpgroup
__device__ __forceinline__ int group() { return static_cast<int>(threadIdx.x) / wg::kThreads; }

// barrier of this thread's warpgroup alone (ids 1 and 2; __syncthreads is 0)
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group()), "n"(wg::kThreads) : "memory");
}

// row (0..63 in the warpgroup's rows) and column (0..127) of register i of
// this thread's m64n128 accumulator
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x % wg::kThreads;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// cp.async rows row0 .. row0 + kRows - 1 of a K-major operand (row r at
// src + r·stride bytes, `kbytes` bytes of reduction elements a row, a
// multiple of 16) into chunk tiles at dst: chunk t (kRows rows of RB bytes)
// holds bytes t·RB .. t·RB + RB - 1 of every row, warpgroup g's rows at
// g·64·RB. Rows at or past n and bytes at or past kbytes read as zeros. One
// commit group, by all threads.
template <int RB>
__device__ __forceinline__ void load_a(uint32_t dst, const uint8_t* src, int64_t stride, int row0,
                                       int n, int kbytes) {
  constexpr int kCh = RB / 16;
  const int chunks = (kbytes + RB - 1) / RB;
  for (int i = threadIdx.x; i < chunks * kRows * kCh; i += kThreads) {
    const int t = i / (kRows * kCh), r = (i / kCh) % kRows, c = i % kCh;
    const int row = row0 + r, kb = t * RB + 16 * c;
    const bool ok = row < n && kb < kbytes;
    wg::cp_async16(dst + t * kRows * RB + wg::swz<RB>(r, c),
                   src + (ok ? row * stride + kb : 0), ok ? 16 : 0);
  }
  wg::cp_async_commit();
}

// cp.async n floats from src into dst (nothing for a null src), 4 bytes at
// a time, by all threads; part of the caller's next commit group
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n) {
  if (src == nullptr) return;
  for (int i = threadIdx.x; i < n; i += kThreads)
    wg::cp_async4(wg::smem_u32(dst + i), src + i, 4);
}

// 16 int8 codes -> 16 bf16 (lo: codes 0-7, hi: 8-15), exactly, without the
// conversion instructions (I2F and F2F run at 16 a clock an SM on Hopper, a
// quarter of the integer rate). The code's byte, biased by 128, goes into
// the mantissa of 2^23; subtracting 2^23 + 128 (exact) leaves the code as
// a float, and a float holding an integer of magnitude <= 128 has zeros in
// its low 16 bits, so its upper half is the bf16 of the same value.
__device__ __forceinline__ void widen16(uint4 v, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
  uint32_t r[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = __uint_as_float(__byte_perm(w[q], 0x4B000000u, 0x7540 + e)) - 8388736.0f;
    r[2 * q] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    r[2 * q + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
  lo = make_uint4(r[0], r[1], r[2], r[3]);
  hi = make_uint4(r[4], r[5], r[6], r[7]);
}

// the bf16 bits of a finite float rounded to nearest even, and two of them
// packed (lo first), with integer arithmetic: the same values as
// __float2bfloat16_rn and __floats2bfloat162_rn, without F2F
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}
// a finite float rounded to the nearest bf16 (ties to even), as a float
__device__ __forceinline__ float round_bf16(float f) { return __uint_as_float(bf16_bits(f) << 16); }

// the weight chunk rows n0 .. n0 + kBN - 1, elements k0 .. k0 + kBK - 1 of a
// row-major (N, K) weight at w (bf16 for kBf16, int8 codes otherwise)
struct Chunk {
  const uint8_t* w;
  int N, K, n0, k0;
};

// A weight walked chunk by chunk, with increments and compares only (the
// pipeline asks for its chunks in order, and a division by a runtime value
// costs tens of instructions on the path of every step): tiles of kBN rows
// from tile j on, wrapping after the last, each over its K chunks in order.
struct Walk {
  const uint8_t* w;
  int N, K, tiles, kc, j, t;

  __device__ __forceinline__ Walk(const uint8_t* w_, int N_, int K_, int j_)
      : w(w_), N(N_), K(K_), tiles((N_ + kBN - 1) / kBN), kc((K_ + kBK - 1) / kBK),
        j(j_), t(0) {}

  __device__ __forceinline__ Chunk next() {
    const Chunk k{w, N, K, j * kBN, t * kBK};
    if (++t == kc) {
      t = 0;
      if (++j == tiles) j = 0;
    }
    return k;
  }
};

// The weight ring and its pipeline over `total` chunks, chunk i the i-th of
// src.next().
// Every thread of the CTA runs start() once, then step() once per chunk, in
// order. `stages` (2 to kMaxStages) sizes the cp.async ring of kBf16 and
// kS8; kWiden always has two stages. Chunks need K a multiple of 16 and
// 16-byte aligned rows; pieces past N or K are zeros.
template <int KIND, typename Src>
struct Pipe {
  static constexpr int RB = row_bytes<KIND>();
  static constexpr int CB = chunk_bytes<KIND>();
  static constexpr int kEB = KIND == kBf16 ? 2 : 1;  // bytes of a weight element
  static constexpr int kPR = kBK * kEB / 16;         // 16-byte pieces a chunk row
  static constexpr int kPer = kBN * kPR / kThreads;  // pieces a thread
  uint8_t* ring;
  Src src;
  int total, stages, cur;
  uint4 v[kPer];  // kWiden: this thread's pieces of the next chunk to widen

  __device__ __forceinline__ Pipe(uint8_t* ring_, Src src_, int total_, int stages_)
      : ring(ring_), src(src_), total(total_), stages(KIND == kWiden ? 2 : stages_), cur(0) {}

  // piece i of chunk k: row i / kPR, 16 bytes from element k0 + (i % kPR)·16 / kEB
  // (the launchers take weights of fewer than 2^31 bytes)
  __device__ __forceinline__ const uint8_t* piece(const Chunk& k, int i, bool& ok) const {
    const int n = k.n0 + i / kPR, e = k.k0 + (i % kPR) * (16 / kEB);
    ok = n < k.N && e < k.K;
    return k.w + (ok ? (n * k.K + e) * kEB : 0);
  }

  // kWiden: this thread's pieces of chunk c into registers; then widened
  // from there into operand stage c % 2
  __device__ __forceinline__ void load(int c) {
    const Chunk k = src.next();
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      bool ok;
      const uint8_t* g = piece(k, threadIdx.x + p * kThreads, ok);
      v[p] = ok ? __ldg(reinterpret_cast<const uint4*>(g)) : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store(int c) const {
    uint8_t* to = ring + (c % 2) * CB;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kThreads, r = i / kPR, q = i % kPR;
      uint4 lo, hi;
      widen16(v[p], lo, hi);
      *reinterpret_cast<uint4*>(to + wg::swz<128>(r, 2 * q)) = lo;
      *reinterpret_cast<uint4*>(to + wg::swz<128>(r, 2 * q + 1)) = hi;
    }
  }

  // kBf16, kS8: cp.async chunk c into stage c % stages; one commit group
  // (empty past the end)
  __device__ __forceinline__ void fetch(int c) {
    if (c < total) {
      const Chunk k = src.next();
      uint8_t* to = ring + (c % stages) * CB;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int i = threadIdx.x + p * kThreads;
        bool ok;
        const uint8_t* g = piece(k, i, ok);
        wg::cp_async16(wg::smem_u32(to + wg::swz<RB>(i / kPR, i % kPR)), g, ok ? 16 : 0);
      }
    }
    wg::cp_async_commit();
  }
  // wait until at most stages - 2 commit groups are in flight
  __device__ __forceinline__ void wait_chunk() const {
    if (stages >= 4) wg::cp_async_wait<2>();
    else if (stages == 3) wg::cp_async_wait<1>();
    else wg::cp_async_wait<0>();
  }

  __device__ __forceinline__ void start() {
    if constexpr (KIND == kWiden) {
      load(0);
      store(0);
      if (total > 1) load(1);
      wg::fence_proxy_async();
      __syncthreads();
    } else {
      for (int c = 0; c < stages - 1; ++c) fetch(c);
    }
  }

  // acc += A·Bᵀ over chunk `cur`: A this warpgroup's 64-row K-major tile
  // given by its descriptor da (RB-byte rows of the same 64 reduction
  // elements), B the chunk's kBN weight rows
  template <typename A>
  __device__ __forceinline__ void step(A (&acc)[64], uint64_t da) {
    const int c = cur++;
    if constexpr (KIND != kWiden) {
      wait_chunk();                       // groups of chunks <= c + stages - 2 are committed
      wg::fence_proxy_async();
      __syncthreads();                    // chunk c visible; every wgmma of chunk c - 1 done
      fetch(c + stages - 1);              // into the stage of chunk c - 1
    }
    const uint64_t db = wg::desc<RB>(wg::smem_u32(ring + (c % stages) * CB));
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RB / 32; ++kk) mma(acc, da + 2 * kk, db + 2 * kk);
    wg::wgmma_commit();
    if constexpr (KIND == kWiden) {
      if (c + 1 < total) store(c + 1);   // its stage was read by chunk c - 1: done
      if (c + 2 < total) load(c + 2);
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    if constexpr (KIND == kWiden) {
      wg::fence_proxy_async();
      __syncthreads();                    // chunk c + 1 visible; stage c % 2 free
    }
  }
};

template <int KIND, typename Src>
__device__ __forceinline__ Pipe<KIND, Src> make_pipe(uint8_t* ring, Src src, int total, int stages) {
  return Pipe<KIND, Src>(ring, src, total, stages);
}

// Write this warpgroup's 64 x kBN tile y (accumulator layout) to out: rows
// row0 .. row0 + 63 (row stride ld elements), columns n0 .. n0 + kBN - 1,
// masked at M rows and N columns, staged through `stage` (stage_bytes<OT>
// bytes of this warpgroup's own).
template <typename OT>
__device__ __forceinline__ void store_tile(const float (&y)[64], uint8_t* stage, OT* __restrict__ out,
                                           int64_t ld, int row0, int M, int n0, int N) {
  constexpr int RS = stage_row_bytes<OT>();
  constexpr int EB = static_cast<int>(sizeof(OT));
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    uint8_t* p = stage + acc_row(i) * RS + acc_col(i) * EB;
    if constexpr (EB == 4) *reinterpret_cast<float2*>(p) = make_float2(y[i], y[i + 1]);
    else *reinterpret_cast<uint32_t*>(p) = bf16x2_bits(y[i], y[i + 1]);
  }
  wg_sync();
  const int t = threadIdx.x % wg::kThreads;
  if ((ld * EB) % 16 == 0 && (N * EB) % 16 == 0) {
    constexpr int kPR = kBN * EB / 16;  // 16-byte pieces a row
    for (int i = t; i < 64 * kPR; i += wg::kThreads) {
      const int r = i / kPR, col = (i % kPR) * (16 / EB);
      if (row0 + r < M && n0 + col < N)  // whole pieces: N * EB is a multiple of 16
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(row0 + r) * ld + n0 + col) =
            *reinterpret_cast<const uint4*>(stage + r * RS + col * EB);
    }
  } else {
    for (int i = t; i < 64 * kBN; i += wg::kThreads) {
      const int r = i / kBN, col = i % kBN;
      if (row0 + r < M && n0 + col < N)
        out[static_cast<int64_t>(row0 + r) * ld + n0 + col] =
            *reinterpret_cast<const OT*>(stage + r * RS + col * EB);
    }
  }
  wg_sync();  // the stage is free for the next tile
}

}  // namespace gm
