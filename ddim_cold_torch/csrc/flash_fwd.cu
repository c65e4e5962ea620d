// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: ddim_cold_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel reached from _flash_forward's pallas_call). Same function: non-causal
// multi-head softmax(q·kᵀ·scale)·v with an online softmax, a running
// (max, denominator, accumulator) per query row in f32, key columns >= N
// masked to -1e30, p rounded to v's dtype before P·V, and the per-row
// log-sum-exp lse = m + log(l) emitted beside O.
//
// What bounds it on this card: at the 200px/p4 geometry (N=2501, D=64) one
// launch does 4·B·H·N²·D FLOP against 4·B·N·H·D·2 bytes of q/k/v/O, about
// 1,250 FLOP per byte: far above the H100's ridge (~295 bf16, ~20 f32 CUDA
// core FLOP per byte), so it is bound by arithmetic, never by memory.
//
// What the design does about it: the N×N logits never leave the SM. Each CTA
// owns 64 query rows of one (batch, head) and walks all key/value tiles
// through shared memory, so the only device-memory traffic is q, k, v once
// per CTA (served from L2 after the first CTA of a head) and O plus lse once.
// There are two instantiations, chosen by dtype only:
//
// * bfloat16 (flash_fwd_bf16_wgmma, the served and trained route): both
//   GEMMs on the tensor cores through wgmma, one warpgroup per CTA. The Q
//   tile is loaded once; K/V tiles of 64 keys arrive by cp.async into a
//   two-stage ring of 128B- (D=64) or 64B-swizzled (D=32) shared tiles, the
//   next tile's copy in flight while the current one is consumed; the tile
//   step of attn_wgmma.cuh computes S = Q·Kᵀ (m64n64k16, both operands in
//   shared memory, K read K-major as it lies), the online softmax on the
//   accumulator fragment, P rounded to bf16 in registers as the A operand of
//   O += P·V (m64nDk16, V read with the transpose bit). cp.async rather
//   than TMA: the copying threads are the consuming warpgroup, the q/k/v
//   slices of the (B, N, 3, H, D) projection are plain strided rows (no
//   tensor map to encode on the host), and the copy's source size
//   zero-fills the ragged tail; the wrapper refuses rows that are not 16-byte
//   aligned. 40 KB of shared memory (D=64), so several CTAs share an SM and
//   overlap one another's softmax with their wgmma.
// * float32 (flash_fwd_kernel, the exact oracle route): f32 FMAs on the CUDA
//   cores, inputs staged through shared memory. The tensor cores would give
//   TF32 here, which breaks the f32 limits.
//
// Layout: q, k and v are read through their (batch, token, head) strides, so
// the (B, N, 3, H, D) qkv projection is consumed in place with no transposed
// or padded copy; the innermost (head-dim) stride must be 1. O is written
// (B, N, H, D)-contiguous and lse as (B·H, N) f32.
//
// f32 thread mapping: 4 warps per CTA, 16 query rows per warp. In S = Q·Kᵀ a
// lane owns key columns lane and lane+32 of a 64-key tile for its warp's 16
// rows; in P·V it owns head-dim columns lane (+32 when D=64). Q rows and P
// rows are read as broadcast float4s from shared memory; K is staged
// transposed (with a one-word pad so the transposing store is conflict-free)
// and V row-major.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_wgmma.cuh"
#include "launch_query.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 64 query rows per CTA
constexpr int kBlockKV = 64;                    // keys per shared-memory tile
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;               // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// p rounded to v's dtype, back in f32 for the FMA (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * D              // Q tile, row-major
                          + D * (kBlockKV + 1)     // K tile, transposed + pad
                          + kBlockKV * D           // V tile, row-major
                          + kBlockQ * kBlockKV);   // P, one 16×64 slab per warp
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int N, int H, float scale,
                 int64_t sqb, int64_t sqn, int64_t sqh,
                 int64_t skb, int64_t skn, int64_t skh,
                 int64_t svb, int64_t svn, int64_t svh) {
  static_assert(D == 32 || D == 64, "head dim must be 32 or 64");
  constexpr int kDPL = D / 32;  // head-dim columns per lane in P·V

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [kBlockQ][D]
  float* kt = qs + kBlockQ * D;              // [D][kBlockKV + 1]
  float* vs = kt + D * (kBlockKV + 1);       // [kBlockKV][D]
  float* ps = vs + kBlockKV * D;             // [kBlockQ][kBlockKV]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  // stage this CTA's query rows (zero rows past N: computed, never stored)
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    qs[i] = row < N ? to_f32(qb[row * sqn + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;  // this lane's partial denominator; summed over the warp at the end
#pragma unroll
    for (int c = 0; c < kDPL; ++c) acc[r][c] = 0.f;
  }

  const float* qw = qs + warp * kRowsPerWarp * D;
  float* pw = ps + warp * kRowsPerWarp * kBlockKV;

  for (int j0 = 0; j0 < N; j0 += kBlockKV) {
    __syncthreads();  // previous tile fully consumed (and Q staged, first time)
    for (int i = tid; i < kBlockKV * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int col = j0 + j;
      const bool ok = col < N;
      kt[d * (kBlockKV + 1) + j] = ok ? to_f32(kb[col * skn + d]) : 0.f;
      vs[j * D + d] = ok ? to_f32(vb[col * svn + d]) : 0.f;
    }
    __syncthreads();

    // S = Q·Kᵀ for 16 rows × key columns (lane, lane+32)
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float k0[4], k1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k0[e] = kt[(d + e) * (kBlockKV + 1) + lane];
        k1[e] = kt[(d + e) * (kBlockKV + 1) + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * D + d);
        s[r][0] = fmaf(qv.x, k0[0], s[r][0]);
        s[r][0] = fmaf(qv.y, k0[1], s[r][0]);
        s[r][0] = fmaf(qv.z, k0[2], s[r][0]);
        s[r][0] = fmaf(qv.w, k0[3], s[r][0]);
        s[r][1] = fmaf(qv.x, k1[0], s[r][1]);
        s[r][1] = fmaf(qv.y, k1[1], s[r][1]);
        s[r][1] = fmaf(qv.z, k1[2], s[r][1]);
        s[r][1] = fmaf(qv.w, k1[3], s[r][1]);
      }
    }

    // online softmax: fold this tile into (m, l, acc); P goes to this warp's slab
    const bool ok0 = j0 + lane < N;
    const bool ok1 = j0 + lane + 32 < N;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float x0 = ok0 ? s[r][0] * scale : kNegInf;
      const float x1 = ok1 ? s[r][1] * scale : kNegInf;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      l[r] = l[r] * alpha + (p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kDPL; ++c) acc[r][c] *= alpha;
      pw[r * kBlockKV + lane] = round_to<T>(p0);
      pw[r * kBlockKV + lane + 32] = round_to<T>(p1);
    }
    __syncwarp();

    // acc += P·V over the tile's 64 keys
#pragma unroll 2
    for (int j = 0; j < kBlockKV; j += 4) {
      float vv[4][kDPL];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kDPL; ++c) vv[e][c] = vs[(j + e) * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + r * kBlockKV + j);
#pragma unroll
        for (int c = 0; c < kDPL; ++c) {
          acc[r][c] = fmaf(pv.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(pv.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(pv.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(pv.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

  // emit O = acc / l (input dtype, (B, N, H, D)) and lse = m + log l
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row < N) {
      T* orow = o + ((static_cast<int64_t>(b) * N + row) * H + h) * D;
#pragma unroll
      for (int c = 0; c < kDPL; ++c) orow[lane + 32 * c] = from_f32<T>(acc[r][c] / lt);
      if (lane == 0) lse[static_cast<int64_t>(bh) * N + row] = m[r] + logf(lt);
    }
  }
}

// the launch of the float32 kernel: a CTA per 64 query rows of a (batch, head)
template <int D>
lq::Launch config(int B, int N, int H) {
  return {(N + kBlockQ - 1) / kBlockQ, B * H, 1, kThreads, smem_bytes<D>(), 1};
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int N, int H, float scale, const int64_t* st,
                   cudaStream_t stream) {
  const lq::Launch l = config<D>(B, N, H);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<dim3(l.gx, l.gy), l.threads, l.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), N, H, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bfloat16

// Q, then two stages of (K, V): five 64-row tiles, plus the alignment slack
template <int D>
constexpr size_t bf16_smem_bytes() { return 1024 + 5 * 64 * 2 * D; }

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 4)
flash_fwd_bf16_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int N, int H, float scale_log2,
                     int64_t sqb, int64_t sqn, int64_t sqh,
                     int64_t skb, int64_t skn, int64_t skh,
                     int64_t svb, int64_t svn, int64_t svh) {
  constexpr int RB = 2 * D;     // bytes of one row of a Q, K or V tile
  constexpr int kTile = 64 * RB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = wg::smem_u32(wg::align1024(smem_raw));
  // ring stage s: K at qs + (1 + 2s)·kTile, V right after it
  auto k_at = [qs](int s) { return qs + (1 + 2 * s) * kTile; };

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 64;
  const uint8_t* qb = reinterpret_cast<const uint8_t*>(q + b * sqb + h * sqh);
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(k + b * skb + h * skh);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(v + b * svb + h * svh);
  const int64_t qrow = 2 * sqn, krow = 2 * skn, vrow = 2 * svn;  // bytes per token

  // Q (rows past N are zeros: computed, never stored) and the first K/V tile
  wg::load_tile<RB>(qs, qb, qrow, q0, N);
  wg::load_tile<RB>(k_at(0), kb, krow, 0, N);
  wg::load_tile<RB>(k_at(0) + kTile, vb, vrow, 0, N);
  wg::cp_async_commit();

  wg::Attn<D> st;
  wg::attn_init(st);
  const uint64_t dq = wg::desc<RB>(qs);
  const int tiles = (N + 63) / 64;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {  // the next tile's copy runs under this tile's math
      const int nxt = (t + 1) & 1, j0 = (t + 1) * 64;
      wg::load_tile<RB>(k_at(nxt), kb, krow, j0, N);
      wg::load_tile<RB>(k_at(nxt) + kTile, vb, vrow, j0, N);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // tile t (and Q) have landed
    wg::fence_proxy_async();
    __syncthreads();
    wg::attn_step<D>(st, dq, k_at(t & 1), k_at(t & 1) + kTile, N - t * 64, scale_log2);
    __syncthreads();  // stage t & 1 is free for tile t + 2
  }

  // O = o / l in bf16, (B, N, H, D); lse = m + log l
  float l[2], ls[2];
  wg::attn_finish(st, l, ls);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= N) continue;
    __nv_bfloat16* orow = o + ((static_cast<int64_t>(b) * N + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(st.o[4 * j + 2 * r] / l[r], st.o[4 * j + 2 * r + 1] / l[r]);
    if ((lane & 3) == 0) lse[static_cast<int64_t>(bh) * N + row] = ls[r];
  }
}

// the launch of the bfloat16 kernel: one warpgroup per 64 query rows of a
// (batch, head)
template <int D>
lq::Launch config_bf16(int B, int N, int H) {
  return {(N + 63) / 64, B * H, 1, wg::kThreads, bf16_smem_bytes<D>(), 1};
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int B, int N, int H, float scale, const int64_t* st,
                        cudaStream_t stream) {
  // cp.async moves 16-byte pieces of rows: every base and stride must keep them aligned
  uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
                   | reinterpret_cast<uintptr_t>(v);
  for (int i = 0; i < 9; ++i) bits |= static_cast<uintptr_t>(st[i] * 2);
  if (bits & 15) return cudaErrorInvalidValue;
  const lq::Launch l = config_bf16<D>(B, N, H);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_wgmma<D><<<dim3(l.gx, l.gy), l.threads, l.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), N, H, scale * wg::kLog2e,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// the launch and the kernel one flash_fwd call makes (the queries' dispatch)
cudaError_t plan(int B, int N, int H, int D, int dtype, lq::Launch* l, const void** fn) {
  if (B < 1 || N < 1 || H < 1) return cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) *l = config<64>(B, N, H), *fn = reinterpret_cast<const void*>(flash_fwd_kernel<float, 64>);
  else if (dtype == 0 && D == 32) *l = config<32>(B, N, H), *fn = reinterpret_cast<const void*>(flash_fwd_kernel<float, 32>);
  else if (dtype == 1 && D == 64) *l = config_bf16<64>(B, N, H), *fn = reinterpret_cast<const void*>(flash_fwd_bf16_wgmma<64>);
  else if (dtype == 1 && D == 32) *l = config_bf16<32>(B, N, H), *fn = reinterpret_cast<const void*>(flash_fwd_bf16_wgmma<32>);
  else return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// The launch a flash_fwd call with these shapes makes (launch_query.cuh's
// layout in out[0..5]), and its kernel's attributes at that launch.
extern "C" int flash_fwd_launch_config(int B, int N, int H, int D, int dtype, long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(B, N, H, D, dtype, &l, &fn);
  if (err == cudaSuccess) lq::put(l, out);
  return static_cast<int>(err);
}

extern "C" int flash_fwd_attributes(int B, int N, int H, int D, int dtype, long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(B, N, H, D, dtype, &l, &fn);
  return static_cast<int>(err == cudaSuccess ? lq::attributes(fn, l, out) : err);
}

// dtype: 0 = float32 (CUDA-core FMAs), 1 = bfloat16 (wgmma; every base
// pointer 16-byte aligned and every stride a multiple of 8). Strides are in
// elements, in the order (q batch, q token, q head, k batch, k token, k head,
// v batch, v token, v head). Returns the launch's cudaError_t (0 on
// success); the kernel runs asynchronously on `stream` and allocates
// nothing.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int N, int H, int D, int dtype,
                         long long sqb, long long sqn, long long sqh,
                         long long skb, long long skn, long long skh,
                         long long svb, long long svn, long long svh,
                         float scale, void* stream) {
  const int64_t st[9] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64) return launch<float, 64>(q, k, v, o, lse, B, N, H, scale, st, s);
  if (dtype == 0 && D == 32) return launch<float, 32>(q, k, v, o, lse, B, N, H, scale, st, s);
  if (dtype == 1 && D == 64) return launch_bf16<64>(q, k, v, o, lse, B, N, H, scale, st, s);
  if (dtype == 1 && D == 32) return launch_bf16<32>(q, k, v, o, lse, B, N, H, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
