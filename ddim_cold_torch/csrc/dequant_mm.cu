// W8A16 dequant matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: ddim_cold_tpu/ops/quant.py::_mm_kernel (the Pallas TPU kernel
// reached from _dequant_matmul_pallas's pallas_call). Same function:
// out[m, n] = (sum_k x[m, k] * w[n, k]) * scale[n] + bias[n], with x float32
// or bfloat16, w int8 codes widened to x's values (exact: |code| <= 127),
// products summed in f32 and the per-column scale and bias applied once, at
// the end, as one fma (the TPU kernel's contraction point, quant.py:283-289).
// w is kept in torch's (out, in) layout, so w[n, k] is the JAX kernel[k, n].
//
// What bounds it on this card: at the 200px/p4 serve shape (M = 8 x 2501 =
// 20008 rows, K = 256, N = 768 for qkv, 256 for proj, fc1 and fc2) one qkv
// launch does 2*M*N*K = 7.9 GFLOP (8 us at 989 TFLOP/s bf16) against
// 10.2 MB of x and 30.7 MB of bf16 output (12 us at 3.35 TB/s), so it is
// bound by memory traffic: the weight is 196 KB and stays in L2.
//
// Two routes, chosen by x's dtype:
//
// * bfloat16 x (dequant_mm_bf16_wgmma, out bf16 or f32): the products on the
//   tensor cores through gemm_wgmma.cuh. A CTA of two warpgroups owns 128
//   rows (64 each); it stages its x rows once (cp.async, zero-filled past M
//   and K: 128 x 256 bf16 = 64 KB at the serve shape) and walks output tiles
//   of 128 columns, the int8 weight chunks widened to bf16 (exact) on their
//   way from L2 into the two-stage ring, so x is read from device memory
//   once per row tile and the weight from L2. The grid is persistent: as
//   many CTAs as are resident at once (one an SM at the serve shape), each
//   taking a contiguous run of the (row tile, column tile) items, so the
//   157 row tiles x 6 column tiles of the qkv shape spread evenly within
//   one item, and a CTA reloads x only when its run enters a new row tile.
//   The epilogue is one fmaf(acc, s, b) per element (scale and bias staged
//   in shared memory), staged through shared memory and written with
//   coalesced 16-byte stores. It needs K a multiple of 16 and x rows
//   16-byte aligned (the wrapper copies x and the codes into a zero-padded
//   K otherwise: zeros change no sum), and K up to 448 (f32 out) or 640
//   (bf16 out) for the shared memory: x is held whole.
// * float32 x (dequant_mm_kernel, the exact oracle route): f32 FMAs on the
//   CUDA cores. One CTA of 256 threads owns a 64 x 64 output tile and walks
//   K in steps of 32. The x tile is staged transposed (xs[k][m], rows padded
//   to 68 floats so a thread's four rows are one aligned float4), the weight
//   tile as ws[k][n] with rows padded to 65 floats (conflict-free
//   transposing stores). Thread (tx, ty) = (tid % 16, tid / 16) computes
//   rows 4*ty..4*ty+3 and columns tx + 16*j, j < 4. Ragged M, N and K are
//   masked here: the caller pads nothing. The tensor cores would give TF32
//   here, which breaks the f32 limits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"
#include "launch_query.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;
constexpr int kXsStride = kBM + 4;  // float4-aligned rows of the x tile
constexpr int kWsStride = kBN + 1;  // conflict-free transposing stores

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename T, typename OT>
__global__ void __launch_bounds__(kThreads)
dequant_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  OT* __restrict__ out, int M, int N, int K, int64_t ldx) {
  __shared__ __align__(16) float xs[kBK * kXsStride];
  __shared__ float ws[kBK * kWsStride];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // stage: consecutive threads walk k, so the global reads are contiguous
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK;
      const int row = m0 + r, col = k0 + k;
      xs[k * kXsStride + r] =
          (row < M && col < K) ? to_f32(x[static_cast<int64_t>(row) * ldx + col]) : 0.f;
    }
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int n = i / kBK, k = i % kBK;
      const int row = n0 + n, col = k0 + k;
      ws[k * kWsStride + n] =
          (row < N && col < K) ? static_cast<float>(w[static_cast<int64_t>(row) * K + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + k * kXsStride + 4 * ty);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wv = ws[k * kWsStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(xr[i], wv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const float s = scale[n];
    const float b = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m >= M) continue;
      const float y = bias != nullptr ? fmaf(acc[i][j], s, b) : acc[i][j] * s;
      store(out + static_cast<int64_t>(m) * N + n, y);
    }
  }
}

// the launch of the float32 kernel: a CTA per 64×64 output tile, its tiles
// in static shared memory
lq::Launch config(int M, int N) {
  return {(N + kBN - 1) / kBN, (M + kBM - 1) / kBM, 1, kThreads, 0, 1};
}

template <typename T, typename OT>
cudaError_t launch(const void* x, const void* w, const void* s, const void* b,
                   void* out, int M, int N, int K, int64_t ldx, cudaStream_t stream) {
  const lq::Launch l = config(M, N);
  dequant_mm_kernel<T, OT><<<dim3(l.gx, l.gy), l.threads, l.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<OT*>(out), M, N, K, ldx);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bfloat16

// shared memory of the bf16 kernel: 1 KB of alignment slack, x (K chunks
// of 128 rows), the weight ring, the two warpgroups' output stages, and
// scale and bias when `vec` (else they are read from device memory)
template <typename OT>
size_t bf16_smem_bytes(int N, int K, bool vec) {
  const size_t kc = (K + gm::kBK - 1) / gm::kBK;
  return 1024 + kc * gm::kRows * 128 + gm::ring_bytes<gm::kWiden>(2)
         + gm::kGroups * gm::stage_bytes<OT>() + (vec ? 2 * sizeof(float) * N : 0);
}

template <typename OT>
__global__ void __launch_bounds__(gm::kThreads, 1)
dequant_mm_bf16_wgmma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      OT* __restrict__ out, int M, int N, int K, int64_t ldx, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const int kc = (K + gm::kBK - 1) / gm::kBK, g = gm::group();
  uint8_t* xs = wg::align1024(smem_raw);                  // kc chunks of 128 x rows
  uint8_t* ring = xs + kc * gm::kRows * 128;              // the weight ring
  uint8_t* stages = ring + gm::ring_bytes<gm::kWiden>(2);  // the warpgroups' output stages
  uint8_t* stage = stages + g * gm::stage_bytes<OT>();
  float* s_sm = reinterpret_cast<float*>(stages + gm::kGroups * gm::stage_bytes<OT>());
  const float* sv = vec ? s_sm : scale;                   // scale and bias, where they are read
  const float* bv = vec ? s_sm + N : bias;

  // this CTA's run of items (row tile m, column tile n), m-major
  const int tiles_n = (N + gm::kBN - 1) / gm::kBN;
  const int items = (M + gm::kRows - 1) / gm::kRows * tiles_n;
  const int i0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * items / gridDim.x);
  const int i1 = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * items / gridDim.x);
  // consecutive items are consecutive column tiles
  const gm::Walk src(reinterpret_cast<const uint8_t*>(w), N, K, i0 % tiles_n);
  auto pipe = gm::make_pipe<gm::kWiden>(ring, src, (i1 - i0) * kc, 2);
  pipe.start();
  if (vec) {  // lands with the first x rows
    gm::load_vec(s_sm, scale, N);
    gm::load_vec(s_sm + N, bias, N);
  }

  int m_cur = -1;
  for (int item = i0; item < i1; ++item) {
    const int m0 = item / tiles_n * gm::kRows, n0 = item % tiles_n * gm::kBN;
    if (m0 != m_cur) {  // x rows of a new row tile (no wgmma reads xs now)
      gm::load_a<128>(wg::smem_u32(xs), reinterpret_cast<const uint8_t*>(x), ldx * 2, m0, M, K * 2);
      wg::cp_async_wait<0>();
      wg::fence_proxy_async();
      __syncthreads();
      m_cur = m0;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int t = 0; t < kc; ++t)
      pipe.step(acc, wg::desc<128>(wg::smem_u32(xs + t * gm::kRows * 128 + g * 64 * 128)));
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int n = n0 + gm::acc_col(i);
      if (n < N) acc[i] = bias != nullptr ? fmaf(acc[i], sv[n], bv[n]) : acc[i] * sv[n];
    }
    gm::store_tile<OT>(acc, stage, out, N, m0 + 64 * g, M, n0, N);
  }
}

// the launch of the bfloat16 kernel: persistent, as many CTAs as fit the card
// at once (or one per 128×128 output tile, if fewer), each walking a run of
// tiles; `vec` says whether scale and bias fit in shared memory beside x
template <typename OT>
cudaError_t config_bf16(int M, int N, int K, lq::Launch* l, bool* vec) {
  // the codes move in 16-byte pieces, at 32-bit offsets
  if (K % 16 != 0 || static_cast<int64_t>(N) * K >= (1LL << 31)) return cudaErrorInvalidValue;
  *vec = bf16_smem_bytes<OT>(N, K, true) <= 232448;  // the most a block may use
  const size_t smem = bf16_smem_bytes<OT>(N, K, *vec);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = &dequant_mm_bf16_wgmma<OT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, gm::kThreads, smem);
  if (err != cudaSuccess) return err;
  const int items = (M + gm::kRows - 1) / gm::kRows * ((N + gm::kBN - 1) / gm::kBN);
  const int slots = (per_sm > 0 ? per_sm : 1) * sms;
  *l = {items < slots ? items : slots, 1, 1, gm::kThreads, smem, 1};
  return cudaSuccess;
}

template <typename OT>
cudaError_t launch_bf16(const void* x, const void* w, const void* s, const void* b, void* out,
                        int M, int N, int K, int64_t ldx, cudaStream_t stream) {
  // x rows move in 16-byte pieces
  if (ldx % 8 != 0 || (reinterpret_cast<uintptr_t>(x) & 15)
      || (reinterpret_cast<uintptr_t>(w) & 15) || (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  lq::Launch l;
  bool vec = false;
  const cudaError_t err = config_bf16<OT>(M, N, K, &l, &vec);
  if (err != cudaSuccess) return err;
  dequant_mm_bf16_wgmma<OT><<<l.gx, l.threads, l.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b), static_cast<OT*>(out),
      M, N, K, ldx, vec ? 1 : 0);
  return cudaGetLastError();
}

// the launch and the kernel one dequant_mm call makes (the queries' dispatch)
cudaError_t plan(int M, int N, int K, int x_dtype, int out_dtype, lq::Launch* l,
                 const void** fn) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  bool vec = false;
  if (x_dtype == 0 && out_dtype == 0) {
    *l = config(M, N);
    *fn = reinterpret_cast<const void*>(dequant_mm_kernel<float, float>);
    return cudaSuccess;
  }
  if (x_dtype == 1 && out_dtype == 0) {
    *fn = reinterpret_cast<const void*>(dequant_mm_bf16_wgmma<float>);
    return config_bf16<float>(M, N, K, l, &vec);
  }
  if (x_dtype == 1 && out_dtype == 1) {
    *fn = reinterpret_cast<const void*>(dequant_mm_bf16_wgmma<__nv_bfloat16>);
    return config_bf16<__nv_bfloat16>(M, N, K, l, &vec);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The launch a dequant_mm call with these shapes makes (launch_query.cuh's
// layout in out[0..5]), and its kernel's attributes at that launch.
extern "C" int dequant_mm_launch_config(int M, int N, int K, int x_dtype, int out_dtype,
                                        long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(M, N, K, x_dtype, out_dtype, &l, &fn);
  if (err == cudaSuccess) lq::put(l, out);
  return static_cast<int>(err);
}

extern "C" int dequant_mm_attributes(int M, int N, int K, int x_dtype, int out_dtype,
                                     long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(M, N, K, x_dtype, out_dtype, &l, &fn);
  return static_cast<int>(err == cudaSuccess ? lq::attributes(fn, l, out) : err);
}

// x (M, K) with row stride ldx (elements) and unit inner stride; w (N, K)
// int8 contiguous; scale (N,) f32; bias (N,) f32 or null; out (M, N)
// contiguous. x_dtype: 0 float32 (CUDA-core FMAs), 1 bfloat16 (wgmma; K a
// multiple of 16, ldx of 8, x, w and out 16-byte aligned, K up to 448 for an
// f32 out and 640 for bf16); out_dtype: 0 float32 or x_dtype. Returns the
// launch's cudaError_t; runs asynchronously on `stream` and allocates
// nothing.
extern "C" int dequant_mm(const void* x, const void* w, const void* scale,
                          const void* bias, void* out, int M, int N, int K,
                          long long ldx, int x_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, w, scale, bias, out, M, N, K, ldx, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch_bf16<float>(x, w, scale, bias, out, M, N, K, ldx, s);
  if (x_dtype == 1 && out_dtype == 1)
    return launch_bf16<__nv_bfloat16>(x, w, scale, bias, out, M, N, K, ldx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
