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
// 20008 rows, K = 256, N = 768 for qkv) one launch does 2*M*N*K = 7.9 GFLOP
// (8 us at 989 TFLOP/s bf16) against 10.2 MB of x and 30.7 MB of bf16
// output (12 us at 3.35 TB/s), so it is bound by memory traffic: the
// weight is 196 KB and stays in L2.
//
// What the design does about it: x is read once per 64-column tile of the
// output (12 times for qkv, from L2 after the first), and the output is
// written once, in the caller's dtype (f32, or x's dtype cast in-register
// from the f32 value, which halves the dominant bf16 store). This first
// version does its products with f32 FMAs on the CUDA cores (67 TFLOP/s), so
// at these shapes it is bound by the FMA rate, not by bytes: moving the
// product onto the tensor cores (int8 widened to bf16 in registers, mma.sync
// or wgmma) is the next step.
//
// Tiling: one CTA of 256 threads owns a 64 x 64 output tile and walks K in
// steps of 32. The x tile is staged transposed (xs[k][m], rows padded to 68
// floats so a thread's four rows are one aligned float4), the weight tile
// as ws[k][n] with rows padded to 65 floats (conflict-free transposing
// stores). Thread (tx, ty) = (tid % 16, tid / 16) computes rows 4*ty..4*ty+3
// and columns tx + 16*j, j < 4. Ragged M, N and K are masked here: the
// caller pads nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;
constexpr int kXsStride = kBM + 4;  // float4-aligned rows of the x tile
constexpr int kWsStride = kBN + 1;  // conflict-free transposing stores

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

template <typename T, typename OT>
cudaError_t launch(const void* x, const void* w, const void* s, const void* b,
                   void* out, int M, int N, int K, int64_t ldx, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dequant_mm_kernel<T, OT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<OT*>(out), M, N, K, ldx);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) with row stride ldx (elements) and unit inner stride; w (N, K)
// int8 contiguous; scale (N,) f32; bias (N,) f32 or null; out (M, N)
// contiguous. x_dtype: 0 float32, 1 bfloat16; out_dtype: 0 float32 or
// x_dtype. Returns the launch's cudaError_t; runs asynchronously on
// `stream` and allocates nothing.
extern "C" int dequant_mm(const void* x, const void* w, const void* scale,
                          const void* bias, void* out, int M, int N, int K,
                          long long ldx, int x_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, w, scale, bias, out, M, N, K, ldx, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, scale, bias, out, M, N, K, ldx, s);
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, bias, out, M, N, K, ldx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
