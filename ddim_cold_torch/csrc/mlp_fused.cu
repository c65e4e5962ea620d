// Fused trunk Mlp for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: ddim_cold_tpu/ops/quant.py::_mlp_kernel (the Pallas TPU kernel
// reached from mlp_pallas's pallas_call). Same function, per row of x:
//   y1 = x @ w1^T (f32 sum) [* s1] + b1; h = round(gelu(round(y1)));
//   y  = h @ w2^T (f32 sum) [* s2] + b2,
// where round() is a rounding to the compute dtype T and gelu the exact
// (erf) GELU computed in f32. Modes: 0 float weights (cast to T by the
// caller), 1 w8a16 (int8 codes widened exactly to f32, per-column scales),
// 2 w8a8 (x arrives as int8 codes with the per-tensor activation scale
// folded into s1; h is requantized to int8 per block_m rows with
// scale amax|h| / 127, and y = (h_codes @ w2^T) * (h_scale * s2) + b2).
// Scale and bias are one fma, as in the TPU kernel. Weights are in torch's
// (out, in) layout. The output is written in T (the TPU kernel returns f32
// and its wrapper casts; the value is the same).
//
// What bounds it on this card: at the 200px/p4 serve shape (M = 20008 rows,
// K = hidden = out = 256) one launch does 4*M*256*256 = 5.2 GFLOP (5 us at
// 989 TFLOP/s bf16) against 10.2 MB of x in and 10.2 MB of y out (6 us at
// 3.35 TB/s): balanced, and both far below what CUDA-core FMAs reach.
//
// What the design does about it: the (M, hidden) activation never reaches
// device memory. One CTA of 256 threads owns 32 rows: it stages its x rows
// in shared memory once (transposed, xT[k][row]), computes fc1 for all
// hidden columns in 64-column chunks, applies bias, rounding and GELU, and
// keeps h in shared memory (hT[n][row]); then fc2 reads h from there. The
// weights stream through a 32 x 64 shared tile from L2 (a 256 x 256 int8
// weight is 64 KB, but float weights at 200px/p8 do not fit beside the
// activations). Products are f32 FMAs on the CUDA cores; tensor cores are
// the next step. An int8 x int8 product summed in f32 is exact for
// K, hidden <= 1040 (K * 127^2 < 2^24), which the wrapper checks.
//
// w8a8 requantization: the TPU kernel takes the amax of h over a block_m
// row tile (256 rows at the serve shape), more rows than a CTA holds (32
// rows x hidden floats must fit in shared memory next to x). The CTAs of
// one tile form a thread-block cluster (block_m / 32 <= 8 CTAs); each
// reduces its own amax, publishes it in its shared memory, and after a
// cluster barrier reads its peers' amaxes over DSMEM. One launch, h still
// never leaves the SMs, and no CTA recomputes fc1. Rows past M are x = 0
// rows (their h is gelu(b1)); the grid covers the padded rows so that they
// count in the last tile's amax, as in the TPU kernel.
//
// Thread mapping: warp w owns rows 4w..4w+3, lane l owns columns l and
// l + 32 of a 64-column chunk; a thread's four rows are one float4 of the
// transposed activation (rows padded to 36 floats), broadcast over the warp.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 32;           // rows of x per CTA
constexpr int kThreads = 256;
constexpr int kChunk = 64;          // output columns per GEMM pass
constexpr int kBK = 32;             // reduction step
constexpr int kAStride = kRows + 4; // float4-aligned rows of xT / hT
constexpr int kWsStride = kChunk + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// acc[i][c] = sum_k AT[k][4*warp + i] * W[n0 + lane + 32c][k], k < Kd. AT has
// round_up(Kd, 32) rows, the ones past Kd zero.
template <typename WT>
__device__ __forceinline__ void gemm_chunk(const float* AT, int Kd, const WT* __restrict__ W,
                                           int Nd, int n0, float* ws, float acc[4][2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int k0 = 0; k0 < Kd; k0 += kBK) {
    __syncthreads();  // the previous weight tile is consumed
    for (int i = tid; i < kChunk * kBK; i += kThreads) {
      const int n = i / kBK, k = i % kBK;
      const int row = n0 + n, col = k0 + k;
      ws[k * kWsStride + n] =
          (row < Nd && col < Kd) ? to_f32(W[static_cast<int64_t>(row) * Kd + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(AT + (k0 + k) * kAStride + 4 * warp);
      const float w0 = ws[k * kWsStride + lane];
      const float w1 = ws[k * kWsStride + lane + 32];
      acc[0][0] = fmaf(a.x, w0, acc[0][0]); acc[0][1] = fmaf(a.x, w1, acc[0][1]);
      acc[1][0] = fmaf(a.y, w0, acc[1][0]); acc[1][1] = fmaf(a.y, w1, acc[1][1]);
      acc[2][0] = fmaf(a.z, w0, acc[2][0]); acc[2][1] = fmaf(a.z, w1, acc[2][1]);
      acc[3][0] = fmaf(a.w, w0, acc[3][0]); acc[3][1] = fmaf(a.w, w1, acc[3][1]);
    }
  }
}

__device__ __forceinline__ float gelu(float v) {
  // exact GELU, the same expression as PyTorch's CUDA kernel
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
}

template <typename XT, typename WT, typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
mlp_fused_kernel(const XT* __restrict__ x, const WT* __restrict__ w1,
                 const float* __restrict__ s1, const float* __restrict__ b1,
                 const WT* __restrict__ w2, const float* __restrict__ s2,
                 const float* __restrict__ b2, T* __restrict__ out,
                 int M, int K, int Hf, int Nout) {
  extern __shared__ __align__(16) float smem[];
  const int Kp = round_up(K, kBK), Hp = round_up(Hf, kBK);
  float* xT = smem;                    // [Kp][kAStride]
  float* hT = xT + Kp * kAStride;      // [Hp][kAStride]
  float* ws = hT + Hp * kAStride;      // [kBK][kWsStride]
  float* red = ws + kBK * kWsStride;   // [kThreads / 32 + 1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kRows;

  // stage this CTA's rows of x, transposed; rows past M and k past K are 0
  for (int i = tid; i < kRows * Kp; i += kThreads) {
    const int r = i / Kp, k = i % Kp;
    const int row = r0 + r;
    xT[k * kAStride + r] = (row < M && k < K) ? to_f32(x[static_cast<int64_t>(row) * K + k]) : 0.f;
  }
  for (int i = Hf * kAStride + tid; i < Hp * kAStride; i += kThreads) hT[i] = 0.f;

  // fc1 -> bias -> round -> GELU -> round, into hT
  float acc[4][2];
  for (int n0 = 0; n0 < Hf; n0 += kChunk) {
    gemm_chunk(xT, K, w1, Hf, n0, ws, acc);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + lane + 32 * c;
      if (n >= Hf) continue;
      const float b = b1[n];
      const float s = MODE == 0 ? 1.f : s1[n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float y = MODE == 0 ? acc[i][c] + b : fmaf(acc[i][c], s, b);
        hT[n * kAStride + 4 * warp + i] = round_to<T>(gelu(round_to<T>(y)));
      }
    }
  }
  __syncthreads();

  float h_scale = 1.f;
  if constexpr (MODE == 2) {
    // amax over this CTA's rows, then over the cluster's CTAs (one block_m tile)
    float mx = 0.f;
    for (int i = tid; i < Hf * kRows; i += kThreads)
      mx = fmaxf(mx, fabsf(hT[(i / kRows) * kAStride + i % kRows]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (tid == 0) {
      float m = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
      red[kThreads / 32] = m;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA of the tile has published its amax
    float amax = 0.f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
      amax = fmaxf(amax, *cluster.map_shared_rank(red + kThreads / 32, r));
    cluster.sync();  // no CTA leaves (or reuses red) while a peer reads it
    h_scale = amax > 0.f ? amax / 127.0f : 1.0f;
    for (int i = tid; i < Hf * kAStride; i += kThreads)
      hT[i] = fminf(fmaxf(rintf(hT[i] / h_scale), -127.f), 127.f);
  }

  // fc2 -> scale, bias -> out
  for (int n0 = 0; n0 < Nout; n0 += kChunk) {
    gemm_chunk(hT, Hf, w2, Nout, n0, ws, acc);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + lane + 32 * c;
      if (n >= Nout) continue;
      const float s = MODE == 0 ? 1.f : (MODE == 2 ? h_scale * s2[n] : s2[n]);
      const float b = b2 != nullptr ? b2[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 4 * warp + i;
        if (row >= M) continue;
        float y;
        if (MODE == 0) y = b2 != nullptr ? acc[i][c] + b : acc[i][c];
        else y = b2 != nullptr ? fmaf(acc[i][c], s, b) : acc[i][c] * s;
        out[static_cast<int64_t>(row) * Nout + n] = from_f32<T>(y);
      }
    }
  }
}

size_t smem_bytes(int K, int Hf) {
  return sizeof(float) * (static_cast<size_t>(round_up(K, kBK) + round_up(Hf, kBK)) * kAStride
                          + kBK * kWsStride + kThreads / 32 + 1);
}

template <typename XT, typename WT, typename T, int MODE>
cudaError_t launch(const void* x, const void* w1, const void* s1, const void* b1,
                   const void* w2, const void* s2, const void* b2, void* out,
                   int M, int rows, int K, int Hf, int Nout, int cluster,
                   cudaStream_t stream) {
  auto kernel = mlp_fused_kernel<XT, WT, T, MODE>;
  const size_t smem = smem_bytes(K, Hf);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (MODE == 2) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x),
                           static_cast<const WT*>(w1), static_cast<const float*>(s1),
                           static_cast<const float*>(b1), static_cast<const WT*>(w2),
                           static_cast<const float*>(s2), static_cast<const float*>(b2),
                           static_cast<T*>(out), M, K, Hf, Nout);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x (M, K) contiguous: T for modes 0 and 1, int8 codes for mode 2; w1
// (Hf, K), w2 (Nout, Hf) contiguous: T for mode 0, int8 otherwise; s1 (Hf,)
// and s2 (Nout,) f32 (null for mode 0; for mode 2 s1 carries the activation
// scale); b1 (Hf,) f32; b2 (Nout,) f32 or null; out (M, Nout) T. `rows` is
// the number of rows the grid covers (M, or M padded to block_m for mode 2,
// whose block_m / 32 = `cluster` CTAs form one cluster). dtype: 0 float32,
// 1 bfloat16 (T). Returns the launch's cudaError_t; runs asynchronously on
// `stream` and allocates nothing.
extern "C" int mlp_fused(const void* x, const void* w1, const void* s1, const void* b1,
                         const void* w2, const void* s2, const void* b2, void* out,
                         int M, int rows, int K, int Hf, int Nout, int cluster,
                         int dtype, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || rows < M || K < 1 || Hf < 1 || Nout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 2 && (cluster < 1 || cluster > 8 || rows % (cluster * kRows) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
#define MLP_ARGS x, w1, s1, b1, w2, s2, b2, out, M, rows, K, Hf, Nout, cluster, st
  if (dtype == 0 && mode == 0) return launch<float, float, float, 0>(MLP_ARGS);
  if (dtype == 1 && mode == 0) return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, 0>(MLP_ARGS);
  if (dtype == 0 && mode == 1) return launch<float, int8_t, float, 1>(MLP_ARGS);
  if (dtype == 1 && mode == 1) return launch<__nv_bfloat16, int8_t, __nv_bfloat16, 1>(MLP_ARGS);
  if (dtype == 0 && mode == 2) return launch<int8_t, int8_t, float, 2>(MLP_ARGS);
  if (dtype == 1 && mode == 2) return launch<int8_t, int8_t, __nv_bfloat16, 2>(MLP_ARGS);
#undef MLP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
