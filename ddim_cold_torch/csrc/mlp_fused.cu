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
// 3.35 TB/s): balanced.
//
// In both routes the (M, hidden) activation never reaches device memory.
// There are two routes, chosen by dtype:
//
// * bfloat16 (mlp_fused_float_bf16, mlp_fused_w8a16_bf16,
//   mlp_fused_w8a8_bf16): both products on the tensor cores through
//   gemm_wgmma.cuh, one pipeline of weight chunks running through w1 and then
//   w2. A CTA of two warpgroups owns 128 rows (64 each). It stages its x rows
//   once (cp.async), runs fc1 in tiles of 128 hidden columns, and applies
//   the epilogue (+b1; w8a16 fmaf(acc, s1, b1); w8a8 the int32 sum times s1
//   with the activation scale folded in, + b1), round, GELU, round, writing
//   h as bf16 into shared memory in the K-major swizzled layout of fc2's A
//   operand. h stays in shared memory and not in registers: w8a8 needs it
//   there for its amax and requantization anyway, and at C = 384 the A
//   fragments of a warpgroup's 64 x 384 h would take 96 registers a thread
//   beside fc2's 64-register accumulator. fc2 then runs in tiles of 128
//   output columns; its epilogue is staged through shared memory and
//   written with 16-byte stores. float weights are bf16 (cast by the
//   caller) and copied; w8a16 codes are widened to bf16 (exact); w8a8 runs
//   both products as wgmma .s32.s8.s8 on the int8 x codes and the int8 h
//   codes, whose int32 sums equal the f32 route's exact sums. The rounding
//   to bf16 is integer arithmetic (the same round to nearest even as the
//   conversion instructions, which run at a quarter of the rate). Shared
//   memory at C = hidden = 256: x 64 KB, h 64 KB, the weight ring (float:
//   4 stages, 64 KB; w8a16: 2, 32 KB), the four bias and scale vectors; w8a8
//   x codes (later h codes) 32 KB, h 64, ring 32. At C = 384 x and h take
//   192 KB, the ring two stages and the vectors are read from device memory
//   (w8a8: 183 KB). The output is staged in x's region once fc1 is done (in
//   h's for w8a8). It takes K and hidden multiples of 16 with K + hidden up
//   to 768 (float and w8a16) for the shared memory.
// * float32 (mlp_fused_kernel, the exact oracle route): f32 FMAs on the CUDA
//   cores. One CTA of 256 threads owns 32 rows: it stages its x rows in
//   shared memory once (transposed, xT[k][row]), computes fc1 for all
//   hidden columns in 64-column chunks, applies bias, rounding and GELU,
//   and keeps h in shared memory (hT[n][row]); then fc2 reads h from there.
//   The weights stream through a 32 x 64 shared tile from L2. An int8 x
//   int8 product summed in f32 is exact for K, hidden <= 1040 (K * 127^2 <
//   2^24), which the wrapper checks. Warp w owns rows 4w..4w+3, lane l owns
//   columns l and l + 32 of a 64-column chunk; a thread's four rows are one
//   float4 of the transposed activation (rows padded to 36 floats),
//   broadcast over the warp. The tensor cores would give TF32 here, which
//   breaks the f32 limits.
//
// w8a8 requantization: the TPU kernel takes the amax of h over a block_m
// row tile (256 rows at the serve shape; any multiple of 32 up to 256 is
// legal), more rows than a CTA may hold, and a tile need not start on a
// CTA's first row (block_m = 96 against 128-row CTAs). The CTAs that cover
// whole tiles form a thread-block cluster: lcm(block_m, CTA rows) rows, at
// most 8 CTAs (the caller's geometry). Each CTA reduces the amax of every
// 16-row group of its rows (one warp's rows in the accumulator layout of
// the bf16 route; the f32 route's 32-row CTAs are one group each),
// publishes them in its shared memory, and after a cluster barrier reads
// its tile's groups over DSMEM. One launch, h still never leaves the SMs,
// and no CTA recomputes fc1. Rows past M are x = 0 rows (their h is
// gelu(b1)); the grid covers the padded rows so that they count in the
// last tile's amax, as in the TPU kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"
#include "launch_query.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 32;           // rows of x per CTA
constexpr int kThreads = 256;
constexpr int kChunk = 64;          // output columns per GEMM pass
constexpr int kBK = 32;             // reduction step
constexpr int kAStride = kRows + 4; // float4-aligned rows of xT / hT
constexpr int kWsStride = kChunk + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
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

// the launch of the float32 kernel: a CTA per 32 rows, clusters of `cluster`
// CTAs in w8a8 (mode 2)
lq::Launch config(int rows, int K, int Hf, int cluster, int mode) {
  return {(rows + kRows - 1) / kRows, 1, 1, kThreads, smem_bytes(K, Hf),
          mode == 2 ? cluster : 1};
}

template <typename XT, typename WT, typename T, int MODE>
cudaError_t launch(const void* x, const void* w1, const void* s1, const void* b1,
                   const void* w2, const void* s2, const void* b2, void* out,
                   int M, int rows, int K, int Hf, int Nout, int cluster,
                   cudaStream_t stream) {
  auto kernel = mlp_fused_kernel<XT, WT, T, MODE>;
  const lq::Launch l = config(rows, K, Hf, cluster, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.gx);
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (MODE == 2) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = l.cluster;
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


// ---------------------------------------------------------------- bfloat16

// Shared memory of the bf16 kernel: byte offsets of its 1024-aligned
// regions after the 1 KB of alignment slack: x (K chunks of 128 rows; for
// w8a8 later the h codes, hidden chunks of 128 rows), h (bf16, hidden chunks
// of 128 rows), the weight ring of `stages` stages, the 8 warps' amaxes,
// and when `vec` s1, b1 (hidden) and s2, b2 (out). Once fc1 is done, x's
// region stages the output tiles (w8a8: holds the h codes, and h's region
// stages the output).
template <int KIND>
struct MlpSmem {
  size_t xs, hs, ring, red, vec, total;
  __host__ __device__ MlpSmem(int K, int Hf, int Nout, int stages, bool with_vec) {
    const size_t kcx = (K + gm::kBK - 1) / gm::kBK, kch = (Hf + gm::kBK - 1) / gm::kBK;
    const size_t stage = gm::kGroups * gm::stage_bytes<__nv_bfloat16>();
    size_t x_bytes = kcx * gm::kRows * gm::row_bytes<KIND>(), h_bytes = kch * gm::kRows * 128;
    if (KIND == gm::kS8) {
      const size_t codes = kch * gm::kRows * 64;
      x_bytes = x_bytes > codes ? x_bytes : codes;
      h_bytes = h_bytes > stage ? h_bytes : stage;
    } else {
      x_bytes = x_bytes > stage ? x_bytes : stage;
    }
    xs = 0;
    hs = xs + x_bytes;
    ring = hs + h_bytes;
    red = ring + gm::ring_bytes<KIND>(stages);
    vec = red + 64;
    total = 1024 + vec + (with_vec ? 2 * sizeof(float) * (Hf + Nout) : 0);
  }
};

// h of hidden column n from fc1's accumulator: the epilogue, round, GELU,
// round
template <int KIND, typename A>
__device__ __forceinline__ float hidden(A acc, int n, const float* __restrict__ s1,
                                        const float* __restrict__ b1) {
  const float a = static_cast<float>(acc);
  const float y = KIND == gm::kBf16 ? a + b1[n] : fmaf(a, s1[n], b1[n]);
  return gm::round_bf16(gelu(gm::round_bf16(y)));
}

template <int KIND>
__device__ __forceinline__ void mlp_bf16_body(
    const uint8_t* __restrict__ x, const uint8_t* __restrict__ w1, const float* __restrict__ s1,
    const float* __restrict__ b1, const uint8_t* __restrict__ w2, const float* __restrict__ s2,
    const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int M, int K, int Hf,
    int Nout, int bm, int stages, int vec) {
  constexpr int RB = gm::row_bytes<KIND>();      // rows of the A operands: x, then h or its codes
  constexpr int XB = KIND == gm::kS8 ? 1 : 2;    // bytes of an x element
  const MlpSmem<KIND> L(K, Hf, Nout, stages, vec != 0);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = wg::align1024(smem_raw);
  uint8_t* xs = base + L.xs;
  uint8_t* hs = base + L.hs;
  uint8_t* qs = xs;  // w8a8: the h codes, once fc1 has read x
  float* red = reinterpret_cast<float*>(base + L.red);  // the warps' amaxes
  float* v_sm = reinterpret_cast<float*>(base + L.vec);
  // the epilogues' vectors, where they are read
  const float* s1v = vec ? v_sm : s1;
  const float* b1v = vec ? v_sm + Hf : b1;
  const float* s2v = vec ? v_sm + 2 * Hf : s2;
  const float* b2v = vec ? v_sm + 2 * Hf + Nout : b2;
  const int g = gm::group(), warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * gm::kRows;
  const int kcx = (K + gm::kBK - 1) / gm::kBK, kch = (Hf + gm::kBK - 1) / gm::kBK;
  const int t1 = (Hf + gm::kBN - 1) / gm::kBN, t2 = (Nout + gm::kBN - 1) / gm::kBN;
  const int n1 = t1 * kcx;  // fc1's chunks; fc2's follow
  // fc1's n1 chunks, then fc2's
  struct Src {
    gm::Walk fc1, fc2;
    int left1;
    __device__ __forceinline__ gm::Chunk next() { return left1-- > 0 ? fc1.next() : fc2.next(); }
  } src{gm::Walk(w1, Hf, K, 0), gm::Walk(w2, Nout, Hf, 0), n1};
  auto pipe = gm::make_pipe<KIND>(base + L.ring, src, n1 + t2 * kch, stages);
  pipe.start();
  if (vec) {  // with x's rows
    gm::load_vec(v_sm, s1, Hf);
    gm::load_vec(v_sm + Hf, b1, Hf);
    gm::load_vec(v_sm + 2 * Hf, s2, Nout);
    gm::load_vec(v_sm + 2 * Hf + Nout, b2, Nout);
  }
  gm::load_a<RB>(wg::smem_u32(xs), x, static_cast<int64_t>(K) * XB, row0, M, K * XB);
  wg::cp_async_wait<0>();
  wg::fence_proxy_async();
  __syncthreads();

  // fc1 -> bias -> round -> GELU -> round, into h; hidden columns in [Hf,
  // 64·kch) are zeros
  float mx = 0.f;  // this thread's amax of h
  for (int j = 0; j < t1; ++j) {
    gm::Acc<KIND> acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int t = 0; t < kcx; ++t)
      pipe.step(acc, wg::desc<RB>(wg::smem_u32(xs + t * gm::kRows * RB + g * 64 * RB)));
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int n = j * gm::kBN + gm::acc_col(i);  // even; n + 1 < Hf iff n < Hf
      if (n >= kch * gm::kBK) continue;
      float h0 = 0.f, h1 = 0.f;
      if (n < Hf) {
        h0 = hidden<KIND>(acc[i], n, s1v, b1v);
        h1 = hidden<KIND>(acc[i + 1], n + 1, s1v, b1v);
      }
      mx = fmaxf(mx, fmaxf(fabsf(h0), fabsf(h1)));
      *reinterpret_cast<uint32_t*>(hs + n / 64 * gm::kRows * 128 +
                                   wg::swz_elem<128>(64 * g + gm::acc_row(i), n % 64, 2)) =
          gm::bf16x2_bits(h0, h1);  // exact: h0, h1 are bf16 values
    }
  }
  wg::fence_proxy_async();
  __syncthreads();  // h is complete; x's region is free

  float h_scale = 1.f;
  if constexpr (KIND == gm::kS8) {
    // amax of this warp's 16 rows (one row group), then of its requant
    // tile's groups over the cluster (whole tiles lie in it; group G of the
    // cluster lives in CTA G / 8, entry G % 8)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[warp] = mx;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA of the cluster has published its amaxes
    const int per = bm / 16;  // row groups a tile
    const int first = (8 * static_cast<int>(cluster.block_rank()) + warp) / per * per;
    float amax = 0.f;
    if (lane < per) amax = *cluster.map_shared_rank(red + (first + lane) % 8, (first + lane) / 8);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    cluster.sync();  // no CTA leaves (or reuses red) while a peer reads it
    h_scale = amax > 0.f ? amax / 127.0f : 1.0f;
    // this warp's 16 rows of h -> int8 codes, 64-byte K-major rows
    const int pairs = kch * 32;  // column pairs a row
    for (int i = lane; i < 16 * pairs; i += 32) {
      const int r = 16 * warp + i / pairs, c = 2 * (i % pairs);
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          hs + c / 64 * gm::kRows * 128 + wg::swz_elem<128>(r, c % 64, 2)));
      *reinterpret_cast<char2*>(qs + c / 64 * gm::kRows * 64 + wg::swz_elem<64>(r, c % 64, 1)) =
          make_char2(static_cast<signed char>(fminf(fmaxf(rintf(v.x / h_scale), -127.f), 127.f)),
                     static_cast<signed char>(fminf(fmaxf(rintf(v.y / h_scale), -127.f), 127.f)));
    }
    wg::fence_proxy_async();
    __syncthreads();  // the codes are complete; h's region is free
  }

  // fc2 -> scale, bias -> out, staged per warpgroup
  const uint8_t* a2 = KIND == gm::kS8 ? qs : hs;
  uint8_t* stage = (KIND == gm::kS8 ? hs : xs) + g * gm::stage_bytes<__nv_bfloat16>();
  for (int j = 0; j < t2; ++j) {
    gm::Acc<KIND> acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int t = 0; t < kch; ++t)
      pipe.step(acc, wg::desc<RB>(wg::smem_u32(a2 + t * gm::kRows * RB + g * 64 * RB)));
    float y[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int n = j * gm::kBN + gm::acc_col(i);
      const float a = static_cast<float>(acc[i]);
      if (n >= Nout) {
        y[i] = 0.f;
      } else if constexpr (KIND == gm::kBf16) {
        y[i] = b2 != nullptr ? a + b2v[n] : a;
      } else {
        const float sc = KIND == gm::kS8 ? h_scale * s2v[n] : s2v[n];
        y[i] = b2 != nullptr ? fmaf(a, sc, b2v[n]) : a * sc;
      }
    }
    gm::store_tile<__nv_bfloat16>(y, stage, out, Nout, row0 + 64 * g, M, j * gm::kBN, Nout);
  }
}

#define MLP_BF16_PARAMS                                                                    \
  const uint8_t* __restrict__ x, const uint8_t* __restrict__ w1,                           \
      const float* __restrict__ s1, const float* __restrict__ b1,                          \
      const uint8_t* __restrict__ w2, const float* __restrict__ s2,                        \
      const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int M, int K, int Hf, \
      int Nout, int bm, int stages, int vec
#define MLP_BF16_ARGS x, w1, s1, b1, w2, s2, b2, out, M, K, Hf, Nout, bm, stages, vec

__global__ void __launch_bounds__(gm::kThreads, 1) mlp_fused_float_bf16(MLP_BF16_PARAMS) {
  mlp_bf16_body<gm::kBf16>(MLP_BF16_ARGS);
}
__global__ void __launch_bounds__(gm::kThreads, 1) mlp_fused_w8a16_bf16(MLP_BF16_PARAMS) {
  mlp_bf16_body<gm::kWiden>(MLP_BF16_ARGS);
}
__global__ void __launch_bounds__(gm::kThreads, 1) mlp_fused_w8a8_bf16(MLP_BF16_PARAMS) {
  mlp_bf16_body<gm::kS8>(MLP_BF16_ARGS);
}

template <int KIND>
auto bf16_kernel() {
  auto kernel = &mlp_fused_w8a8_bf16;
  if constexpr (KIND == gm::kBf16) kernel = &mlp_fused_float_bf16;
  if constexpr (KIND == gm::kWiden) kernel = &mlp_fused_w8a16_bf16;
  return kernel;
}

// the launch of a bfloat16 kernel: a CTA per 128 rows (two warpgroups),
// clusters of `cluster` CTAs in w8a8; `stages` and `vec` are the weight
// ring's depth and whether scale and bias fit in shared memory, the deepest
// ring that fits beside the vectors, else two stages and the vectors read
// from device memory (the most a block may use: 232448 B)
template <int KIND>
cudaError_t config_bf16(int rows, int K, int Hf, int Nout, int cluster, lq::Launch* l,
                        int* stages, bool* vec) {
  // x, the weights and the output move in 16-byte pieces, at 32-bit offsets
  if (K % 16 != 0 || Hf % 16 != 0
      || static_cast<int64_t>(Hf > Nout ? Hf : Nout) * (K > Hf ? K : Hf) >= (1LL << 30))
    return cudaErrorInvalidValue;
  *stages = 2;
  *vec = false;
  for (int st = KIND == gm::kWiden ? 2 : gm::kMaxStages; st >= 2 && !*vec; --st)
    if (MlpSmem<KIND>(K, Hf, Nout, st, true).total <= 232448) *stages = st, *vec = true;
  const size_t smem = MlpSmem<KIND>(K, Hf, Nout, *stages, *vec).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  *l = {(rows + gm::kRows - 1) / gm::kRows, 1, 1, gm::kThreads, smem,
        KIND == gm::kS8 ? cluster : 1};
  return cudaSuccess;
}

template <int KIND>
cudaError_t launch_bf16(const void* x, const void* w1, const void* s1, const void* b1,
                        const void* w2, const void* s2, const void* b2, void* out,
                        int M, int rows, int K, int Hf, int Nout, int cluster, int bm,
                        cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(x) & 15)
      || (reinterpret_cast<uintptr_t>(w1) & 15) || (reinterpret_cast<uintptr_t>(w2) & 15)
      || (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  auto kernel = bf16_kernel<KIND>();
  lq::Launch l;
  int stages = 2;
  bool vec = false;
  cudaError_t err = config_bf16<KIND>(rows, K, Hf, Nout, cluster, &l, &stages, &vec);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.gx);
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (KIND == gm::kS8) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = l.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint8_t*>(x),
                           static_cast<const uint8_t*>(w1), static_cast<const float*>(s1),
                           static_cast<const float*>(b1), static_cast<const uint8_t*>(w2),
                           static_cast<const float*>(s2), static_cast<const float*>(b2),
                           static_cast<__nv_bfloat16*>(out), M, K, Hf, Nout, bm, stages,
                           vec ? 1 : 0);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the entry point's argument checks: rows covers M; in w8a8 whole clusters
// of CTAs cover whole requant tiles of block_m rows
bool valid_args(int M, int rows, int K, int Hf, int Nout, int cluster, int block_m,
                int dtype, int mode) {
  const int cta = dtype == 1 ? gm::kRows : kRows;
  if (M < 1 || rows < M || K < 1 || Hf < 1 || Nout < 1) return false;
  return !(mode == 2 && (cluster < 1 || cluster > 8 || block_m < 32 || block_m % 32 != 0
                         || rows % (cluster * cta) != 0 || (cluster * cta) % block_m != 0));
}

// the launch and the kernel one mlp_fused call makes (the queries' dispatch)
cudaError_t plan(int M, int rows, int K, int Hf, int Nout, int cluster, int block_m,
                 int dtype, int mode, lq::Launch* l, const void** fn) {
  if (!valid_args(M, rows, K, Hf, Nout, cluster, block_m, dtype, mode))
    return cudaErrorInvalidValue;
  int stages = 2;
  bool vec = false;
  if (dtype == 0 && mode >= 0 && mode <= 2) {
    *l = config(rows, K, Hf, cluster, mode);
    *fn = mode == 0 ? reinterpret_cast<const void*>(mlp_fused_kernel<float, float, float, 0>)
        : mode == 1 ? reinterpret_cast<const void*>(mlp_fused_kernel<float, int8_t, float, 1>)
                    : reinterpret_cast<const void*>(mlp_fused_kernel<int8_t, int8_t, float, 2>);
    return cudaSuccess;
  }
  if (dtype == 1 && mode == 0) {
    *fn = reinterpret_cast<const void*>(bf16_kernel<gm::kBf16>());
    return config_bf16<gm::kBf16>(rows, K, Hf, Nout, cluster, l, &stages, &vec);
  }
  if (dtype == 1 && mode == 1) {
    *fn = reinterpret_cast<const void*>(bf16_kernel<gm::kWiden>());
    return config_bf16<gm::kWiden>(rows, K, Hf, Nout, cluster, l, &stages, &vec);
  }
  if (dtype == 1 && mode == 2) {
    *fn = reinterpret_cast<const void*>(bf16_kernel<gm::kS8>());
    return config_bf16<gm::kS8>(rows, K, Hf, Nout, cluster, l, &stages, &vec);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The launch an mlp_fused call with these shapes makes (launch_query.cuh's
// layout in out[0..5]), and its kernel's attributes at that launch.
extern "C" int mlp_fused_launch_config(int M, int rows, int K, int Hf, int Nout, int cluster,
                                       int block_m, int dtype, int mode, long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(M, rows, K, Hf, Nout, cluster, block_m, dtype, mode, &l, &fn);
  if (err == cudaSuccess) lq::put(l, out);
  return static_cast<int>(err);
}

extern "C" int mlp_fused_attributes(int M, int rows, int K, int Hf, int Nout, int cluster,
                                    int block_m, int dtype, int mode, long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(M, rows, K, Hf, Nout, cluster, block_m, dtype, mode, &l, &fn);
  return static_cast<int>(err == cudaSuccess ? lq::attributes(fn, l, out) : err);
}

// x (M, K) contiguous: T for modes 0 and 1, int8 codes for mode 2; w1
// (Hf, K), w2 (Nout, Hf) contiguous: T for mode 0, int8 otherwise; s1 (Hf,)
// and s2 (Nout,) f32 (null for mode 0; for mode 2 s1 carries the activation
// scale); b1 (Hf,) f32; b2 (Nout,) f32 or null; out (M, Nout) T. `rows` is
// the number of rows the grid covers (M, or for mode 2 M padded to whole
// clusters: `cluster` CTAs of 32 rows (float32) or 128 (bfloat16) cover
// whole requant tiles of `block_m` rows, a multiple of 32). dtype: 0
// float32 (CUDA-core FMAs), 1 bfloat16 (wgmma; K and Hf multiples of 16, x,
// w1, w2 and out 16-byte aligned, K + Hf up to 768 in modes 0 and 1).
// Returns the launch's cudaError_t; runs asynchronously on `stream` and
// allocates nothing.
extern "C" int mlp_fused(const void* x, const void* w1, const void* s1, const void* b1,
                         const void* w2, const void* s2, const void* b2, void* out,
                         int M, int rows, int K, int Hf, int Nout, int cluster, int block_m,
                         int dtype, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_args(M, rows, K, Hf, Nout, cluster, block_m, dtype, mode))
    return static_cast<int>(cudaErrorInvalidValue);
#define MLP_ARGS x, w1, s1, b1, w2, s2, b2, out, M, rows, K, Hf, Nout, cluster
  if (dtype == 0 && mode == 0) return launch<float, float, float, 0>(MLP_ARGS, st);
  if (dtype == 0 && mode == 1) return launch<float, int8_t, float, 1>(MLP_ARGS, st);
  if (dtype == 0 && mode == 2) return launch<int8_t, int8_t, float, 2>(MLP_ARGS, st);
  if (dtype == 1 && mode == 0) return launch_bf16<gm::kBf16>(MLP_ARGS, block_m, st);
  if (dtype == 1 && mode == 1) return launch_bf16<gm::kWiden>(MLP_ARGS, block_m, st);
  if (dtype == 1 && mode == 2) return launch_bf16<gm::kS8>(MLP_ARGS, block_m, st);
#undef MLP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
