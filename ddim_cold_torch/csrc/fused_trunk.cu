// Fused quantized trunk attention for Hopper (sm_90a): qkv projection ->
// flash attention -> proj projection in one kernel. Plain C interface.
//
// Replaces: ddim_cold_tpu/ops/flash_attention.py::_fused_trunk_kernel (the
// Pallas TPU kernel reached from fused_trunk_attention's pallas_call). Same
// function: from x (B, N, C), q/k/v = (x @ Wqkv^T) * s + b with int8 codes
// widened exactly and f32 sums, rounded to the compute dtype T; per head the
// online softmax of flash_fwd.cu (f32 logits * scale, key columns >= N
// masked to -1e30, p rounded to T before P.V); the context o = acc / l
// rounded to T; y = (o @ Wp^T) * sp + bp, written in T (the TPU kernel
// writes f32 and its wrapper casts; the value is the same). Scale and bias
// are one fma. Weights keep torch's (out, in) layout: Wqkv rows are
// [q heads | k heads | v heads], head h at rows h*D .. h*D + D - 1 of each.
// Mode 2 (w8a8): x arrives as int8 codes with the per-tensor activation
// scale folded into s; the context is requantized to int8 per block_q rows
// of the padded sequence (scale amax|o| / 127 over the block's rows and all
// C columns; the padded query rows, whose x is 0, count), and
// y = (o_codes @ Wp^T) * (o_scale * sp) + bp.
//
// What bounds it on this card: the bound counts the work once. At the 200px
// p4 serve shape (B = 8, N = 2501, C = 256, 4 heads of 64) the qkv and proj
// projections are 2*B*N*C*4C = 10.2 GFLOP and the attention 4*B*N^2*C =
// 51.2 GFLOP: 61.5 GFLOP, 62 us at 989 TFLOP/s bf16, against 10 MB of x in
// and out. It is bound by operations.
//
// What the design does about it: neither the (B, N, 3C) projection nor the
// (B, N, C) context reaches device memory, in every mode: one launch per
// layer. 512 consecutive query rows of one batch element form a
// thread-block cluster (float32: 8 CTAs of 64 rows; bfloat16: 4 CTAs of
// 128). For each head a CTA projects its q rows, then walks the keys in
// groups of 512: each CTA of the cluster projects its slice of k and v for
// that head from x into its own shared memory; after a cluster barrier
// every CTA reads the slices in turn over DSMEM and folds each into the
// running softmax; a second barrier frees the slices. The context of all heads
// stays in shared memory; at the end the CTA applies the proj GEMM and
// writes y. The price of never writing k and v is recomputation: each
// cluster re-projects all N keys and values, 2*N*C*2C FLOP per cluster,
// 5 x 8 clusters x 0.66 GFLOP = 26 GFLOP per launch at the serve shape
// (64-row tiles without the cluster would make it 210 GFLOP; the TPU's
// 512-row q blocks make it 10). There are two instantiations, chosen by
// dtype only:
//
// * bfloat16 (fused_trunk_w8a16_bf16, fused_trunk_w8a8_bf16): every product
//   on the tensor cores. A CTA holds two warpgroups of 64 query rows each
//   (128 rows), so a cluster of 4 CTAs covers the same 512 rows; both
//   warpgroups fold every k/v tile the CTA holds, so a slice crosses DSMEM
//   once for 128 rows, and one warpgroup's softmax overlaps the other's
//   wgmma. A CTA projects a 128-key slice (64 keys a warpgroup) and uses
//   its own slice in place. The projections are wgmma with A = a 64-row x
//   tile (64-column chunks, cp.async into a two-stage ring) and B = the
//   weight tile, both K-major (the weights keep torch's (out, in) layout):
//   q 64 x D, the k|v slice 64 x 2D, proj 64 x 64 chunks of C. w8a16
//   widens the int8 weight tiles of a head to bf16 in shared memory once
//   per head (exact for |code| <= 127); w8a8 copies x codes and weight
//   codes as they are and multiplies them with wgmma .s32.s8.s8, whose
//   int32 sums equal the f32 route's exact sums bit for bit (C <= 1040), as
//   do the requantized context codes x Wp. The attention half is the tile
//   step of attn_wgmma.cuh. q, and later the context (rounded to bf16
//   before any use, so exact), live in shared memory as bf16 tiles of
//   64 x D, one per head and warpgroup: the context overwrites its head's
//   q. 225 KB of shared memory at C = 256 (w8a16), one CTA per SM: the
//   shared memory takes C up to 256 at D = 64 (w8a8: 320) and 384 at D = 32.
// * float32 (fused_trunk_kernel, the exact oracle route): f32 FMAs on the
//   CUDA cores, the context kept as ctxT[c][row] floats (C x 68), x and
//   int8 weight tiles widened to f32 as they are staged. The tensor cores
//   would give TF32 here, which breaks the f32 limits.
//
// w8a8 requantization: block_q (512 at N = 2501) spans several CTAs. The
// CTAs of one block (block_q / 64 of them, inside one cluster) exchange
// their context amaxes over DSMEM, so w8a8 too is one launch. int8 x int8
// products summed in f32 (or int32) are exact for C <= 1040.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "attn_wgmma.cuh"
#include "launch_query.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 64 query rows per CTA
constexpr int kBlockKV = 64;                    // keys per chunk
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;                         // projection reduction step
constexpr int kCluster = 8;                     // q tiles sharing key projections
constexpr int kAStride = kBlockQ + 4;           // float4-aligned transposed rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// weight row of output column n of a projection: the first `split` columns
// start at row lo, the others at row hi (k and v of one head)
struct RowMap {
  int lo, hi, split;
  __device__ __forceinline__ int operator()(int n) const {
    return n < split ? lo + n : hi + (n - split);
  }
};

// one 32-deep step of acc[r][c] += A[row][k] * W[map(lane + 32c)][k] for the
// warp's 16 rows, A transposed in shared memory (AT[k][row], stride kAStride)
template <int NC>
__device__ __forceinline__ void fma_step(const float* AT, const float* ws,
                                         float acc[kRowsPerWarp][NC / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    float a[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(AT + k * kAStride + warp * kRowsPerWarp + r);
      a[r] = v.x; a[r + 1] = v.y; a[r + 2] = v.z; a[r + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < NC / 32; ++c) {
      const float w = ws[k * (NC + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(a[r], w, acc[r][c]);
    }
  }
}

template <int NC>
__device__ __forceinline__ void stage_w(const int8_t* __restrict__ W, int C, RowMap map,
                                        int k0, float* ws) {
  for (int i = threadIdx.x; i < NC * kBK; i += kThreads) {
    const int n = i / kBK, k = i % kBK;
    ws[k * (NC + 1) + n] = static_cast<float>(W[static_cast<int64_t>(map(n)) * C + k0 + k]);
  }
}

// acc = x[row0 .. row0 + 63] @ W[map(0 .. NC-1)]^T; rows >= N read as 0
template <int NC, typename XT>
__device__ void project(const XT* __restrict__ xb, int N, int C, int row0,
                        const int8_t* __restrict__ W, RowMap map, float* xs, float* ws,
                        float acc[kRowsPerWarp][NC / 32]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < NC / 32; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kBK) {
    __syncthreads();  // the previous tiles (or ps, which they alias) are consumed
    for (int i = threadIdx.x; i < kBlockQ * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK;
      const int row = row0 + r;
      xs[k * kAStride + r] = row < N ? to_f32(xb[static_cast<int64_t>(row) * C + k0 + k]) : 0.f;
    }
    stage_w<NC>(W, C, map, k0, ws);
    __syncthreads();
    fma_step<NC>(xs, ws, acc);
  }
}

// acc = AT^T @ W[map(0 .. NC-1)]^T with AT (C x 64) already in shared memory
template <int NC>
__device__ void gemm_smem(const float* AT, int C, const int8_t* __restrict__ W, RowMap map,
                          float* ws, float acc[kRowsPerWarp][NC / 32]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < NC / 32; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kBK) {
    __syncthreads();
    stage_w<NC>(W, C, map, k0, ws);
    __syncthreads();
    fma_step<NC>(AT + k0 * kAStride, ws, acc);
  }
}

template <int D>
__host__ __device__ constexpr int proj_cols() { return 2 * D > 64 ? 2 * D : 64; }

template <int D>
size_t smem_floats(int C) {
  const size_t ps = kBlockQ * kBlockKV;
  const size_t tiles = kBK * kAStride + kBK * (proj_cols<D>() + 1);
  return kBlockQ * D + 2 * (D * (kBlockKV + 1) + kBlockKV * D) + (ps > tiles ? ps : tiles)
         + static_cast<size_t>(C) * kAStride + 8;
}

template <typename T, typename XT, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_trunk_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wqkv,
                   const float* __restrict__ sqkv, const float* __restrict__ bqkv,
                   const int8_t* __restrict__ wp, const float* __restrict__ sp,
                   const float* __restrict__ bp, T* __restrict__ out,
                   int N, int H, int group, float scale) {
  constexpr int kDPL = D / 32;
  constexpr int kKV = 2 * D;  // k and v columns of one head
  const int C = H * D;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                            // [kBlockQ][D]
  float* kt = qs + kBlockQ * D;                // [D][kBlockKV + 1]
  float* vs = kt + D * (kBlockKV + 1);         // [kBlockKV][D]
  float* kto = vs + kBlockKV * D;              // this CTA's key slice: k^T
  float* vso = kto + D * (kBlockKV + 1);       // ... and v
  float* un = vso + kBlockKV * D;              // ps, or the projection tiles
  float* ps = un;                              // [kBlockQ][kBlockKV]
  float* xs = un;                              // [kBK][kAStride]
  float* ws = un + kBK * kAStride;             // [kBK][proj_cols + 1]
  const size_t un_size = kBlockQ * kBlockKV > kBK * kAStride + kBK * (proj_cols<D>() + 1)
                             ? kBlockQ * kBlockKV : kBK * kAStride + kBK * (proj_cols<D>() + 1);
  float* ctxT = un + un_size;                  // [C][kAStride]
  float* red = ctxT + static_cast<size_t>(C) * kAStride;  // [kWarps + 1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const XT* xb = x + static_cast<int64_t>(b) * N * C;
  const float* qw = qs + warp * kRowsPerWarp * D;
  float* pw = ps + warp * kRowsPerWarp * kBlockKV;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  for (int h = 0; h < H; ++h) {
    // q rows of head h (rows past N are x = 0 rows: q = bias)
    {
      float acc[kRowsPerWarp][kDPL];
      const RowMap map{h * D, 0, D};
      project<D>(xb, N, C, q0, wqkv, map, xs, ws, acc);
#pragma unroll
      for (int c = 0; c < kDPL; ++c) {
        const int d = lane + 32 * c, n = map(d);
        const float s = sqkv[n], bias = bqkv != nullptr ? bqkv[n] : 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          qs[(warp * kRowsPerWarp + r) * D + d] = round_to<T>(fmaf(acc[r][c], s, bias));
      }
    }

    float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][kDPL];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kDPL; ++c) o[r][c] = 0.f;
    }

    for (int s0 = 0; s0 < N; s0 += kBlockKV * cs) {
      // k and v of head h for this CTA's slice of the cluster's keys,
      // s0 + 64*rank .. + 63, into kto / vso (the condition is uniform over
      // the CTA, so project()'s barriers are too)
      if (s0 + kBlockKV * rank < N) {
        float acc[kRowsPerWarp][kKV / 32];
        const RowMap map{C + h * D, 2 * C + h * D, D};
        project<kKV>(xb, N, C, s0 + kBlockKV * rank, wqkv, map, xs, ws, acc);
#pragma unroll
        for (int c = 0; c < kKV / 32; ++c) {
          const int j = lane + 32 * c, n = map(j);
          const float s = sqkv[n], bias = bqkv != nullptr ? bqkv[n] : 0.f;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const int key = warp * kRowsPerWarp + r;
            const float v = round_to<T>(fmaf(acc[r][c], s, bias));
            if (j < D) kto[j * (kBlockKV + 1) + key] = v;
            else vso[key * D + (j - D)] = v;
          }
        }
      }
      cluster.sync();  // every slice of this group of keys is projected

      for (int jr = 0; jr < cs && s0 + kBlockKV * jr < N; ++jr) {
        const int j0 = s0 + kBlockKV * jr;
        __syncthreads();  // the previous slice is consumed
        {
          // copy slice jr (from its CTA's shared memory, over DSMEM)
          const float* rk = cluster.map_shared_rank(kto, jr);
          const float* rv = cluster.map_shared_rank(vso, jr);
          for (int i = tid; i < D * (kBlockKV + 1); i += kThreads) kt[i] = rk[i];
          for (int i = tid; i < kBlockKV * D; i += kThreads) vs[i] = rv[i];
        }
        __syncthreads();

        // S = Q.K^T for 16 rows x key columns (lane, lane + 32), as flash_fwd.cu
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
          for (int c = 0; c < kDPL; ++c) o[r][c] *= alpha;
          pw[r * kBlockKV + lane] = round_to<T>(p0);
          pw[r * kBlockKV + lane + 32] = round_to<T>(p1);
        }
        __syncwarp();

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
              o[r][c] = fmaf(pv.x, vv[0][c], o[r][c]);
              o[r][c] = fmaf(pv.y, vv[1][c], o[r][c]);
              o[r][c] = fmaf(pv.z, vv[2][c], o[r][c]);
              o[r][c] = fmaf(pv.w, vv[3][c], o[r][c]);
            }
          }
        }
      }
      cluster.sync();  // the peers have copied this CTA's slice
    }

    // context of head h = o / l, rounded to T, into ctxT
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float lt = l[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
#pragma unroll
      for (int c = 0; c < kDPL; ++c)
        ctxT[(h * D + lane + 32 * c) * kAStride + warp * kRowsPerWarp + r] =
            round_to<T>(o[r][c] / lt);
    }
  }
  __syncthreads();

  float o_scale = 1.f;
  if constexpr (MODE == 2) {
    // amax of the context over this CTA's rows, then over its block's CTAs
    float mx = 0.f;
    for (int i = tid; i < C * kBlockQ; i += kThreads)
      mx = fmaxf(mx, fabsf(ctxT[(i / kBlockQ) * kAStride + i % kBlockQ]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (tid == 0) red[kWarps] = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
    cluster.sync();  // every CTA of the block has published its amax
    float amax = 0.f;
    const int g0 = rank / group * group;  // the block_q / 64 CTAs of this block
    for (int r = g0; r < g0 + group; ++r)
      amax = fmaxf(amax, *cluster.map_shared_rank(red + kWarps, r));
    cluster.sync();  // no CTA leaves while a peer reads its amax
    o_scale = amax > 0.f ? amax / 127.0f : 1.0f;
    for (int i = tid; i < C * kAStride; i += kThreads)
      ctxT[i] = fminf(fmaxf(rintf(ctxT[i] / o_scale), -127.f), 127.f);
  }

  // y = ctx @ Wp^T, scale and bias, in 64-column chunks
  for (int n0 = 0; n0 < C; n0 += 64) {
    float acc[kRowsPerWarp][2];
    gemm_smem<64>(ctxT, C, wp, RowMap{n0, 0, 64}, ws, acc);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + lane + 32 * c;
      const float s = MODE == 2 ? o_scale * sp[n] : sp[n];
      const float bias = bp != nullptr ? bp[n] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = q0 + warp * kRowsPerWarp + r;
        if (row < N)
          out[(static_cast<int64_t>(b) * N + row) * C + n] = from_f32<T>(fmaf(acc[r][c], s, bias));
      }
    }
  }
}

// the launch of the float32 kernel: a CTA per 64 query rows of a batch row,
// clusters of 8 sharing each key chunk's projection
template <int D>
lq::Launch config(int B, int H, int rows) {
  return {rows / kBlockQ, B, 1, kThreads, sizeof(float) * smem_floats<D>(H * D), kCluster};
}

template <typename T, typename XT, int D, int MODE>
cudaError_t launch(const void* x, const void* wqkv, const void* sqkv, const void* bqkv,
                   const void* wp, const void* sp, const void* bp, void* out,
                   int B, int N, int H, int rows, int group, float scale,
                   cudaStream_t stream) {
  auto kernel = fused_trunk_kernel<T, XT, D, MODE>;
  const lq::Launch l = config<D>(B, H, rows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.gx, l.gy);
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x),
                           static_cast<const int8_t*>(wqkv), static_cast<const float*>(sqkv),
                           static_cast<const float*>(bqkv), static_cast<const int8_t*>(wp),
                           static_cast<const float*>(sp), static_cast<const float*>(bp),
                           static_cast<T*>(out), N, H, group, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bfloat16

// Two consumer warpgroups per CTA, 64 query rows each: 128 rows a CTA, 4
// CTAs (512 rows, the f32 route's cluster) a cluster. Both warpgroups read
// every k/v tile the CTA holds, so a slice is copied once for 128 rows.
constexpr int kGroups = 2;
constexpr int kBThreads = kGroups * wg::kThreads;   // 256
constexpr int kBRows = kGroups * 64;                // 128 query rows a CTA
constexpr int kBCluster = kCluster * kBlockQ / kBRows;  // 4 CTAs, 512 rows

// x and weight tiles: 64-element chunks of the reduction dimension, rows of
// 128 bytes (bf16, w8a16) or 64 bytes (int8, w8a8)
template <int MODE> __host__ __device__ constexpr int chunk_bytes() { return MODE == 1 ? 128 : 64; }
// rows of the weight buffer: the k|v slice of a head (2D) or a 64-column
// chunk of Wp, whichever is more
template <int D> __host__ __device__ constexpr int w_rows() { return 2 * D > 64 ? 2 * D : 64; }

// shared memory of the bf16 kernel, in bytes (1 KB of alignment slack, then
// 1024-aligned regions: q/context tiles of 128 rows, weights, the x ring of
// two 128-row stages, this CTA's 128-key k|v slice, the slice being
// consumed, the w8a8 context codes, the amaxes)
template <int D, int MODE>
size_t bf16_smem_bytes(int C) {
  const size_t kc = C / 64, kb = chunk_bytes<MODE>();
  return 1024 + 2 * kBRows * static_cast<size_t>(C) + kc * w_rows<D>() * kb + 2 * kBRows * kb
         + 2 * 4 * 64 * 2 * D + (MODE == 2 ? kBRows * static_cast<size_t>(C) : 0) + 64;
}

__device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) { wg::mma_bf16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) { wg::mma_bf16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) { wg::mma_bf16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma(int32_t (&d)[16], uint64_t a, uint64_t b) { wg::mma_s8_ss(d, a, b, 1); }
__device__ __forceinline__ void mma(int32_t (&d)[32], uint64_t a, uint64_t b) { wg::mma_s8_ss(d, a, b, 1); }
__device__ __forceinline__ void mma(int32_t (&d)[64], uint64_t a, uint64_t b) { wg::mma_s8_ss(d, a, b, 1); }

// Weight rows map(0 .. rows-1) of W (C columns) into the weight buffer: C/64
// chunk tiles, `chunk` bytes apart, swizzled K-major. w8a16 widens the codes
// to bf16 with plain stores, eight 16-code loads in flight a thread; w8a8
// copies them by cp.async in one commit group. The caller makes them
// visible to wgmma (group wait, proxy fence, barrier).
template <int MODE>
__device__ __forceinline__ void load_w(uint8_t* wbuf, uint32_t chunk, const int8_t* __restrict__ W,
                                       int C, RowMap map, int rows) {
  const int kc = C / 64, pieces = rows * kc * 4;  // 16 codes: row n, chunk t, piece c
  const auto src = [&](int i) {
    return W + static_cast<int64_t>(map(i / (kc * 4))) * C + 64 * ((i / 4) % kc) + 16 * (i % 4);
  };
  if constexpr (MODE == 2) {
    for (int i = threadIdx.x; i < pieces; i += kBThreads)
      wg::cp_async16(wg::smem_u32(wbuf + (i / 4) % kc * chunk + wg::swz<64>(i / (kc * 4), i % 4)),
                     src(i), 16);
    wg::cp_async_commit();
  } else {
    constexpr int kU = 8;
    for (int i0 = threadIdx.x; i0 < pieces; i0 += kU * kBThreads) {
      int4 raw[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (i0 + u * kBThreads < pieces) raw[u] = *reinterpret_cast<const int4*>(src(i0 + u * kBThreads));
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kBThreads;
        if (i >= pieces) break;
        const int n = i / (kc * 4), t = (i / 4) % kc, c = i % 4;
        const int8_t* v = reinterpret_cast<const int8_t*>(&raw[u]);
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = wg::pack_bf16(static_cast<float>(v[2 * e]), static_cast<float>(v[2 * e + 1]));
        *reinterpret_cast<uint4*>(wbuf + t * chunk + wg::swz<128>(n, 2 * c)) =
            make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(wbuf + t * chunk + wg::swz<128>(n, 2 * c + 1)) =
            make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
  }
}

// acc = x[row0 + 64·g .. + 63] @ W^T for the weight rows in the buffer, g
// this thread's warpgroup (rows >= N read as zeros): both warpgroups' rows
// stream through a two-stage ring of 64-column x chunks
template <int MODE, typename Acc, int R>
__device__ __forceinline__ void project(Acc (&acc)[R], const uint8_t* xb, int C, int row0,
                                        int N, uint32_t xs, uint32_t wbuf, uint32_t chunk) {
  constexpr int KB = chunk_bytes<MODE>();
  const int kc = C / 64, g = threadIdx.x / wg::kThreads;
  const int64_t xrow = static_cast<int64_t>(kc) * KB;  // bytes per token
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;
  wg::load_tile<KB, kBRows, kBThreads>(xs, xb, xrow, row0, N);
  wg::cp_async_commit();
  for (int t = 0; t < kc; ++t) {
    if (t + 1 < kc)
      wg::load_tile<KB, kBRows, kBThreads>(xs + ((t + 1) & 1) * kBRows * KB, xb + (t + 1) * KB,
                                           xrow, row0, N);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // chunk t (and the weights) have landed
    wg::fence_proxy_async();
    __syncthreads();
    const uint64_t da = wg::desc<KB>(xs + (t & 1) * kBRows * KB + g * 64 * KB);
    const uint64_t db = wg::desc<KB>(wbuf + t * chunk);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk) mma(acc, da + 2 * kk, db + 2 * kk);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    __syncthreads();  // the ring stage and the weights are free
  }
}

// the epilogue fma of output column n, rounded to bf16
__device__ __forceinline__ float scale_bias(float acc, const float* __restrict__ s,
                                            const float* __restrict__ bias, int n, float s_mul) {
  return fmaf(acc, s_mul * s[n], bias != nullptr ? bias[n] : 0.f);
}

template <int D, int MODE>
__device__ __forceinline__ void fused_bf16_body(
    const void* __restrict__ xv, const int8_t* __restrict__ wqkv, const float* __restrict__ sqkv,
    const float* __restrict__ bqkv, const int8_t* __restrict__ wp, const float* __restrict__ sp,
    const float* __restrict__ bp, __nv_bfloat16* __restrict__ out, int N, int H, int group,
    float scale_log2) {
  using Acc = std::conditional_t<MODE == 1, float, int32_t>;
  constexpr int RB = 2 * D;               // bytes of a row of a q, context, k or v tile
  constexpr int kTile = 64 * RB;          // one 64-row tile
  constexpr int KB = chunk_bytes<MODE>();
  constexpr uint32_t kChunkW = w_rows<D>() * KB;
  constexpr int EB = MODE == 1 ? 2 : 1;   // bytes of an x element
  const int C = H * D, kc = C / 64;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* qc = wg::align1024(smem_raw);             // tile (h, g) of warpgroup g: q, then context
  uint8_t* wbuf = qc + 2 * kBRows * C;               // kc chunks of kChunkW bytes
  uint8_t* xsp = wbuf + kc * kChunkW;                // x ring, 2 x 128 x KB
  uint8_t* own = xsp + 2 * kBRows * KB;              // this CTA's slice: k, v of keys 0-63, 64-127
  uint8_t* cons = own + 4 * kTile;                   // a peer's slice, the same layout
  uint8_t* codes = cons + 4 * kTile;                 // w8a8 context codes, (g, chunk) tiles [64][64]
  float* red = reinterpret_cast<float*>(codes + (MODE == 2 ? kBRows * C : 0));
  const uint32_t wbuf_s = wg::smem_u32(wbuf), xs_s = wg::smem_u32(xsp);
  const uint32_t own_s = wg::smem_u32(own), cons_s = wg::smem_u32(cons);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, quad = lane & 3;
  const int g = tid / wg::kThreads;                  // this thread's warpgroup
  const int b = blockIdx.y, q0 = blockIdx.x * kBRows;
  const int row_in = 16 * (warp & 3) + lane / 4;     // accumulator row (and + 8) in the 64
  const uint8_t* xb = static_cast<const uint8_t*>(xv) + static_cast<int64_t>(b) * N * C * EB;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  for (int h = 0; h < H; ++h) {
    uint8_t* qt = qc + (2 * h + g) * kTile;
    // q rows of head h (rows past N are x = 0 rows: q = bias)
    {
      const RowMap map{h * D, 0, D};
      load_w<MODE>(wbuf, kChunkW, wqkv, C, map, D);
      Acc acc[D / 2];
      project<MODE>(acc, xb, C, q0, N, xs_s, wbuf_s, kChunkW);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_in + 8 * r, col = 8 * j + 2 * quad;
          *reinterpret_cast<__nv_bfloat162*>(qt + wg::swz_elem<RB>(row, col, 2)) =
              __floats2bfloat162_rn(
                  scale_bias(static_cast<float>(acc[4 * j + 2 * r]), sqkv, bqkv, map(col), 1.f),
                  scale_bias(static_cast<float>(acc[4 * j + 2 * r + 1]), sqkv, bqkv, map(col + 1), 1.f));
        }
    }
    // the k|v weight rows of head h stay in the buffer for all key groups
    const RowMap kv_map{C + h * D, 2 * C + h * D, D};
    load_w<MODE>(wbuf, kChunkW, wqkv, C, kv_map, 2 * D);

    wg::Attn<D> st;
    wg::attn_init(st);
    const uint64_t dq = wg::desc<RB>(wg::smem_u32(qt));
    for (int s0 = 0; s0 < N; s0 += kBRows * cs) {
      // k and v of head h for this CTA's slice of the cluster's keys,
      // s0 + 128·rank .. + 127 (64 per warpgroup), into `own` (uniform
      // over the CTA)
      if (s0 + kBRows * rank < N) {
        Acc acc[D];
        project<MODE>(acc, xb, C, s0 + kBRows * rank, N, xs_s, wbuf_s, kChunkW);
#pragma unroll
        for (int j = 0; j < D / 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = row_in + 8 * r, col = 8 * j + 2 * quad;
            uint8_t* tile = own + (2 * g + (col < D ? 0 : 1)) * kTile;
            *reinterpret_cast<__nv_bfloat162*>(tile + wg::swz_elem<RB>(key, col % D, 2)) =
                __floats2bfloat162_rn(
                    scale_bias(static_cast<float>(acc[4 * j + 2 * r]), sqkv, bqkv, kv_map(col), 1.f),
                    scale_bias(static_cast<float>(acc[4 * j + 2 * r + 1]), sqkv, bqkv,
                               kv_map(col + 1), 1.f));
          }
        wg::fence_proxy_async();  // this CTA's wgmma reads its own slice in place
      }
      cluster.sync();  // every slice of this group of keys is projected

      for (int jr = 0; jr < cs && s0 + kBRows * jr < N; ++jr) {
        uint32_t kv = own_s;
        if (jr != rank) {  // copy the peer's slice over DSMEM (uniform over the CTA)
          __syncthreads();  // both warpgroups are done with the previous copy
          const uint4* src = reinterpret_cast<const uint4*>(cluster.map_shared_rank(own, jr));
          uint4* dst = reinterpret_cast<uint4*>(cons);
          for (int i = tid; i < 4 * kTile / 16; i += kBThreads) dst[i] = src[i];
          wg::fence_proxy_async();
          __syncthreads();
          kv = cons_s;
        }
        for (int p = 0; p < 2 && s0 + kBRows * jr + 64 * p < N; ++p)
          wg::attn_step<D>(st, dq, kv + 2 * p * kTile, kv + (2 * p + 1) * kTile,
                           N - (s0 + kBRows * jr + 64 * p), scale_log2);
      }
      cluster.sync();  // the peers have copied this CTA's slice
    }
    // w8a8: a CTA whose rank has no key slice (128·rank >= N) never waited
    // on the k|v weight copies; they land before the next cp.async into the
    // same weight rows (the next head's q, or Wp)
    wg::cp_async_wait<0>();

    // context of head h = o / l, rounded to bf16, over its q
    float l[2], lse[2];
    wg::attn_finish(st, l, lse);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_in + 8 * r, col = 8 * j + 2 * quad;
        *reinterpret_cast<__nv_bfloat162*>(qt + wg::swz_elem<RB>(row, col, 2)) =
            __floats2bfloat162_rn(st.o[4 * j + 2 * r] / l[r], st.o[4 * j + 2 * r + 1] / l[r]);
      }
  }
  __syncthreads();

  float o_scale = 1.f;
  if constexpr (MODE == 2) {
    // amax of the context over this warpgroup's 64 rows, then over the
    // block_q / 64 warpgroups of its requant block (unit 2·rank + g of the
    // cluster's 8)
    float mx = 0.f;
    for (int hh = 0; hh < H; ++hh) {
      const __nv_bfloat16* t = reinterpret_cast<const __nv_bfloat16*>(qc + (2 * hh + g) * kTile);
      for (int i = tid % wg::kThreads; i < 64 * D; i += wg::kThreads)
        mx = fmaxf(mx, fabsf(__bfloat162float(t[i])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (tid < kGroups)
      red[8 + tid] = fmaxf(fmaxf(red[4 * tid], red[4 * tid + 1]), fmaxf(red[4 * tid + 2], red[4 * tid + 3]));
    cluster.sync();  // every warpgroup of the block has published its amax
    float amax = 0.f;
    const int u0 = (kGroups * rank + g) / group * group;
    for (int u = u0; u < u0 + group; ++u)
      amax = fmaxf(amax, *cluster.map_shared_rank(red + 8 + u % kGroups, u / kGroups));
    cluster.sync();  // no CTA leaves while a peer reads its amax
    o_scale = amax > 0.f ? amax / 127.0f : 1.0f;
    // this warpgroup's context codes, K-major 64-column chunks of 64-byte rows
    for (int i = tid % wg::kThreads; i < 64 * C; i += wg::kThreads) {
      const int row = i / C, col = i % C;
      const float v = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
          qc + (2 * (col / D) + g) * kTile + wg::swz_elem<RB>(row, col % D, 2)));
      codes[(g * kc + col / 64) * 64 * 64 + wg::swz_elem<64>(row, col % 64, 1)] =
          static_cast<int8_t>(fminf(fmaxf(rintf(v / o_scale), -127.f), 127.f));
    }
  }

  // y = ctx @ Wp^T, scale and bias, in 64-column chunks
  for (int n0 = 0; n0 < C; n0 += 64) {
    __syncthreads();  // the weight buffer is free (and the codes are written)
    load_w<MODE>(wbuf, kChunkW, wp, C, RowMap{n0, 0, 64}, 64);
    wg::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();
    Acc acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
    wg::wgmma_fence();
    for (int t = 0; t < kc; ++t) {
      const uint64_t db = wg::desc<KB>(wbuf_s + t * kChunkW);
#pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk) {
        uint64_t da;
        if constexpr (MODE == 2) {
          da = wg::desc<64>(wg::smem_u32(codes + (g * kc + t) * 64 * 64)) + 2 * kk;
        } else {  // k16 step s covers context columns 16s .. 16s + 15, in head 16s / D
          const int s = 4 * t + kk;
          da = wg::desc<RB>(wg::smem_u32(qc + (2 * (16 * s / D) + g) * kTile))
               + 2 * ((16 * s % D) / 16);
        }
        mma(acc, da, db + 2 * kk);
      }
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 64 * g + row_in + 8 * r, n = n0 + 8 * j + 2 * quad;
        if (row < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<int64_t>(b) * N + row) * C + n) =
              __floats2bfloat162_rn(
                  scale_bias(static_cast<float>(acc[4 * j + 2 * r]), sp, bp, n, o_scale),
                  scale_bias(static_cast<float>(acc[4 * j + 2 * r + 1]), sp, bp, n + 1, o_scale));
      }
  }
}

#define FT_BF16_PARAMS                                                                        \
  const void* __restrict__ x, const int8_t* __restrict__ wqkv, const float* __restrict__ sqkv, \
      const float* __restrict__ bqkv, const int8_t* __restrict__ wp,                          \
      const float* __restrict__ sp, const float* __restrict__ bp,                             \
      __nv_bfloat16* __restrict__ out, int N, int H, int group, float scale_log2
#define FT_BF16_ARGS x, wqkv, sqkv, bqkv, wp, sp, bp, out, N, H, group, scale_log2

template <int D>
__global__ void __launch_bounds__(kBThreads, 1) fused_trunk_w8a16_bf16(FT_BF16_PARAMS) {
  fused_bf16_body<D, 1>(FT_BF16_ARGS);
}

template <int D>
__global__ void __launch_bounds__(kBThreads, 1) fused_trunk_w8a8_bf16(FT_BF16_PARAMS) {
  fused_bf16_body<D, 2>(FT_BF16_ARGS);
}

template <int D, int MODE>
auto bf16_kernel() {
  auto kernel = &fused_trunk_w8a8_bf16<D>;
  if constexpr (MODE == 1) kernel = &fused_trunk_w8a16_bf16<D>;
  return kernel;
}

// the launch of a bfloat16 kernel: a CTA per 128 query rows (two
// warpgroups) of a batch row, clusters of 4 (512 rows)
template <int D, int MODE>
cudaError_t config_bf16(int B, int H, int rows, lq::Launch* l) {
  const size_t smem = bf16_smem_bytes<D, MODE>(H * D);
  if (smem > 232448) return cudaErrorInvalidValue;  // the most a block may use
  *l = {rows / kBRows, B, 1, kBThreads, smem, kBCluster};
  return cudaSuccess;
}

template <int D, int MODE>
cudaError_t launch_bf16(const void* x, const void* wqkv, const void* sqkv, const void* bqkv,
                        const void* wp, const void* sp, const void* bp, void* out,
                        int B, int N, int H, int rows, int group, float scale,
                        cudaStream_t stream) {
  // cp.async and the widening loads move 16-byte pieces of rows
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wqkv)
       | reinterpret_cast<uintptr_t>(wp)) & 15)
    return cudaErrorInvalidValue;
  auto kernel = bf16_kernel<D, MODE>();
  lq::Launch l;
  cudaError_t err = config_bf16<D, MODE>(B, H, rows, &l);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.gx, l.gy);
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, static_cast<const int8_t*>(wqkv),
                           static_cast<const float*>(sqkv), static_cast<const float*>(bqkv),
                           static_cast<const int8_t*>(wp), static_cast<const float*>(sp),
                           static_cast<const float*>(bp), static_cast<__nv_bfloat16*>(out),
                           N, H, group, scale * wg::kLog2e);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the entry point's argument checks: C a multiple of 64, rows covering N in
// whole clusters of 512 rows, a w8a8 group dividing a cluster
bool valid_args(int B, int N, int H, int D, int rows, int group, int mode) {
  if (B < 1 || N < 1 || H < 1 || (H * D) % 64 != 0 || rows < N
      || rows % (kCluster * kBlockQ) != 0)
    return false;
  return !(mode == 2 && (group < 1 || kCluster % group != 0));
}

// the launch and the kernel one fused_trunk call makes (the queries' dispatch)
cudaError_t plan(int B, int N, int H, int D, int rows, int group, int dtype, int mode,
                 lq::Launch* l, const void** fn) {
  if (!valid_args(B, N, H, D, rows, group, mode)) return cudaErrorInvalidValue;
#define FT_PLAN(T, XT, DD, MODE)                                                  \
  if (dtype == 0 && D == DD && mode == MODE) {                                   \
    *l = config<DD>(B, H, rows);                                                 \
    *fn = reinterpret_cast<const void*>(fused_trunk_kernel<T, XT, DD, MODE>);   \
    return cudaSuccess;                                                          \
  }                                                                              \
  if (dtype == 1 && D == DD && mode == MODE) {                                   \
    *fn = reinterpret_cast<const void*>(bf16_kernel<DD, MODE>());               \
    return config_bf16<DD, MODE>(B, H, rows, l);                                 \
  }
  FT_PLAN(float, float, 64, 1)
  FT_PLAN(float, float, 32, 1)
  FT_PLAN(float, int8_t, 64, 2)
  FT_PLAN(float, int8_t, 32, 2)
#undef FT_PLAN
  return cudaErrorInvalidValue;
}

}  // namespace

// The launch a fused_trunk call with these shapes makes (launch_query.cuh's
// layout in out[0..5]), and its kernel's attributes at that launch.
extern "C" int fused_trunk_launch_config(int B, int N, int H, int D, int rows, int group,
                                         int dtype, int mode, long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(B, N, H, D, rows, group, dtype, mode, &l, &fn);
  if (err == cudaSuccess) lq::put(l, out);
  return static_cast<int>(err);
}

extern "C" int fused_trunk_attributes(int B, int N, int H, int D, int rows, int group,
                                      int dtype, int mode, long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(B, N, H, D, rows, group, dtype, mode, &l, &fn);
  return static_cast<int>(err == cudaSuccess ? lq::attributes(fn, l, out) : err);
}

// x (B, N, C) contiguous: T for mode 1 (w8a16), int8 codes for mode 2
// (w8a8); wqkv (3C, C) and wp (C, C) int8 contiguous; sqkv (3C,) f32 (mode
// 2: times the activation scale), bqkv (3C,) f32 or null; sp (C,) f32; bp
// (C,) f32 or null; out (B, N, C) T. C = H * D with D in {32, 64} and C a
// multiple of 64. `rows` is the number of query rows the grid covers: N
// rounded up to 512, the rows of one cluster of 8 CTAs. `group` = block_q /
// 64, the 64-row units of one w8a8 requant block (1, 2, 4 or 8; mode 2
// only). dtype: 0 float32 (CUDA-core FMAs), 1 bfloat16 (wgmma; x, wqkv and
// wp 16-byte aligned; C up to 256 at D = 64, 320 in w8a8, 384 at D = 32,
// for the shared memory). Returns the launch's cudaError_t; runs
// asynchronously on `stream` and allocates nothing.
extern "C" int fused_trunk(const void* x, const void* wqkv, const void* sqkv,
                           const void* bqkv, const void* wp, const void* sp,
                           const void* bp, void* out, int B, int N, int H, int D,
                           int rows, int group, int dtype, int mode, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_args(B, N, H, D, rows, group, mode)) return static_cast<int>(cudaErrorInvalidValue);
#define FT_ARGS x, wqkv, sqkv, bqkv, wp, sp, bp, out, B, N, H, rows, group, scale, st
  if (mode == 1 && dtype == 0 && D == 64) return launch<float, float, 64, 1>(FT_ARGS);
  if (mode == 1 && dtype == 0 && D == 32) return launch<float, float, 32, 1>(FT_ARGS);
  if (mode == 1 && dtype == 1 && D == 64) return launch_bf16<64, 1>(FT_ARGS);
  if (mode == 1 && dtype == 1 && D == 32) return launch_bf16<32, 1>(FT_ARGS);
  if (mode == 2 && dtype == 0 && D == 64) return launch<float, int8_t, 64, 2>(FT_ARGS);
  if (mode == 2 && dtype == 0 && D == 32) return launch<float, int8_t, 32, 2>(FT_ARGS);
  if (mode == 2 && dtype == 1 && D == 64) return launch_bf16<64, 2>(FT_ARGS);
  if (mode == 2 && dtype == 1 && D == 32) return launch_bf16<32, 2>(FT_ARGS);
#undef FT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
