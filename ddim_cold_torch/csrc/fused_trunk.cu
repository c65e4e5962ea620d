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
// layer. One CTA of 128 threads (4 warps of 16 query rows) owns 64 query
// rows of one batch element; 8 CTAs (512 consecutive rows) form a
// thread-block cluster. For each head a CTA projects its q rows, then walks
// the keys in groups of 8 x 64: each CTA of the cluster projects one 64-key
// slice of k and v for that head from x (x tiles and int8 weight tiles
// staged through shared memory, weights read from L2) into its own shared
// memory; after a cluster barrier every CTA copies the 8 slices in turn
// over DSMEM and folds each into the running softmax as flash_fwd.cu does;
// a second barrier frees the slices. The context of all heads stays in
// shared memory (ctxT[c][row]); at the end the CTA applies the proj GEMM and
// writes y. The price of never writing k and v is recomputation: each
// cluster re-projects all N keys and values, 2*N*C*2C FLOP per cluster,
// 5 x 8 clusters x 0.66 GFLOP = 26 GFLOP per launch at the serve shape
// (64-row tiles without the cluster would make it 210 GFLOP; the TPU's
// 512-row q blocks make it 10). Larger q tiles do not fit: the context
// alone is 64 rows x C floats. All products are f32 FMAs on the CUDA cores;
// tensor cores are the next step.
//
// w8a8 requantization: block_q (512 at N = 2501) spans several CTAs. The
// CTAs of one block (block_q / 64 of them, inside one cluster) exchange
// their context amaxes over DSMEM, so w8a8 too is one launch. int8 x int8
// products summed in f32 are exact for C <= 1040.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

template <typename T, typename XT, int D, int MODE>
cudaError_t launch(const void* x, const void* wqkv, const void* sqkv, const void* bqkv,
                   const void* wp, const void* sp, const void* bp, void* out,
                   int B, int N, int H, int rows, int group, float scale,
                   cudaStream_t stream) {
  auto kernel = fused_trunk_kernel<T, XT, D, MODE>;
  const size_t smem = sizeof(float) * smem_floats<D>(H * D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows / kBlockQ, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
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

}  // namespace

// x (B, N, C) contiguous: T for mode 1 (w8a16), int8 codes for mode 2
// (w8a8); wqkv (3C, C) and wp (C, C) int8 contiguous; sqkv (3C,) f32 (mode
// 2: times the activation scale), bqkv (3C,) f32 or null; sp (C,) f32; bp
// (C,) f32 or null; out (B, N, C) T. C = H * D with D in {32, 64} and C a
// multiple of 64. `rows` is the number of query rows the grid covers: N
// rounded up to 512, the rows of one cluster of 8 CTAs. `group` = block_q /
// 64, the CTAs of one w8a8 requant block (1, 2, 4 or 8; mode 2 only).
// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t; runs
// asynchronously on `stream` and allocates nothing.
extern "C" int fused_trunk(const void* x, const void* wqkv, const void* sqkv,
                           const void* bqkv, const void* wp, const void* sp,
                           const void* bp, void* out, int B, int N, int H, int D,
                           int rows, int group, int dtype, int mode, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1 || (H * D) % 64 != 0 || rows < N
      || rows % (kCluster * kBlockQ) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 2 && (group < 1 || kCluster % group != 0))
    return static_cast<int>(cudaErrorInvalidValue);
#define FT_ARGS x, wqkv, sqkv, bqkv, wp, sp, bp, out, B, N, H, rows, group, scale, st
  if (mode == 1 && dtype == 0 && D == 64) return launch<float, float, 64, 1>(FT_ARGS);
  if (mode == 1 && dtype == 0 && D == 32) return launch<float, float, 32, 1>(FT_ARGS);
  if (mode == 1 && dtype == 1 && D == 64) return launch<__nv_bfloat16, __nv_bfloat16, 64, 1>(FT_ARGS);
  if (mode == 1 && dtype == 1 && D == 32) return launch<__nv_bfloat16, __nv_bfloat16, 32, 1>(FT_ARGS);
  if (mode == 2 && dtype == 0 && D == 64) return launch<float, int8_t, 64, 2>(FT_ARGS);
  if (mode == 2 && dtype == 0 && D == 32) return launch<float, int8_t, 32, 2>(FT_ARGS);
  if (mode == 2 && dtype == 1 && D == 64) return launch<__nv_bfloat16, int8_t, 64, 2>(FT_ARGS);
  if (mode == 2 && dtype == 1 && D == 32) return launch<__nv_bfloat16, int8_t, 32, 2>(FT_ARGS);
#undef FT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
