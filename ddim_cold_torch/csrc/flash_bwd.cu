// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: ddim_cold_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the two Pallas TPU kernels reached from _flash_backward's
// pallas_calls). Same functions: with P rebuilt from the forward's saved
// log-sum-exp, P_ij = exp(q_i·k_j·scale − lse_i), dP_ij = dO_i·v_j and
// dS_ij = P_ij·(dP_ij − δ_i), δ_i = rowsum(O_i∘dO_i) (computed by the caller),
//   flash_bwd_dq:  dq_i = scale · Σ_j dS_ij·k_j
//   flash_bwd_dkv: dv_j = Σ_i P_ij·dO_i,  dk_j = scale · Σ_i dS_ij·q_i
// P and dS are zero wherever the query row or the key column lies past N:
// a padded row's lse would otherwise poison valid key columns through the
// column sums of dk/dv, so the row mask is correctness, not hygiene.
// Rounding follows the TPU kernels: dS is rounded to k's (dq) or q's (dk)
// dtype and P to dO's dtype before the products that consume them; the
// products accumulate in f32 and the result is rounded once to the input
// dtype. `scale` multiplies the f32 sum once at the end (the TPU kernel
// multiplies each chunk's f32 product; the two differ only in f32 rounding).
//
// What bounds it on this card: at the 200px/p4 geometry (N=2501, D=64) dq
// does 6·B·H·N²·D FLOP (Q·Kᵀ, dO·Vᵀ, dS·K) and dk/dv 8·B·H·N²·D (Q·Kᵀ,
// dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) against ~5·B·N·H·D·2 bytes of q/k/v/dO/grad traffic:
// about 1,900 and 2,500 FLOP per byte, far above the H100's ridge (~295 bf16,
// ~20 f32 CUDA-core FLOP per byte), so both are bound by arithmetic.
//
// What the design does about it: the N×N matrices P, dP and dS never leave
// the SM. The dq kernel gives each CTA 64 query rows of one (batch, head) and
// walks every K/V tile; the dk/dv kernel gives each CTA 64 keys and walks
// every Q/dO tile. Neither needs a reduction across CTAs (no atomics), at the
// price of computing Q·Kᵀ and dO·Vᵀ twice, once in each kernel. Like the
// forward kernel (flash_fwd.cu), this first version does every product with
// f32 FMAs on the CUDA cores: inputs are widened to f32 as they are staged
// (a bf16·bf16 product is exact in f32), so its ceiling is the 67 TFLOP/s
// f32 CUDA-core rate, not the 989 TFLOP/s of the bf16 tensor cores; moving
// the products onto mma.sync/wgmma is the next step.
//
// Layout: q, k, v and dO are read through their (batch, token, head) strides
// (the innermost, head-dim stride must be 1), so the (B, N, 3, H, D) qkv
// projection is consumed in place; dq, dk and dv are written through their
// strides too, which lets the caller hand in the three slices of one
// (B, N, 3, H, D) gradient buffer. lse and δ are (B·H, N) f32.
//
// Thread mapping (both kernels): 4 warps per CTA, 16 owned rows per warp. In
// the score products a lane owns streamed rows lane and lane+32 of a 64-row
// tile; in the accumulating products it owns head-dim columns lane (+32 when
// D=64). Owned rows are read as broadcast float4s from shared memory; the
// streamed tile is stored with rows padded to D+1 words, so both the
// per-lane row reads (stride D+1) and the per-lane column reads are free of
// bank conflicts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kBlock = kWarps * kRowsPerWarp;  // owned rows per CTA
constexpr int kTile = 64;                      // streamed rows per shared-memory tile
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back to f32 for the FMA (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float dot4(float4 a, const float* b, float acc) {
  acc = fmaf(a.x, b[0], acc);
  acc = fmaf(a.y, b[1], acc);
  acc = fmaf(a.z, b[2], acc);
  return fmaf(a.w, b[3], acc);
}

// Shared memory of either kernel: two owned-row tiles (row-major), two
// streamed tiles (rows padded to D+1), the streamed rows' lse and δ, and
// `slabs` 16×64 per-warp slabs.
template <int D>
constexpr size_t smem_bytes(int slabs) {
  return sizeof(float) * (2 * kBlock * D + 2 * kTile * (D + 1) + 2 * kTile
                          + slabs * kBlock * kTile);
}

// Stage rows [r0, r0 + kRows) of a (token, head-dim) matrix into shared memory
// as f32 with row pitch `pitch`, zero past N.
template <typename T, int D, int kRows>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      int64_t row_stride, int r0, int N) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * pitch + d] = row < N ? to_f32(src[row * row_stride + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int N, int H, float scale,
                    int64_t sqb, int64_t sqn, int64_t sqh,
                    int64_t skb, int64_t skn, int64_t skh,
                    int64_t svb, int64_t svn, int64_t svh,
                    int64_t sdb, int64_t sdn, int64_t sdh,
                    int64_t sgb, int64_t sgn, int64_t sgh) {
  static_assert(D == 32 || D == 64, "head dim must be 32 or 64");
  constexpr int kDPL = D / 32;  // head-dim columns per lane in dS·K
  constexpr int P = D + 1;      // padded pitch of the streamed K/V tiles

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kBlock][D]   owned query rows
  float* gs = qs + kBlock * D;       // [kBlock][D]   their dO rows
  float* ks = gs + kBlock * D;       // [kTile][D+1]  streamed keys
  float* vs = ks + kTile * P;        // [kTile][D+1]  streamed values
  float* ls = vs + kTile * P;        // [kBlock]      lse of the owned rows
  float* dl = ls + kTile;            // [kBlock]      δ of the owned rows
  float* ds_slab = dl + kTile;       // [kBlock][kTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlock;

  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  stage<T, D, kBlock>(qs, D, q + b * sqb + h * sqh, sqn, q0, N);
  stage<T, D, kBlock>(gs, D, dout + b * sdb + h * sdh, sdn, q0, N);
  for (int i = tid; i < kBlock; i += kThreads) {
    const int row = q0 + i;
    ls[i] = row < N ? lse[static_cast<int64_t>(bh) * N + row] : 0.f;
    dl[i] = row < N ? delta[static_cast<int64_t>(bh) * N + row] : 0.f;
  }

  float acc[kRowsPerWarp][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kDPL; ++c) acc[r][c] = 0.f;

  const int w0 = warp * kRowsPerWarp;
  const float* qw = qs + w0 * D;
  const float* gw = gs + w0 * D;
  float* dsw = ds_slab + w0 * kTile;

  for (int j0 = 0; j0 < N; j0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and Q/dO staged, first time)
    stage<T, D, kTile>(ks, P, kb, skn, j0, N);
    stage<T, D, kTile>(vs, P, vb, svn, j0, N);
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ for 16 rows × key columns (lane, lane+32)
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float k0[4], k1[4], v0[4], v1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k0[e] = ks[lane * P + d + e];
        k1[e] = ks[(lane + 32) * P + d + e];
        v0[e] = vs[lane * P + d + e];
        v1[e] = vs[(lane + 32) * P + d + e];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * D + d);
        const float4 gv = *reinterpret_cast<const float4*>(gw + r * D + d);
        s[r][0] = dot4(qv, k0, s[r][0]);
        s[r][1] = dot4(qv, k1, s[r][1]);
        dp[r][0] = dot4(gv, v0, dp[r][0]);
        dp[r][1] = dot4(gv, v1, dp[r][1]);
      }
    }

    // P from the saved lse, dS = P∘(dP − δ), dS rounded to k's dtype
    const bool ok0 = j0 + lane < N;
    const bool ok1 = j0 + lane + 32 < N;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool row_ok = q0 + w0 + r < N;
      const float L = ls[w0 + r], dlt = dl[w0 + r];
      const float p0 = (row_ok && ok0) ? expf(s[r][0] * scale - L) : 0.f;
      const float p1 = (row_ok && ok1) ? expf(s[r][1] * scale - L) : 0.f;
      dsw[r * kTile + lane] = round_to<T>(p0 * (dp[r][0] - dlt));
      dsw[r * kTile + lane + 32] = round_to<T>(p1 * (dp[r][1] - dlt));
    }
    __syncwarp();

    // acc += dS·K over the tile's 64 keys
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float kk[4][kDPL];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kDPL; ++c) kk[e][c] = ks[(j + e) * P + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 dv = *reinterpret_cast<const float4*>(dsw + r * kTile + j);
#pragma unroll
        for (int c = 0; c < kDPL; ++c) {
          acc[r][c] = fmaf(dv.x, kk[0][c], acc[r][c]);
          acc[r][c] = fmaf(dv.y, kk[1][c], acc[r][c]);
          acc[r][c] = fmaf(dv.z, kk[2][c], acc[r][c]);
          acc[r][c] = fmaf(dv.w, kk[3][c], acc[r][c]);
        }
      }
    }
  }

  // emit dq = scale·acc in the input dtype
  T* gb = dq + b * sgb + h * sgh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + w0 + r;
    if (row < N) {
#pragma unroll
      for (int c = 0; c < kDPL; ++c)
        gb[row * sgn + lane + 32 * c] = from_f32<T>(acc[r][c] * scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int N, int H, float scale,
                     int64_t sqb, int64_t sqn, int64_t sqh,
                     int64_t skb, int64_t skn, int64_t skh,
                     int64_t svb, int64_t svn, int64_t svh,
                     int64_t sdb, int64_t sdn, int64_t sdh,
                     int64_t sgb, int64_t sgn, int64_t sgh) {
  static_assert(D == 32 || D == 64, "head dim must be 32 or 64");
  constexpr int kDPL = D / 32;  // head-dim columns per lane in Pᵀ·dO and dSᵀ·Q
  constexpr int P = D + 1;      // padded pitch of the streamed Q/dO tiles

  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [kBlock][D]   owned keys
  float* vs = ks + kBlock * D;       // [kBlock][D]   their values
  float* qs = vs + kBlock * D;       // [kTile][D+1]  streamed queries
  float* gs = qs + kTile * P;        // [kTile][D+1]  their dO rows
  float* ls = gs + kTile * P;        // [kTile]       their lse
  float* dl = ls + kTile;            // [kTile]       their δ
  float* p_slab = dl + kTile;        // [kBlock][kTile]
  float* ds_slab = p_slab + kBlock * kTile;  // [kBlock][kTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * kBlock;

  const T* qb = q + b * sqb + h * sqh;
  const T* gb = dout + b * sdb + h * sdh;
  const float* lb = lse + static_cast<int64_t>(bh) * N;
  const float* db = delta + static_cast<int64_t>(bh) * N;

  stage<T, D, kBlock>(ks, D, k + b * skb + h * skh, skn, k0, N);
  stage<T, D, kBlock>(vs, D, v + b * svb + h * svh, svn, k0, N);

  float acc_dk[kRowsPerWarp][kDPL], acc_dv[kRowsPerWarp][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kDPL; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  const int w0 = warp * kRowsPerWarp;
  const float* kw = ks + w0 * D;
  const float* vw = vs + w0 * D;
  float* pw = p_slab + w0 * kTile;
  float* dsw = ds_slab + w0 * kTile;

  for (int i0 = 0; i0 < N; i0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and K/V staged, first time)
    stage<T, D, kTile>(qs, P, qb, sqn, i0, N);
    stage<T, D, kTile>(gs, P, gb, sdn, i0, N);
    for (int i = tid; i < kTile; i += kThreads) {
      const int row = i0 + i;
      ls[i] = row < N ? lb[row] : 0.f;
      dl[i] = row < N ? db[row] : 0.f;
    }
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for 16 keys × query columns (lane, lane+32)
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float q0[4], q1[4], g0[4], g1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q0[e] = qs[lane * P + d + e];
        q1[e] = qs[(lane + 32) * P + d + e];
        g0[e] = gs[lane * P + d + e];
        g1[e] = gs[(lane + 32) * P + d + e];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 kv = *reinterpret_cast<const float4*>(kw + r * D + d);
        const float4 vv = *reinterpret_cast<const float4*>(vw + r * D + d);
        s[r][0] = dot4(kv, q0, s[r][0]);
        s[r][1] = dot4(kv, q1, s[r][1]);
        dp[r][0] = dot4(vv, g0, dp[r][0]);
        dp[r][1] = dot4(vv, g1, dp[r][1]);
      }
    }

    // P from the query rows' lse, dS = P∘(dP − δ); P rounded to dO's dtype
    // and dS to q's dtype for the products below
    const bool ok0 = i0 + lane < N;
    const bool ok1 = i0 + lane + 32 < N;
    const float L0 = ls[lane], L1 = ls[lane + 32];
    const float D0 = dl[lane], D1 = dl[lane + 32];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool key_ok = k0 + w0 + r < N;
      const float p0 = (key_ok && ok0) ? expf(s[r][0] * scale - L0) : 0.f;
      const float p1 = (key_ok && ok1) ? expf(s[r][1] * scale - L1) : 0.f;
      pw[r * kTile + lane] = round_to<T>(p0);
      pw[r * kTile + lane + 32] = round_to<T>(p1);
      dsw[r * kTile + lane] = round_to<T>(p0 * (dp[r][0] - D0));
      dsw[r * kTile + lane + 32] = round_to<T>(p1 * (dp[r][1] - D1));
    }
    __syncwarp();

    // dv += Pᵀ·dO and dk += dSᵀ·Q over the tile's 64 queries
#pragma unroll 2
    for (int i = 0; i < kTile; i += 4) {
      float gg[4][kDPL], qq[4][kDPL];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kDPL; ++c) {
          gg[e][c] = gs[(i + e) * P + lane + 32 * c];
          qq[e][c] = qs[(i + e) * P + lane + 32 * c];
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + r * kTile + i);
        const float4 sv = *reinterpret_cast<const float4*>(dsw + r * kTile + i);
#pragma unroll
        for (int c = 0; c < kDPL; ++c) {
          acc_dv[r][c] = fmaf(pv.x, gg[0][c], acc_dv[r][c]);
          acc_dv[r][c] = fmaf(pv.y, gg[1][c], acc_dv[r][c]);
          acc_dv[r][c] = fmaf(pv.z, gg[2][c], acc_dv[r][c]);
          acc_dv[r][c] = fmaf(pv.w, gg[3][c], acc_dv[r][c]);
          acc_dk[r][c] = fmaf(sv.x, qq[0][c], acc_dk[r][c]);
          acc_dk[r][c] = fmaf(sv.y, qq[1][c], acc_dk[r][c]);
          acc_dk[r][c] = fmaf(sv.z, qq[2][c], acc_dk[r][c]);
          acc_dk[r][c] = fmaf(sv.w, qq[3][c], acc_dk[r][c]);
        }
      }
    }
  }

  // emit dk = scale·acc_dk and dv = acc_dv in the input dtype (dk and dv
  // share the gradient buffer's strides)
  T* dkb = dk + b * sgb + h * sgh;
  T* dvb = dv + b * sgb + h * sgh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = k0 + w0 + r;
    if (row < N) {
#pragma unroll
      for (int c = 0; c < kDPL; ++c) {
        dkb[row * sgn + lane + 32 * c] = from_f32<T>(acc_dk[r][c] * scale);
        dvb[row * sgn + lane + 32 * c] = from_f32<T>(acc_dv[r][c]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int N,
                      int H, float scale, const int64_t* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>(1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlock - 1) / kBlock, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), N, H, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B,
                       int N, int H, float scale, const int64_t* st,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>(2);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlock - 1) / kBlock, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      N, H, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch, token,
// head) for q, k, v, dO and the gradient output(s) in that order. lse and δ
// are (B·H, N) f32, contiguous. Each returns the launch's cudaError_t (0 on
// success); the kernels run asynchronously on `stream` and allocate nothing.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            void* dq, int B, int N, int H, int D, int dtype,
                            long long sqb, long long sqn, long long sqh,
                            long long skb, long long skn, long long skh,
                            long long svb, long long svn, long long svh,
                            long long sdb, long long sdn, long long sdh,
                            long long sgb, long long sgn, long long sgh,
                            float scale, void* stream) {
  const int64_t st[15] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh,
                          sdb, sdn, sdh, sgb, sgn, sgh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, N, H, scale, st, s);
  if (dtype == 0 && D == 32) return launch_dq<float, 32>(q, k, v, dout, lse, delta, dq, B, N, H, scale, st, s);
  if (dtype == 1 && D == 64) return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, B, N, H, scale, st, s);
  if (dtype == 1 && D == 32) return launch_dq<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dq, B, N, H, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk and dv are two slices of one gradient buffer and share its strides.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, int B, int N, int H, int D, int dtype,
                             long long sqb, long long sqn, long long sqh,
                             long long skb, long long skn, long long skh,
                             long long svb, long long svn, long long svh,
                             long long sdb, long long sdn, long long sdh,
                             long long sgb, long long sgn, long long sgh,
                             float scale, void* stream) {
  const int64_t st[15] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh,
                          sdb, sdn, sdh, sgb, sgn, sgh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64) return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, N, H, scale, st, s);
  if (dtype == 0 && D == 32) return launch_dkv<float, 32>(q, k, v, dout, lse, delta, dk, dv, B, N, H, scale, st, s);
  if (dtype == 1 && D == 64) return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B, N, H, scale, st, s);
  if (dtype == 1 && D == 32) return launch_dkv<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dk, dv, B, N, H, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
