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
// Rounding follows the TPU kernels: dS is computed from the unrounded f32 P
// and rounded to k's (dq) or q's (dk) dtype, and P to dO's dtype, before the
// products that consume them; the products accumulate in f32 and the result
// is rounded once to the input dtype. `scale` multiplies the f32 sum once at
// the end (the TPU kernel multiplies each chunk's f32 product; the two
// differ only in f32 rounding).
//
// What bounds it on this card: at the 200px/p4 geometry (N=2501, D=64) dq
// does 6·B·H·N²·D FLOP (Q·Kᵀ, dO·Vᵀ, dS·K) and dk/dv 8·B·H·N²·D (Q·Kᵀ,
// dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) against ~5·B·N·H·D·2 bytes of q/k/v/dO/grad traffic:
// about 1,900 and 2,500 FLOP per byte, far above the H100's ridge (~295 bf16,
// ~20 f32 CUDA-core FLOP per byte), so both are bound by arithmetic: the
// tensor cores' in bf16, and next to them the exp and the elementwise dS of
// every (query, key) pair on the CUDA cores.
//
// What the design does about it: the N×N matrices P, dP and dS never leave
// the SM. The dq kernel gives each CTA 64 query rows of one (batch, head) and
// walks every K/V tile; the dk/dv kernel gives each CTA 64 keys and walks
// every Q/dO tile. Neither needs a reduction across CTAs (no atomics, and
// gradients that are the same from run to run), at the price of computing
// Q·Kᵀ and dO·Vᵀ twice, once in each kernel (7 products where one kernel
// with atomics for dq would do 5). There are two instantiations of each,
// chosen by dtype only:
//
// * bfloat16 (flash_bwd_dq_bf16_wgmma, flash_bwd_dkv_bf16_wgmma, the trained
//   route): every product on the tensor cores through wgmma, one warpgroup
//   of 64 owned rows per CTA, built from attn_wgmma.cuh as the forward is.
//   The owned tiles (Q and dO for dq; K and V for dk/dv) are loaded once;
//   the streamed tiles of 64 rows arrive by cp.async into a two-stage ring
//   of 128B- (D=64) or 64B-swizzled (D=32) shared tiles, the next tile's copy
//   in flight while the current one is consumed (dk/dv also streams the 64
//   query rows' lse and δ, 4-byte copies, since a row of the (B·H, N) f32
//   vectors need not be 16-byte aligned). dq: S = Q·Kᵀ and dP = dO·Vᵀ
//   (m64n64k16, both operands K-major over D as they lie), P and dS on the
//   accumulator fragment, dS packed to bf16 in registers as the A operand of
//   dq += dS·K (m64nDk16, K read MN-major through the transpose bit, as the
//   forward reads V). dk/dv computes the transposed products directly, so
//   nothing is transposed in shared memory: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, the
//   fragment's columns are query rows (their lse and δ read from the
//   stage's shared vectors), then dv += Pᵀ·dO and dk += dSᵀ·Q with Pᵀ and
//   dSᵀ as register A operands and dO and Q read MN-major. The wrapper
//   refuses rows that cannot be copied in 16-byte pieces.
// * float32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel, the exact oracle
//   route): f32 FMAs on the CUDA cores, inputs staged through shared memory,
//   P and dS through per-warp slabs. The tensor cores would give TF32 here,
//   which breaks the f32 limits.
//
// What version 1 of the bf16 kernels leaves on the table: a producer warp
// (the consuming warpgroup issues its own copies, and waits on each tile
// with all its warps); two warpgroups sharing each streamed tile (half the
// L2 traffic per owned row); overlap of one tile's exp and dS with the
// other's products inside a CTA (today only the 3 or 4 CTAs an SM overlap one
// another); and the duplicated Q·Kᵀ and dO·Vᵀ.
//
// Layout: q, k, v and dO are read through their (batch, token, head) strides
// (the innermost, head-dim stride must be 1), so the (B, N, 3, H, D) qkv
// projection is consumed in place; dq, dk and dv are written through their
// strides too, which lets the caller hand in the three slices of one
// (B, N, 3, H, D) gradient buffer. lse and δ are (B·H, N) f32.
//
// f32 thread mapping (both kernels): 4 warps per CTA, 16 owned rows per
// warp. In the score products a lane owns streamed rows lane and lane+32 of
// a 64-row tile; in the accumulating products it owns head-dim columns lane
// (+32 when D=64). Owned rows are read as broadcast float4s from shared
// memory; the streamed tile is stored with rows padded to D+1 words, so both
// the per-lane row reads (stride D+1) and the per-lane column reads are free
// of bank conflicts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

#include "attn_wgmma.cuh"
#include "launch_query.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kBlock = kWarps * kRowsPerWarp;  // owned rows per CTA
constexpr int kTile = 64;                      // streamed rows per shared-memory tile
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// the launch of a float32 kernel: a CTA per 64 owned rows of a (batch, head);
// `slabs` is 1 for dq, 2 for dk/dv
template <int D>
lq::Launch config(int B, int N, int H, int slabs) {
  return {(N + kBlock - 1) / kBlock, B * H, 1, kThreads, smem_bytes<D>(slabs), 1};
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int N,
                      int H, float scale, const int64_t* st, cudaStream_t stream) {
  const lq::Launch l = config<D>(B, N, H, 1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3(l.gx, l.gy), l.threads, l.smem, stream>>>(
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
  const lq::Launch l = config<D>(B, N, H, 2);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D><<<dim3(l.gx, l.gy), l.threads, l.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      N, H, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

// dq: the Q and dO tiles, then two stages of (K, V): six 64-row tiles, plus
// the alignment slack
template <int D>
constexpr size_t dq_bf16_smem_bytes() { return 1024 + 6 * 64 * 2 * D; }
// dk/dv: the K and V tiles, two stages of (Q, dO), then two stages of the
// streamed rows' (lse, δ), 64 floats each
template <int D>
constexpr size_t dkv_bf16_smem_bytes() { return 1024 + 6 * 64 * 2 * D + 2 * 2 * 64 * 4; }

__device__ __forceinline__ const uint8_t* bytes_of(const bf16* p) {
  return reinterpret_cast<const uint8_t*>(p);
}

// rows r and r + 8 of an m64nD accumulator fragment, times `mul`, in bf16 to
// rows row0 + frag_row(0) and + 8 of `out` (token stride `sn`), those < N
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, int64_t sn, const float (&acc)[D / 2],
                                           float mul, int row0, int N) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wg::frag_row(2 * r);
    if (row >= N) continue;
    bf16* orow = out + row * sn + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 3)
flash_bwd_dq_bf16_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int N, int H, float scale,
                        int64_t sqb, int64_t sqn, int64_t sqh,
                        int64_t skb, int64_t skn, int64_t skh,
                        int64_t svb, int64_t svn, int64_t svh,
                        int64_t sdb, int64_t sdn, int64_t sdh,
                        int64_t sgb, int64_t sgn, int64_t sgh) {
  constexpr int RB = 2 * D;     // bytes of one row of a tile
  constexpr int kTile = 64 * RB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = wg::smem_u32(wg::align1024(smem_raw));
  const uint32_t gs = qs + kTile;  // the owned rows' dO
  // ring stage s: K at qs + (2 + 2s)·kTile, V right after it
  auto k_at = [qs](int s) { return qs + (2 + 2 * s) * kTile; };

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 64;
  const uint8_t* kb = bytes_of(k + b * skb + h * skh);
  const uint8_t* vb = bytes_of(v + b * svb + h * svh);

  // Q and dO (rows past N are zeros: masked, never stored) and the first K/V tile
  wg::load_tile<RB>(qs, bytes_of(q + b * sqb + h * sqh), 2 * sqn, q0, N);
  wg::load_tile<RB>(gs, bytes_of(dout + b * sdb + h * sdh), 2 * sdn, q0, N);
  wg::load_tile<RB>(k_at(0), kb, 2 * skn, 0, N);
  wg::load_tile<RB>(k_at(0) + kTile, vb, 2 * svn, 0, N);
  wg::cp_async_commit();

  // lse and δ of this thread's two query rows (frag_row(0) and + 8)
  const int rows = N - q0;  // owned rows that are real
  float L[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg::frag_row(2 * r);
    const int64_t at = static_cast<int64_t>(bh) * N + q0 + row;
    L[r] = row < rows ? lse[at] : 0.f;
    dl[r] = row < rows ? delta[at] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint64_t dq_desc = wg::desc<RB>(qs), dg_desc = wg::desc<RB>(gs);
  const int tiles = (N + 63) / 64;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {  // the next tile's copy runs under this tile's math
      const int nxt = (t + 1) & 1, j0 = (t + 1) * 64;
      wg::load_tile<RB>(k_at(nxt), kb, 2 * skn, j0, N);
      wg::load_tile<RB>(k_at(nxt) + kTile, vb, 2 * svn, j0, N);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // tile t (and Q, dO) have landed
    wg::fence_proxy_async();
    __syncthreads();

    const uint32_t kt = k_at(t & 1);
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg::wgmma_fence();
    wg::mma_tile_nt<D>(s, dq_desc, wg::desc<RB>(kt));          // S = Q·Kᵀ
    wg::mma_tile_nt<D>(dp, dg_desc, wg::desc<RB>(kt + kTile));  // dP = dO·Vᵀ
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // P from the rows' lse (f32, unrounded), dS = P∘(dP − δ) in place of S
    const int keys = N - t * 64;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const bool ok = wg::frag_row(i) < rows && wg::frag_col(i) < keys;
      const float p = ok ? exp2f(fmaf(s[i], scale, -L[r]) * wg::kLog2e) : 0.f;
      s[i] = p * (dp[i] - dl[r]);
    }
    uint32_t a[4][4];  // dS in bf16: the A operand of dq += dS·K
    wg::to_a_frags(s, a);
    wg::wgmma_fence();
    wg::mma_tile_rs<D>(acc, a, kt);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    __syncthreads();  // stage t & 1 is free for tile t + 2
  }

  store_rows<D>(dq + b * sgb + h * sgh, sgn, acc, scale, q0, N);
}

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 2)
flash_bwd_dkv_bf16_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H,
                         float scale,
                         int64_t sqb, int64_t sqn, int64_t sqh,
                         int64_t skb, int64_t skn, int64_t skh,
                         int64_t svb, int64_t svn, int64_t svh,
                         int64_t sdb, int64_t sdn, int64_t sdh,
                         int64_t sgb, int64_t sgn, int64_t sgh) {
  constexpr int RB = 2 * D;
  constexpr int kTile = 64 * RB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = wg::align1024(smem_raw);
  const uint32_t ks = wg::smem_u32(base);
  const uint32_t vs = ks + kTile;  // the owned keys' values
  // ring stage s: Q at ks + (2 + 2s)·kTile, dO right after it; the stage's
  // lse at vec + 512·s bytes, its δ 256 bytes further
  auto q_at = [ks](int s) { return ks + (2 + 2 * s) * kTile; };
  const uint32_t vec = ks + 6 * kTile;
  const float* vec_f = reinterpret_cast<const float*>(base + 6 * kTile);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * 64;
  const uint8_t* qb = bytes_of(q + b * sqb + h * sqh);
  const uint8_t* gb = bytes_of(dout + b * sdb + h * sdh);
  // threads 0-63 copy the streamed rows' lse, 64-127 their δ
  const int vi = threadIdx.x & 63;
  const float* vsrc = (threadIdx.x < 64 ? lse : delta) + static_cast<int64_t>(bh) * N;
  const uint32_t vdst = vec + (threadIdx.x < 64 ? 0 : 256) + 4 * vi;
  auto load_stage = [&](int s, int i0) {
    wg::load_tile<RB>(q_at(s), qb, 2 * sqn, i0, N);
    wg::load_tile<RB>(q_at(s) + kTile, gb, 2 * sdn, i0, N);
    const bool ok = i0 + vi < N;
    wg::cp_async4(vdst + 512 * s, vsrc + (ok ? i0 + vi : 0), ok ? 4 : 0);
  };

  // K and V (rows past N are zeros: masked, never stored) and the first Q/dO tile
  wg::load_tile<RB>(ks, bytes_of(k + b * skb + h * skh), 2 * skn, k0, N);
  wg::load_tile<RB>(vs, bytes_of(v + b * svb + h * svh), 2 * svn, k0, N);
  load_stage(0, 0);
  wg::cp_async_commit();

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const uint64_t dk_desc = wg::desc<RB>(ks), dv_desc = wg::desc<RB>(vs);
  const int keys = N - k0;  // owned keys that are real
  const int quad2 = 2 * (threadIdx.x & 3);
  const int tiles = (N + 63) / 64;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_stage((t + 1) & 1, (t + 1) * 64);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // tile t (and K, V) have landed
    wg::fence_proxy_async();
    __syncthreads();

    const uint32_t qt = q_at(t & 1);
    float s[32], dp[32];  // Sᵀ and dPᵀ: rows are keys, columns query rows
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg::wgmma_fence();
    wg::mma_tile_nt<D>(s, dk_desc, wg::desc<RB>(qt));          // Sᵀ = K·Qᵀ
    wg::mma_tile_nt<D>(dp, dv_desc, wg::desc<RB>(qt + kTile));  // dPᵀ = V·dOᵀ
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // Pᵀ from the columns' lse (f32, unrounded) in place of Sᵀ, and
    // dSᵀ = Pᵀ∘(dPᵀ − δ) in place of dPᵀ
    const float* Ls = vec_f + 128 * (t & 1);
    const int qrows = N - t * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 Lj = *reinterpret_cast<const float2*>(Ls + 8 * j + quad2);
      const float2 Dj = *reinterpret_cast<const float2*>(Ls + 64 + 8 * j + quad2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const bool ok = wg::frag_row(i) < keys && wg::frag_col(i) < qrows;
        const float L = (e & 1) ? Lj.y : Lj.x, dlt = (e & 1) ? Dj.y : Dj.x;
        const float p = ok ? exp2f(fmaf(s[i], scale, -L) * wg::kLog2e) : 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - dlt);
      }
    }
    uint32_t pa[4][4], da[4][4];  // Pᵀ and dSᵀ in bf16: the A operands
    wg::to_a_frags(s, pa);
    wg::to_a_frags(dp, da);
    wg::wgmma_fence();
    wg::mma_tile_rs<D>(acc_dv, pa, qt + kTile);  // dv += Pᵀ·dO
    wg::mma_tile_rs<D>(acc_dk, da, qt);          // dk += dSᵀ·Q
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc_dv);
    wg::fence_regs(acc_dk);
    __syncthreads();  // stage t & 1 is free for tile t + 2
  }

  // dk and dv share the gradient buffer's strides
  store_rows<D>(dk + b * sgb + h * sgh, sgn, acc_dk, scale, k0, N);
  store_rows<D>(dv + b * sgb + h * sgh, sgn, acc_dv, 1.f, k0, N);
}

// cp.async moves 16-byte pieces of rows: every base and stride must keep them
// aligned (the outputs' too, so that the wrapper's check is one rule)
inline bool rows_aligned(std::initializer_list<const void*> ptrs, const int64_t* st) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  for (int i = 0; i < 15; ++i) bits |= static_cast<uintptr_t>(st[i] * 2);
  return (bits & 15) == 0;
}

// the launch of a bfloat16 kernel: one warpgroup per 64 owned rows of a
// (batch, head); `kind` is 1 for dq, 2 for dk/dv
template <int D>
lq::Launch config_bf16(int B, int N, int H, int kind) {
  return {(N + 63) / 64, B * H, 1, wg::kThreads,
          kind == 1 ? dq_bf16_smem_bytes<D>() : dkv_bf16_smem_bytes<D>(), 1};
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int B, int N,
                           int H, float scale, const int64_t* st, cudaStream_t stream) {
  if (!rows_aligned({q, k, v, dout, dq}, st)) return cudaErrorInvalidValue;
  const lq::Launch l = config_bf16<D>(B, N, H, 1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16_wgmma<D><<<dim3(l.gx, l.gy), l.threads, l.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), N, H, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int B,
                            int N, int H, float scale, const int64_t* st,
                            cudaStream_t stream) {
  if (!rows_aligned({q, k, v, dout, dk, dv}, st)) return cudaErrorInvalidValue;
  const lq::Launch l = config_bf16<D>(B, N, H, 2);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_bf16_wgmma<D><<<dim3(l.gx, l.gy), l.threads, l.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      N, H, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

// the launch and the kernel one flash_bwd_dq (which = 1) or flash_bwd_dkv
// (which = 2) call makes (the queries' dispatch)
cudaError_t plan(int which, int B, int N, int H, int D, int dtype, lq::Launch* l,
                 const void** fn) {
  if (B < 1 || N < 1 || H < 1 || (which != 1 && which != 2)) return cudaErrorInvalidValue;
  const bool dq = which == 1;
  if (dtype == 0 && D == 64) {
    *l = config<64>(B, N, H, which);
    *fn = dq ? reinterpret_cast<const void*>(flash_bwd_dq_kernel<float, 64>)
             : reinterpret_cast<const void*>(flash_bwd_dkv_kernel<float, 64>);
  } else if (dtype == 0 && D == 32) {
    *l = config<32>(B, N, H, which);
    *fn = dq ? reinterpret_cast<const void*>(flash_bwd_dq_kernel<float, 32>)
             : reinterpret_cast<const void*>(flash_bwd_dkv_kernel<float, 32>);
  } else if (dtype == 1 && D == 64) {
    *l = config_bf16<64>(B, N, H, which);
    *fn = dq ? reinterpret_cast<const void*>(flash_bwd_dq_bf16_wgmma<64>)
             : reinterpret_cast<const void*>(flash_bwd_dkv_bf16_wgmma<64>);
  } else if (dtype == 1 && D == 32) {
    *l = config_bf16<32>(B, N, H, which);
    *fn = dq ? reinterpret_cast<const void*>(flash_bwd_dq_bf16_wgmma<32>)
             : reinterpret_cast<const void*>(flash_bwd_dkv_bf16_wgmma<32>);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// The launch a flash_bwd_dq (which = 1) or flash_bwd_dkv (which = 2) call
// with these shapes makes (launch_query.cuh's layout in out[0..5]), and its
// kernel's attributes at that launch.
extern "C" int flash_bwd_launch_config(int which, int B, int N, int H, int D, int dtype,
                                       long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(which, B, N, H, D, dtype, &l, &fn);
  if (err == cudaSuccess) lq::put(l, out);
  return static_cast<int>(err);
}

extern "C" int flash_bwd_attributes(int which, int B, int N, int H, int D, int dtype,
                                    long long* out) {
  lq::Launch l;
  const void* fn;
  const cudaError_t err = plan(which, B, N, H, D, dtype, &l, &fn);
  return static_cast<int>(err == cudaSuccess ? lq::attributes(fn, l, out) : err);
}

// dtype: 0 = float32 (CUDA-core FMAs), 1 = bfloat16 (wgmma; every base
// pointer 16-byte aligned and every stride a multiple of 8). Strides are in
// elements, (batch, token, head) for q, k, v, dO and the gradient output(s)
// in that order. lse and δ
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
  if (dtype == 1 && D == 64) return launch_dq_bf16<64>(q, k, v, dout, lse, delta, dq, B, N, H, scale, st, s);
  if (dtype == 1 && D == 32) return launch_dq_bf16<32>(q, k, v, dout, lse, delta, dq, B, N, H, scale, st, s);
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
  if (dtype == 1 && D == 64) return launch_dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv, B, N, H, scale, st, s);
  if (dtype == 1 && D == 32) return launch_dkv_bf16<32>(q, k, v, dout, lse, delta, dk, dv, B, N, H, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
