// Flash attention for Hopper (sm_90a): forward (K1), dK/dV (K2) and dQ
// (K3), recomputing P from the saved log-sum-exp in the backward so the
// S x S score matrix never reaches device memory.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   K1  _fwd_kernel      (:137, launched by _flash_fwd_pallas :225)
//   K2  _bwd_dkv_kernel  (:300, first pallas_call of _flash_bwd_pallas :508)
//   K3  _bwd_dq_kernel   (:385, second pallas_call :521)
// Each computes what its TPU counterpart computes:
//   * dot products take the input dtype (f32 or bf16) and accumulate in
//     f32; `scale` applies after the dot, in f32; m, l and lse stay f32;
//   * P is rounded to V's dtype before P.V (and to dO's before P^T.dO);
//     dS is rounded to the input dtype before dS.K and dS^T.Q;
//   * outputs are in the input dtype; lse is f32 [B, H, Sq].
//
// What bounds them: operations. At GPT-2 small's training shapes (S
// 1024, D 64, causal: 50.4M attended (query, key) pairs) K1 does 12.9
// GFLOP over 50.7 MB: 0.013 ms of tensor-core time at 989 TFLOP/s
// against 0.015 ms of bytes at 3.35 TB/s, so both limits are near and
// the kernel has to keep the tensor cores fed while it streams K/V. With
// D = 64 each pair costs 256 tensor-core operations and one exp2; an SM
// does about 4096 of the first and 16 of the second per clock, so the
// exp2s take as long as the products and have to overlap with them. K2
// does four products per pair (S^T, dP^T, dV and dK): 25.8 GFLOP over
// 76.3 MB, 0.026 ms of tensor-core time against 0.023 ms of bytes. K3
// does three (S, dP and dQ): 19.3 GFLOP over 63.7 MB, 0.0196 ms against
// 0.019 ms. Both are bound by operations, but barely, with one exp per
// pair again.
//
// What the design does:
//   * bf16 K1 (flash_fwd_wgmma, below): one block per (batch x head,
//     128 q rows) with two consumer warpgroups and one producer warp.
//     TMA brings Q once and K/V tiles of 128 keys into a 3-stage ring
//     guarded by mbarriers, so loads overlap the products; wgmma runs
//     both products (S = Q.K^T from shared memory, O += P.V with P from
//     registers), so each K/V tile fetched serves 128 queries at the
//     tensor cores' full rate; the two warpgroups' softmax and products
//     interleave on the SM. The band mask runs only on tiles that
//     straddle the diagonal or the window's edge, scores are exp2'd
//     with scale * log2 e folded in, and blocks start heaviest first;
//   * bf16 K2 (flash_bwd_dkv_wgmma, below) is K1's design turned
//     around: one block per (batch x head, 128 keys), K and V brought
//     once by TMA, q tiles of 64 rows (Q, dO, lse, dd) streamed through
//     a 3-stage ring, all four products on wgmma with the Q and dO
//     tiles read by the tensor cores straight from the ring (K-major
//     for S^T and dP^T, MN-major for dK and dV), so each q tile fetched
//     serves 128 keys and no warp copies a tile through registers; the
//     mask only on straddling tiles, and dK/dV leave in 16-byte stores;
//   * bf16 K3 (flash_bwd_dq_wgmma, below) is K1's shape with a second
//     score-like product: one block per (batch x head, 128 q rows), Q,
//     dO, lse and dd brought once, K/V tiles of 64 keys through a
//     4-stage TMA ring, S, dP and dQ += dS.K on wgmma (K read K-major for
//     S and MN-major for dQ from the same swizzled tile), the mask only
//     on straddling tiles, and dQ out in 16-byte stores;
//   * dd = rowsum(dO * O) is a kernel of its own (row_dot_kernel, below),
//     bound by bytes, which K2 and K3 read;
//   * f32 kernels: one CUDA block per (q tile of 64 rows, batch x head)
//     for K1 and K3, per (k tile of 64 keys, batch x head) for K2: the
//     TPU grid's sequential block axis becomes a loop inside the block,
//     and dK/dV and dQ stay two kernels so no atomics are needed;
//   * loop bounds skip tiles outside the causal / sliding-window band
//     (_causal_block_bounds for K1 and K3; for K2 the transposed bounds,
//     clamped so that `end` never falls below `start` — the Pallas K2's
//     bounds are not, which gives wrong dK/dV for causal + window with
//     q_len < kv_len);
//   * q/k/v/dO are read, and out/dq/dk/dv written, through (batch, seq,
//     head) element strides, so [B, S, H, D] views of the fused qkv
//     projection and [B, H, S, D] tensors go through the same kernel
//     (bf16 operands need a 16-byte aligned base and strides);
//   * f32 path: 256 threads, tiles in shared memory as f32 with a row
//     stride of 65 floats so every product reads conflict-free; thread
//     (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of
//     each 64 x 64 product, and row maxima and sums are half-warp
//     shuffles; f32 has no wgmma, so the f32 kernels stay on the CUDA
//     cores.
//
// Masking and NaN contract (that of the Pallas kernels):
//   * causal masking counts absolute query positions from kv_len - q_len;
//     a window W keeps keys k with q - W < k <= q;
//   * masked scores are -inf before the max; the shift is 0 while the
//     running max is -inf; alpha is 0 while the old max is not finite;
//   * lse = (m if finite else 0) + log(max(l, 1e-30)) and
//     out = acc / max(l, 1e-30): a fully masked row is exactly 0;
//   * in the backward P = exp(s - lse), zeroed where masked;
//   * the max and the clamp propagate NaN (fmaxf would drop it).
//   bf16 K1 keeps m in log2 units (the max of the raw scores times
//   scale * log2 e, which needs scale > 0), computes P = exp2(s * scale
//   * log2 e - m) in one multiply-add and one exp2, and writes
//   lse = m ln 2 + log(max(l, 1e-30)), the same natural-log lse.
// Build without --use_fast_math: it changes expf, logf and isnan.
//
// Shapes: head_dim 64 only (GPT-2 small's), sequence lengths multiples
// of 64 (of 128 for bf16 K1, kv_len for bf16 K2 and q_len for bf16 K3);
// the entry points reject anything else.
// The kernels allocate nothing: the caller allocates every output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;           // head_dim the kernels are built for
constexpr int kTile = 64;        // rows of a q tile and of a k tile
constexpr int kLd = kTile + 1;   // shared-memory row stride, in floats
constexpr int kTileFloats = kTile * kLd;
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kSub = 4;          // rows (and columns) per thread
constexpr int kStaticSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  long long sb, ss, sh;          // element strides of batch, seq, head
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                    // written by K1, read by K2 and K3
  const float* dd;               // rowsum(dO * O), [B, H, Sq]
  Layout lq, lk, lv, ldo, lout, ldq, ldk, ldv;
  int h, sq, sk;
  float scale;
  int causal, window;            // window <= 0: none
};

// the max, NaN when either input is NaN (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// reductions over the 16 threads of a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ bool band_keep(int qa, int ka, int window) {
  return ka <= qa && (window <= 0 || ka > qa - window);
}

__device__ __forceinline__ long long offset(const Layout& l, int b, int h,
                                            int s) {
  return b * l.sb + h * l.sh + s * l.ss;
}

// rows [s0, s0 + 64) of one (batch, head) -> f32 tile [64][kLd]
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          const Layout& l, int b, int h,
                                          int s0) {
  const float* base = static_cast<const float*>(src) + offset(l, b, h, s0);
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    dst[r * kLd + d] = base[r * l.ss + d];
  }
}

__device__ __forceinline__ void store_rows(void* dst, const Layout& l,
                                           int b, int h, int s0, int ty,
                                           int tx, float (&val)[kSub][kSub]) {
  float* base = static_cast<float*>(dst) + offset(l, b, h, s0);
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j)
      base[(ty + 16 * i) * l.ss + tx + 16 * j] = val[i][j];
}

// key tiles [lo, hi) of BK keys that q tile qt of BQ rows sees: the
// outer bounds of _causal_block_bounds
template <int BQ, int BK>
__device__ __forceinline__ void key_range(const Args& a, int qt, int* lo,
                                          int* hi) {
  const int nkb = a.sk / BK;
  *lo = 0;
  *hi = nkb;
  if (!a.causal) return;
  const int off = a.sk - a.sq;
  const int last = off + qt * BQ + BQ - 1;  // last query, absolute
  *hi = last < 0 ? 0 : min(nkb, last / BK + 1);
  if (a.window > 0) {
    const int first = off + qt * BQ - a.window + 1;  // first key seen
    *lo = first <= 0 ? 0 : min(first / BK, *hi);
  }
}

// q tiles [lo, hi) of BQ rows that see k tile kt of BK keys, hi clamped
// to at least lo: _dkv_block_bounds
template <int BQ, int BK>
__device__ __forceinline__ void query_range(const Args& a, int kt, int* lo,
                                            int* hi) {
  const int nqb = a.sq / BQ;
  *lo = 0;
  *hi = nqb;
  if (!a.causal) return;
  const int off = a.sk - a.sq;
  const int first = kt * BK - off;      // first query row seeing key kt*BK
  *lo = first <= 0 ? 0 : min(first / BQ, nqb);
  if (a.window > 0) {
    const int last = kt * BK + BK - 1 + a.window - 1 - off;
    *hi = last < 0 ? 0 : min(nqb, last / BQ + 1);
  }
  *hi = max(*hi, *lo);
}

// s[i][j] += A[ty + 16 i][:] . B[tx + 16 j][:] over the head dim, and the
// same for a second pair when `two` (the backward's S and dP)
template <bool kTwo>
__device__ __forceinline__ void tile_dots(const float* a0, const float* b0,
                                          const float* a1, const float* b1,
                                          int ty, int tx,
                                          float (&s0)[kSub][kSub],
                                          float (&s1)[kSub][kSub]) {
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float av[kSub], bv[kSub], cv[kSub], ev[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      av[i] = a0[(ty + 16 * i) * kLd + d];
      bv[i] = b0[(tx + 16 * i) * kLd + d];
      if (kTwo) {
        cv[i] = a1[(ty + 16 * i) * kLd + d];
        ev[i] = b1[(tx + 16 * i) * kLd + d];
      }
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s0[i][j] = fmaf(av[i], bv[j], s0[i][j]);
        if (kTwo) s1[i][j] = fmaf(cv[i], ev[j], s1[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// f32 inputs, CUDA cores. K1: forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* p_s = v_s + kTileFloats;
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kTile, off = a.sk - a.sq;

  load_tile(q_s, a.q, a.lq, b, h, q0);
  int lo, hi;
  key_range<kTile, kTile>(a, qt, &lo, &hi);

  float m[kSub], l[kSub], acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
  }

  for (int jt = lo; jt < hi; ++jt) {
    __syncthreads();             // readers of the previous tiles are done
    load_tile(k_s, a.k, a.lk, b, h, jt * kTile);
    load_tile(v_s, a.v, a.lv, b, h, jt * kTile);
    __syncthreads();
    float s[kSub][kSub] = {}, unused[kSub][kSub];
    tile_dots<false>(q_s, k_s, nullptr, nullptr, ty, tx, s, unused);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int qa = off + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        float x = s[i][j] * a.scale;
        if (a.causal && !band_keep(qa, jt * kTile + tx + 16 * j, a.window))
          x = -INFINITY;
        s[i][j] = x;
        mx = nan_max(mx, x);
      }
      const float m_new = nan_max(m[i], row_max(mx));
      const float shift = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - shift) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = expf(s[i][j] - shift);
        psum += p;
        p_s[(ty + 16 * i) * kLd + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
#pragma unroll
      for (int j = 0; j < kSub; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[kSub], vv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        pv[i] = p_s[(ty + 16 * i) * kLd + kk];
        vv[i] = v_s[kk * kLd + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const float den = nan_max(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = acc[i][j] / den;
    if (tx == 0)
      a.lse[(long long)bh * a.sq + q0 + ty + 16 * i] =
          (isfinite(m[i]) ? m[i] : 0.f) + logf(den);
  }
  store_rows(a.out, a.lout, b, h, q0, ty, tx, acc);
}

// ---------------------------------------------------------------------------
// f32 backward: P and dS of one 64 x 64 tile pair
// ---------------------------------------------------------------------------

// From S = Q.K^T (unscaled) and dP = dO.V^T of the thread's entries,
// write P (when p_s is given) and dS at [q row][key] of the tiles in
// shared memory.
__device__ __forceinline__ void p_and_ds(const Args& a, int q0, int k0,
                                         int ty, int tx,
                                         const float* lse_s,
                                         const float* dd_s,
                                         float (&s)[kSub][kSub],
                                         float (&dp)[kSub][kSub],
                                         float* p_s, float* ds_s) {
  const int off = a.sk - a.sq;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    const int qa = off + q0 + r;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int c = tx + 16 * j;
      float p = expf(s[i][j] * a.scale - lse_s[r]);
      if (a.causal && !band_keep(qa, k0 + c, a.window)) p = 0.f;
      if (p_s != nullptr) p_s[r * kLd + c] = p;
      ds_s[r * kLd + c] = p * (dp[i][j] - dd_s[r]) * a.scale;
    }
  }
}

__device__ __forceinline__ void load_stats(const Args& a, int bh, int q0,
                                           float* lse_s, float* dd_s) {
  if (threadIdx.x < kTile) {
    const long long row = (long long)bh * a.sq + q0 + threadIdx.x;
    lse_s[threadIdx.x] = a.lse[row];
    dd_s[threadIdx.x] = a.dd[row];
  }
}

// ---------------------------------------------------------------------------
// f32 K2: dK and dV of one k tile, over the q tiles that see it
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTileFloats;
  float* q_s = v_s + kTileFloats;
  float* do_s = q_s + kTileFloats;
  float* p_s = do_s + kTileFloats;
  float* ds_s = p_s + kTileFloats;
  float* lse_s = ds_s + kTileFloats;
  float* dd_s = lse_s + kTile;
  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * kTile;

  load_tile(k_s, a.k, a.lk, b, h, k0);
  load_tile(v_s, a.v, a.lv, b, h, k0);
  int lo, hi;
  query_range<kTile, kTile>(a, kt, &lo, &hi);

  // rows: keys ty + 16 i; columns: head dim tx + 16 j
  float dk[kSub][kSub] = {}, dv[kSub][kSub] = {};
  for (int it = lo; it < hi; ++it) {
    const int q0 = it * kTile;
    __syncthreads();
    load_tile(q_s, a.q, a.lq, b, h, q0);
    load_tile(do_s, a.dout, a.ldo, b, h, q0);
    load_stats(a, bh, q0, lse_s, dd_s);
    __syncthreads();
    // entries [q row ty + 16 i][key tx + 16 j] of S and dP
    float s[kSub][kSub] = {}, dp[kSub][kSub] = {};
    tile_dots<true>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
    p_and_ds(a, q0, k0, ty, tx, lse_s, dd_s, s, dp, p_s, ds_s);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float pv[kSub], sv[kSub], ov[kSub], qv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        pv[i] = p_s[r * kLd + ty + 16 * i];
        sv[i] = ds_s[r * kLd + ty + 16 * i];
        ov[i] = do_s[r * kLd + tx + 16 * i];
        qv[i] = q_s[r * kLd + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
        }
    }
  }
  store_rows(a.dk, a.ldk, b, h, k0, ty, tx, dk);
  store_rows(a.dv, a.ldv, b, h, k0, ty, tx, dv);
}

// ---------------------------------------------------------------------------
// f32 K3: dQ of one q tile, over the k tiles it sees
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTileFloats;
  float* k_s = do_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* ds_s = v_s + kTileFloats;
  float* lse_s = ds_s + kTileFloats;
  float* dd_s = lse_s + kTile;
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;

  load_tile(q_s, a.q, a.lq, b, h, q0);
  load_tile(do_s, a.dout, a.ldo, b, h, q0);
  load_stats(a, bh, q0, lse_s, dd_s);
  int lo, hi;
  key_range<kTile, kTile>(a, qt, &lo, &hi);

  // rows: q rows ty + 16 i; columns: head dim tx + 16 j
  float dq[kSub][kSub] = {};
  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();
    load_tile(k_s, a.k, a.lk, b, h, k0);
    load_tile(v_s, a.v, a.lv, b, h, k0);
    __syncthreads();
    float s[kSub][kSub] = {}, dp[kSub][kSub] = {};
    tile_dots<true>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
    p_and_ds(a, q0, k0, ty, tx, lse_s, dd_s, s, dp, nullptr, ds_s);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float sv[kSub], kv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        sv[i] = ds_s[(ty + 16 * i) * kLd + kk];
        kv[i] = k_s[kk * kLd + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j)
          dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
  }
  store_rows(a.dq, a.ldq, b, h, q0, ty, tx, dq);
}

// ---------------------------------------------------------------------------
// bf16 K1 on Hopper: TMA-fed K/V ring and wgmma
// ---------------------------------------------------------------------------
//
// One CUDA block per (batch x head, 128 q rows): two consumer warpgroups
// own 64 q rows each, one producer warp issues every load. Q (one box)
// and each K and V tile (128 keys, one box each) come by TMA, 4-D maps
// (head dim, head, seq, batch) built on the host from the (batch, seq,
// head) strides, into shared memory in the 128-byte swizzle that wgmma
// reads: a 64-element bf16 row is exactly one 128-byte swizzle row.
// K/V tiles cycle through a ring of kStages stages; stage s has a
// "full" mbarrier (the producer's arrive with expect_tx of both boxes'
// bytes, completed by the copies) and an "empty" one (one arrive per
// consumer warp once its P.V wgmma has retired). Per K/V tile each
// warpgroup runs
//   S = Q.K^T  wgmma m64n128k16, both operands K-major in shared
//              memory, 4 steps of 16 head dims (+32 bytes each);
//   softmax    in registers on the accumulators (the mma.sync C layout:
//              rows g and g + 8 of each warp's 16, columns 8n + 2t),
//              in log2 units (exp2 with scale * log2 e folded in), the
//              band mask only on tiles that straddle the diagonal or
//              the window's edge;
//   O += P.V   wgmma m64n64k16 with A = P from registers (the
//              accumulators packed to bf16 pairs) and B = the V tile,
//              which is MN-major (head dim contiguous): transpose-B.
// Blocks run heaviest first: blockIdx.y counts q tiles from the last.

constexpr int kBlk = 128;                  // q rows per block, keys per tile
constexpr int kStages = 3;                 // depth of the K/V ring
constexpr int kBoxBytes = kBlk * kD * 2;   // one TMA box: 128 rows x 64 bf16
constexpr int kSwRow = 128;                // bytes of one swizzled row
constexpr int kSwAtom = 8 * kSwRow;        // 8 rows: one swizzle period
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kWgThreads = kConsumers + 32;
// 1024-byte alignment slack, Q, the ring, 2 kStages + 1 mbarriers
constexpr int kFwdSmem = 1024 + kBoxBytes * (1 + 2 * kStages) +
                         8 * (2 * kStages + 1);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

// (lo, hi) rounded to bf16 (nearest even) and packed, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive once and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one box (rows [s, s + box rows) of head h, batch b) into shared memory
// at dst; its bytes count toward `bar`'s transactions
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h),
      "r"(s), "r"(b)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; they count toward `bar`'s transactions
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (in 16-byte units), layout 1 = 128-byte swizzle. Adding
// n to it advances the start address by 16 n bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

// K-major operand (rows of 64 bf16): 8-row swizzle atoms kSwAtom apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, kSwAtom);
}

// MN-major operand (V read as B[key][dim]): the 16 keys of one k-step
// are two 8-key atoms kSwAtom apart; one 64-dim atom spans all of N
constexpr uint32_t kVLbo = kBoxBytes, kVSbo = kSwAtom;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pin register reads and writes on their side of a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(d[n][i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both from shared memory;
// accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_qk(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared
// memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss64(float (&d)[8][4], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A in registers (the mma.sync A
// fragment layout: lane 4 g + t of warp w holds rows 16 w + g and
// 16 w + g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9, in bf16 pairs),
// B MN-major in shared memory (transpose-B)
__device__ __forceinline__ void wgmma_pv(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = q_s + kBoxBytes;   // stage s: K, then V
  const uint32_t bars = ring + 2 * kBoxBytes * kStages;
  const uint32_t q_bar = bars + 16 * kStages;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s)
  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int q0 = qt * kBlk, off = a.sk - a.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int lo, hi;
  key_range<kBlk, kBlk>(a, qt, &lo, &hi);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers / 32);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {           // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_bar, kBoxBytes);
      tma_rows(q_s, &tq, q_bar, h, q0, b);
      for (int j = lo, i = 0; j < hi; ++j, ++i) {
        const int s = i % kStages;
        if (i >= kStages)                  // tile i - kStages released
          mbar_wait(bars + 8 * (kStages + s), (i / kStages - 1) & 1);
        const uint32_t kv = ring + 2 * kBoxBytes * s;
        mbar_expect_tx(bars + 8 * s, 2 * kBoxBytes);
        tma_rows(kv, &tk, bars + 8 * s, h, j * kBlk, b);
        tma_rows(kv + kBoxBytes, &tv, bars + 8 * s, h, j * kBlk, b);
      }
    }
    return;
  }

  // warpgroup wg owns q rows [64 wg, 64 wg + 64); lane 4 g + t of its
  // warp w holds rows 16 w + g and 16 w + g + 8
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3);
  const int qlo = off + q0 + 64 * wg, qhi = qlo + 63;  // absolute rows
  const float c = a.scale * kLog2e;
  const uint64_t q_desc = kmajor_desc(q_s + 64 * wg * kSwRow);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[8][4] = {};
  mbar_wait(q_bar, 0);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kStages, k0 = j * kBlk;
    const uint32_t kv = ring + 2 * kBoxBytes * s;
    mbar_wait(bars + 8 * s, (i / kStages) & 1);

    float sc[16][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      wgmma_qk(sc, q_desc + 2 * ks, kmajor_desc(kv) + 2 * ks, ks);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // -inf outside the band, on edge tiles only
    if (a.causal && (k0 + kBlk - 1 > qlo ||
                     (a.window > 0 && k0 <= qhi - a.window))) {
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!band_keep(off + q0 + r0 + g + 8 * (e >> 1),
                         k0 + 8 * n + 2 * t + (e & 1), a.window))
            sc[n][e] = -INFINITY;
    }
    // row maxima and sums in four independent chains each, so that two
    // warps per scheduler are not held by the latency of one long chain
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float part[4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        part[n] = nan_max(sc[n][2 * hr], sc[n][2 * hr + 1]);
#pragma unroll
      for (int n = 4; n < 16; ++n)
        part[n & 3] = nan_max(part[n & 3],
                              nan_max(sc[n][2 * hr], sc[n][2 * hr + 1]));
      float mx = nan_max(nan_max(part[0], part[1]), nan_max(part[2], part[3]));
      mx = nan_max(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = nan_max(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = nan_max(m[hr], mx * c);   // c > 0
      const float shift = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[hr]) ? ex2(m[hr] - shift) : 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) part[n] = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          sc[n][e] = ex2(fmaf(sc[n][e], c, -shift));
          part[n & 3] += sc[n][e];
        }
      float ps = (part[0] + part[1]) + (part[2] + part[3]);
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      l[hr] = l[hr] * alpha + ps;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * hr] *= alpha;
        o[n][2 * hr + 1] *= alpha;
      }
      m[hr] = m_new;
    }

    // O += bf16(P) . V, 16 keys per step: columns 16 kk .. 16 kk + 15
    // of S are its C tiles 2 kk and 2 kk + 1, i.e. one A fragment
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack2(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack2(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_pv(o, pa[kk],
               sw128_desc(kv + kBoxBytes + 2 * kk * kSwAtom, kVLbo, kVSbo));
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
  }

  // lse in natural-log units; out in two bf16 per 32-bit store
  bf16* out = static_cast<bf16*>(a.out) + offset(a.lout, b, h, q0 + r0 + g);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float den = nan_max(l[hr], 1e-30f);
    if (t == 0)
      a.lse[(long long)bh * a.sq + q0 + r0 + g + 8 * hr] =
          (isfinite(m[hr]) ? m[hr] * kLn2 : 0.f) + logf(den);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * hr * a.lout.ss + 8 * n + 2 * t) =
          pack2(o[n][2 * hr] / den, o[n][2 * hr + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// bf16 K2 on Hopper: TMA-fed Q/dO ring and wgmma
// ---------------------------------------------------------------------------
//
// One CUDA block per (batch x head, 128 keys): two consumer warpgroups
// own 64 keys each, one producer warp issues every load. K and V of the
// block's keys come by TMA once (one 128-row box each) and stay in
// shared memory as the A operands of the first two products. q tiles of
// 64 rows stream through a ring of kBwdStages stages; stage s holds the
// tile's Q and dO boxes (64 rows, 128-byte swizzle) and its lse and dd
// (256 bytes each, cp.async.bulk), behind a "full" mbarrier (the
// producer's expect_tx, completed by the copies) and an "empty" one
// (one arrive per consumer warp once its last product has retired).
// Per q tile each warpgroup runs
//   S^T = K.Q^T, dP^T = V.dO^T  wgmma m64n64k16, both operands K-major
//                               in shared memory; one wait for both;
//   P, dS                       in registers on the accumulators, whose
//                               rows are keys (g and g + 8 of each warp's
//                               16) and columns queries (8n + 2t): lse
//                               and dd are read by column; the band mask
//                               only where the tile straddles the
//                               diagonal or the window's edge over the
//                               warpgroup's 64 keys;
//   dV += P^T.dO, dK += dS^T.Q  wgmma m64n64k16 with A = bf16(P^T) and
//                               bf16(dS^T) packed from the accumulators
//                               and B the dO / Q tile read MN-major
//                               (transpose-B, as K1 reads V): the same
//                               swizzled tile the first products read
//                               K-major.
// All four accumulators (dK, dV, S^T, dP^T: 128 f32 registers a thread)
// are live at once, at 168 registers, the most ptxas gives a 288-thread
// block; so the products of one tile are not overlapped with its
// exponentials (doing so spilled and ran slower).
// The epilogue stages each warpgroup's dK and dV in bf16 in its own 64
// rows of the K and V tiles, which its last product has finished
// reading (16-byte chunk c of row r at chunk c ^ (r & 7), so neither the
// fragment writes nor the row reads conflict on banks), then writes them
// out in 16-byte stores. A block whose q range is empty loads nothing
// and writes zeros. Blocks run heaviest first: under causal masking k
// block 0 is seen by every q tile.

constexpr int kBwdQ = 64;                    // q rows per ring stage
constexpr int kBwdStages = 3;                // depth of the Q/dO ring
constexpr int kQBoxBytes = kBwdQ * kD * 2;   // one TMA box: 64 rows x 64 bf16
constexpr int kStatBytes = kBwdQ * 4;        // lse or dd of one q tile
// 1024-byte alignment slack, K, V, the ring's boxes and statistics,
// 2 kBwdStages + 1 mbarriers
constexpr int kBwdSmem = 1024 + 2 * kBoxBytes +
                         kBwdStages * 2 * (kQBoxBytes + kStatBytes) +
                         8 * (2 * kBwdStages + 1);

// C fragments of a 64 x 64 tile -> the bf16 A fragments of 4 k-steps
// of 16 columns: columns 16 kk .. 16 kk + 15 are C tiles 2 kk, 2 kk + 1
__device__ __forceinline__ void pack_a(const float (&c)[8][4],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + kBoxBytes;
  const uint32_t ring = v_s + kBoxBytes;   // stage s: Q, then dO
  const uint32_t stats = ring + 2 * kQBoxBytes * kBwdStages;  // lse, dd
  const uint32_t bars = stats + 2 * kStatBytes * kBwdStages;
  const uint32_t kv_bar = bars + 16 * kBwdStages;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kBwdStages + s)
  uint8_t* const k_ptr = smem_raw + (k_s - raw);   // generic pointer to K
  const int bh = blockIdx.x, kt = blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int k0 = kt * kBlk, off = a.sk - a.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int lo, hi;
  query_range<kBwdQ, kBlk>(a, kt, &lo, &hi);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kBwdStages + s), kConsumers / 32);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {           // the producer warp
    if (lane == 0 && lo < hi) {
      mbar_expect_tx(kv_bar, 2 * kBoxBytes);
      tma_rows(k_s, &tk, kv_bar, h, k0, b);
      tma_rows(v_s, &tv, kv_bar, h, k0, b);
      const float* lse = a.lse + (long long)bh * a.sq;
      const float* dd = a.dd + (long long)bh * a.sq;
      for (int it = lo, i = 0; it < hi; ++it, ++i) {
        const int s = i % kBwdStages, q0 = it * kBwdQ;
        if (i >= kBwdStages)               // tile i - kBwdStages released
          mbar_wait(bars + 8 * (kBwdStages + s), (i / kBwdStages - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t qd = ring + 2 * kQBoxBytes * s;
        const uint32_t st = stats + 2 * kStatBytes * s;
        mbar_expect_tx(full, 2 * (kQBoxBytes + kStatBytes));
        tma_rows(qd, &tq, full, h, q0, b);
        tma_rows(qd + kQBoxBytes, &tdo, full, h, q0, b);
        bulk_copy(st, lse + q0, kStatBytes, full);
        bulk_copy(st + kStatBytes, dd + q0, kStatBytes, full);
      }
    }
    return;
  }

  // warpgroup wg owns keys [64 wg, 64 wg + 64) of the block; lane 4 g + t
  // of its warp w holds keys 16 w + g and 16 w + g + 8 of them
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3);               // the warp's first key in wg
  const int kw = k0 + 64 * wg;                  // wg's first key, absolute
  const uint64_t k_desc = kmajor_desc(k_s + 64 * wg * kSwRow);
  const uint64_t v_desc = kmajor_desc(v_s + 64 * wg * kSwRow);

  float dk[8][4] = {}, dv[8][4] = {};
  if (lo < hi) mbar_wait(kv_bar, 0);
  for (int it = lo, i = 0; it < hi; ++it, ++i) {
    const int s = i % kBwdStages, qa = off + it * kBwdQ;  // first query
    const uint32_t q_tile = ring + 2 * kQBoxBytes * s;
    const uint32_t do_tile = q_tile + kQBoxBytes;
    mbar_wait(bars + 8 * s, (i / kBwdStages) & 1);

    float st[8][4], dpt[8][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      wgmma_ss64(st, k_desc + 2 * ks, kmajor_desc(q_tile) + 2 * ks, ks);
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      wgmma_ss64(dpt, v_desc + 2 * ks, kmajor_desc(do_tile) + 2 * ks, ks);
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
    fence_regs(dpt);

    // P = exp(S scale - lse), zeroed outside the band (edge tiles only),
    // and dS = P (dP - dd) scale; columns 8n + 2t + e are queries
    const float* lse = reinterpret_cast<const float*>(
        k_ptr + (stats - k_s) + 2 * kStatBytes * s);
    const float* dd = lse + kBwdQ;
    const bool edge = a.causal && (kw + 63 > qa || (a.window > 0 &&
                                                    kw <= qa + 63 - a.window));
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * n + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float p = expf(st[n][e] * a.scale - (c ? l2.y : l2.x));
        if (edge && !band_keep(qa + 8 * n + 2 * t + c,
                               kw + r0 + g + 8 * (e >> 1), a.window))
          p = 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - (c ? d2.y : d2.x)) * a.scale;
      }
    }

    // dV += bf16(P^T) . dO and dK += bf16(dS^T) . Q, 16 queries a step
    uint32_t pa[4][4], da[4][4];
    pack_a(st, pa);
    pack_a(dpt, da);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv(dv, pa[kk], sw128_desc(do_tile + 2 * kk * kSwAtom, kVLbo,
                                      kVSbo));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv(dk, da[kk], sw128_desc(q_tile + 2 * kk * kSwAtom, kVLbo,
                                      kVSbo));
    wgmma_commit();
    wgmma_wait();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kBwdStages + s));
  }

  // stage dK and dV in bf16 in the warpgroup's rows of the K and V tiles
  uint8_t* const dk_s = k_ptr + 64 * wg * kSwRow;
  uint8_t* const dv_s = dk_s + kBoxBytes;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;             // r & 7 == g
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int at = r * kSwRow + ((n ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(dk_s + at) =
          pack2(dk[n][2 * hr], dk[n][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dv_s + at) =
          pack2(dv[n][2 * hr], dv[n][2 * hr + 1]);
    }
  }
  named_sync(1 + wg, 128);
  // 64 rows x 8 chunks of 16 bytes each, 4 of each tile per thread
  bf16* const dk_g = static_cast<bf16*>(a.dk) + offset(a.ldk, b, h, kw);
  bf16* const dv_g = static_cast<bf16*>(a.dv) + offset(a.ldv, b, h, kw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = (threadIdx.x & 127) + 128 * j, r = idx >> 3, c = idx & 7;
    const int at = r * kSwRow + ((c ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(dk_g + r * a.ldk.ss + 8 * c) =
        *reinterpret_cast<const uint4*>(dk_s + at);
    *reinterpret_cast<uint4*>(dv_g + r * a.ldv.ss + 8 * c) =
        *reinterpret_cast<const uint4*>(dv_s + at);
  }
}

// ---------------------------------------------------------------------------
// bf16 K3 on Hopper: TMA-fed K/V ring and wgmma
// ---------------------------------------------------------------------------
//
// K1's shape with a second score-like product and no online softmax. One
// CUDA block per (batch x head, 128 q rows): two consumer warpgroups own
// 64 q rows each, one producer warp issues every load. Q and dO of the
// block's rows come by TMA once (one 128-row box each), lse and dd by
// cp.async.bulk (512 bytes each), all behind one mbarrier; K/V tiles of
// 64 keys stream through a ring of kDqStages stages, a 64-row K box and
// a 64-row V box a stage, guarded by "full" and "empty" mbarriers as in
// K2's ring. Per K/V tile each warpgroup runs
//   S = Q.K^T, dP = dO.V^T  wgmma m64n64k16, both operands K-major in
//                           shared memory; one wait for both;
//   P, dS                   in registers on the accumulators, whose rows
//                           are q rows (g and g + 8 of each warp's 16)
//                           and columns keys (8n + 2t): P = exp2(S scale
//                           log2 e - lse log2 e), zeroed outside the band
//                           on tiles that straddle the diagonal or the
//                           window's edge over the warpgroup's 64 rows,
//                           and dS = P (dP - dd) scale;
//   dQ += dS.K              wgmma m64n64k16 with A = bf16(dS) packed from
//                           the accumulators and B the same swizzled K
//                           tile read MN-major (transpose-B, as K1 reads
//                           V).
// 64-key tiles keep dQ, S and dP at 96 f32 registers a thread, under the
// 168 that ptxas gives a 288-thread block (128-key tiles would need 160).
// Both warpgroups walk the block's key range, _causal_block_bounds at
// bq 128 and bk 64; under causal masking warpgroup 0 so also visits the
// 64 keys past its diagonal, every pair masked. Which tiles a row visits
// decides which dQ rows a NaN in K reaches (dS = 0 times a NaN key is
// NaN): plain_bwd_dq(bq=128, bk=64) walks the same schedule.
// The epilogue stages dQ in bf16 in the warpgroup's own rows of the Q
// tile, which its last S product has finished reading (16-byte chunk c
// of row r at chunk c ^ (r & 7), as K2's), then writes it out in 16-byte
// stores. A block whose key range is empty loads nothing and writes
// zeros. Blocks run heaviest first, as K1's.

constexpr int kDqK = 64;                      // keys per ring stage
constexpr int kDqStages = 4;                  // depth of the K/V ring
constexpr int kKvBoxBytes = kDqK * kD * 2;    // one box: 64 rows x 64 bf16
constexpr int kRowStatBytes = kBlk * 4;       // lse or dd of the block
// 1024-byte alignment slack, Q, dO, the ring, lse and dd, 2 kDqStages + 1
// mbarriers
constexpr int kDqSmem = 1024 + 2 * kBoxBytes + kDqStages * 2 * kKvBoxBytes +
                        2 * kRowStatBytes + 8 * (2 * kDqStages + 1);

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t do_s = q_s + kBoxBytes;
  const uint32_t ring = do_s + kBoxBytes;  // stage s: K, then V
  const uint32_t stats = ring + 2 * kKvBoxBytes * kDqStages;  // lse, dd
  const uint32_t bars = stats + 2 * kRowStatBytes;
  const uint32_t qd_bar = bars + 16 * kDqStages;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kDqStages + s)
  uint8_t* const q_ptr = smem_raw + (q_s - raw);   // generic pointer to Q
  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int q0 = qt * kBlk, off = a.sk - a.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int lo, hi;
  key_range<kBlk, kDqK>(a, qt, &lo, &hi);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kDqStages + s), kConsumers / 32);
    }
    mbar_init(qd_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {           // the producer warp
    if (lane == 0 && lo < hi) {
      const long long row = (long long)bh * a.sq + q0;
      mbar_expect_tx(qd_bar, 2 * (kBoxBytes + kRowStatBytes));
      tma_rows(q_s, &tq, qd_bar, h, q0, b);
      tma_rows(do_s, &tdo, qd_bar, h, q0, b);
      bulk_copy(stats, a.lse + row, kRowStatBytes, qd_bar);
      bulk_copy(stats + kRowStatBytes, a.dd + row, kRowStatBytes, qd_bar);
      for (int j = lo, i = 0; j < hi; ++j, ++i) {
        const int s = i % kDqStages;
        if (i >= kDqStages)                // tile i - kDqStages released
          mbar_wait(bars + 8 * (kDqStages + s), (i / kDqStages - 1) & 1);
        const uint32_t kv = ring + 2 * kKvBoxBytes * s;
        mbar_expect_tx(bars + 8 * s, 2 * kKvBoxBytes);
        tma_rows(kv, &tk, bars + 8 * s, h, j * kDqK, b);
        tma_rows(kv + kKvBoxBytes, &tv, bars + 8 * s, h, j * kDqK, b);
      }
    }
    return;
  }

  // warpgroup wg owns q rows [64 wg, 64 wg + 64) of the block; lane 4 g +
  // t of its warp w holds rows 16 w + g and 16 w + g + 8 of them
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3);               // the warp's first row in wg
  const int qw = off + q0 + 64 * wg;            // wg's first query, absolute
  const float c = a.scale * kLog2e;
  const uint64_t q_desc = kmajor_desc(q_s + 64 * wg * kSwRow);
  const uint64_t do_desc = kmajor_desc(do_s + 64 * wg * kSwRow);

  // lse (in log2 units) and dd of the thread's rows r0 + g + 8 hr
  float dq[8][4] = {}, lse2[2] = {}, dd2[2] = {};
  if (lo < hi) {
    mbar_wait(qd_bar, 0);
    const float* st = reinterpret_cast<const float*>(q_ptr + (stats - q_s));
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 64 * wg + r0 + g + 8 * hr;
      lse2[hr] = st[r] * kLog2e;
      dd2[hr] = st[kBlk + r];
    }
  }
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int s = i % kDqStages, k0 = j * kDqK;
    const uint32_t k_tile = ring + 2 * kKvBoxBytes * s;
    const uint32_t v_tile = k_tile + kKvBoxBytes;
    mbar_wait(bars + 8 * s, (i / kDqStages) & 1);

    float sc[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      wgmma_ss64(sc, q_desc + 2 * ks, kmajor_desc(k_tile) + 2 * ks, ks);
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      wgmma_ss64(dp, do_desc + 2 * ks, kmajor_desc(v_tile) + 2 * ks, ks);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    // P, zeroed outside the band (edge tiles only), then dS over dP
    const bool edge = a.causal && (k0 + kDqK - 1 > qw ||
                                   (a.window > 0 && k0 <= qw + 63 - a.window));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float p = ex2(fmaf(sc[n][e], c, -lse2[hr]));
        if (edge && !band_keep(qw + r0 + g + 8 * hr,
                               k0 + 8 * n + 2 * t + (e & 1), a.window))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - dd2[hr]) * a.scale;
      }

    // dQ += bf16(dS) . K, 16 keys a step
    uint32_t da[4][4];
    pack_a(dp, da);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv(dq, da[kk], sw128_desc(k_tile + 2 * kk * kSwAtom, kVLbo,
                                      kVSbo));
    wgmma_commit();
    wgmma_wait();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kDqStages + s));
  }

  // stage dQ in bf16 in the warpgroup's rows of the Q tile
  uint8_t* const dq_s = q_ptr + 64 * wg * kSwRow;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;             // r & 7 == g
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dq_s + r * kSwRow + ((n ^ g) << 4) +
                                   4 * t) =
          pack2(dq[n][2 * hr], dq[n][2 * hr + 1]);
  }
  named_sync(1 + wg, 128);
  // 64 rows x 8 chunks of 16 bytes, 4 per thread
  bf16* const dq_g =
      static_cast<bf16*>(a.dq) + offset(a.ldq, b, h, q0 + 64 * wg);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = (threadIdx.x & 127) + 128 * j, r = idx >> 3, cc = idx & 7;
    *reinterpret_cast<uint4*>(dq_g + r * a.ldq.ss + 8 * cc) =
        *reinterpret_cast<const uint4*>(dq_s + r * kSwRow +
                                        ((cc ^ (r & 7)) << 4));
  }
}

// ---------------------------------------------------------------------------
// dd = rowsum(dO * O), the backward's row statistic
// ---------------------------------------------------------------------------
//
// No Pallas counterpart: _flash_bwd_pallas computes it with jnp ops that
// XLA fuses (paddle_tpu/ops/pallas/flash_attention.py:466-469, 489-492).
// Bound by bytes: it reads dO and O once and writes 4 bytes a row (at
// GPT-2 small's training shapes 2 x 12.6 MB + 0.4 MB, 7.6 us at 3.35
// TB/s). Eight lanes own a row of 64: each reads 16 bytes of dO and of
// O (32 for f32), multiplies and sums in f32, and three shuffles finish
// the row; a warp does 4 rows, a block 32. Rows run in [B, H, Sq] order,
// so the output is written contiguously. The sums propagate NaN.

constexpr int kDotThreads = 256;
constexpr int kDotRows = kDotThreads / 8;

__device__ __forceinline__ float chunk_dot(const bf16* x, const bf16* y) {
  const uint4 xv = *reinterpret_cast<const uint4*>(x);
  const uint4 yv = *reinterpret_cast<const uint4*>(y);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(x2[i]);
    const float2 yf = __bfloat1622float2(y2[i]);
    sum = fmaf(xf.x, yf.x, sum);
    sum = fmaf(xf.y, yf.y, sum);
  }
  return sum;
}

__device__ __forceinline__ float chunk_dot(const float* x, const float* y) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 xv = reinterpret_cast<const float4*>(x)[i];
    const float4 yv = reinterpret_cast<const float4*>(y)[i];
    sum = fmaf(xv.x, yv.x, sum);
    sum = fmaf(xv.y, yv.y, sum);
    sum = fmaf(xv.z, yv.z, sum);
    sum = fmaf(xv.w, yv.w, sum);
  }
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(kDotThreads)
    row_dot_kernel(const T* dout, const T* out, Layout ldo, Layout lout,
                   float* dd, int h, int sq, int rows) {
  const int row = blockIdx.x * kDotRows + (threadIdx.x >> 3);
  const int c = threadIdx.x & 7;          // the lane's 8 elements of the row
  float sum = 0.f;
  if (row < rows) {
    const int s = row % sq, bh = row / sq, b = bh / h, hh = bh % h;
    sum = chunk_dot(dout + offset(ldo, b, hh, s) + 8 * c,
                    out + offset(lout, b, hh, s) + 8 * c);
  }
  sum += __shfl_xor_sync(kFull, sum, 1);
  sum += __shfl_xor_sync(kFull, sum, 2);
  sum += __shfl_xor_sync(kFull, sum, 4);
  if (row < rows && c == 0) dd[row] = sum;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int smem_bytes(int tiles, bool stats) {
  return (tiles * kTileFloats + (stats ? 2 * kTile : 0)) *
         (int)sizeof(float);
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int grid_x, int b, int smem,
           void* stream, const Args& a) {
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(grid_x, b * a.h);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// an operand (bf16 unless told) as TMA and the 16-byte loads need it: a
// 16-byte aligned base and (batch, seq, head) strides of whole 16 bytes
bool rows_aligned(const void* p, const Layout& l, int elem_bytes = 2) {
  const int n = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && l.sb % n == 0 &&
         l.ss % n == 0 && l.sh % n == 0;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// 4-D map (head dim, head, seq, batch) of one bf16 operand with boxes
// of `rows` rows x 64 in the 128-byte swizzle
int rows_map(CUtensorMap* map, const void* p, const Layout& l, int b, int h,
             int s, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)l.sh * 2, (cuuint64_t)l.ss * 2,
                                 (cuuint64_t)l.sb * 2};
  const cuuint32_t box[4] = {kD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_fwd_wgmma(const Args& a, int b, void* stream) {
  if (a.sq % kBlk || a.sk % kBlk || !(a.scale > 0.f) ||
      !rows_aligned(a.q, a.lq) ||
      !rows_aligned(a.k, a.lk) || !rows_aligned(a.v, a.lv))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int rc = rows_map(&tq, a.q, a.lq, b, a.h, a.sq, kBlk);
  if (rc == 0) rc = rows_map(&tk, a.k, a.lk, b, a.h, a.sk, kBlk);
  if (rc == 0) rc = rows_map(&tv, a.v, a.lv, b, a.h, a.sk, kBlk);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * a.h, a.sq / kBlk);
  flash_fwd_wgmma<<<grid, kWgThreads, kFwdSmem,
                    static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

int launch_bwd_dkv_wgmma(const Args& a, int b, void* stream) {
  if (a.sk % kBlk || a.sq % kBwdQ || !rows_aligned(a.q, a.lq) ||
      !rows_aligned(a.k, a.lk) || !rows_aligned(a.v, a.lv) ||
      !rows_aligned(a.dout, a.ldo) || !rows_aligned(a.dk, a.ldk) ||
      !rows_aligned(a.dv, a.ldv) || reinterpret_cast<uintptr_t>(a.lse) % 16 ||
      reinterpret_cast<uintptr_t>(a.dd) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int rc = rows_map(&tq, a.q, a.lq, b, a.h, a.sq, kBwdQ);
  if (rc == 0) rc = rows_map(&tk, a.k, a.lk, b, a.h, a.sk, kBlk);
  if (rc == 0) rc = rows_map(&tv, a.v, a.lv, b, a.h, a.sk, kBlk);
  if (rc == 0) rc = rows_map(&tdo, a.dout, a.ldo, b, a.h, a.sq, kBwdQ);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * a.h, a.sk / kBlk);
  flash_bwd_dkv_wgmma<<<grid, kWgThreads, kBwdSmem,
                        static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, tdo,
                                                             a);
  return (int)cudaGetLastError();
}

int launch_bwd_dq_wgmma(const Args& a, int b, void* stream) {
  if (a.sq % kBlk || a.sk % kDqK || !rows_aligned(a.q, a.lq) ||
      !rows_aligned(a.k, a.lk) || !rows_aligned(a.v, a.lv) ||
      !rows_aligned(a.dout, a.ldo) || !rows_aligned(a.dq, a.ldq) ||
      reinterpret_cast<uintptr_t>(a.lse) % 16 ||
      reinterpret_cast<uintptr_t>(a.dd) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  int rc = rows_map(&tq, a.q, a.lq, b, a.h, a.sq, kBlk);
  if (rc == 0) rc = rows_map(&tk, a.k, a.lk, b, a.h, a.sk, kDqK);
  if (rc == 0) rc = rows_map(&tv, a.v, a.lv, b, a.h, a.sk, kDqK);
  if (rc == 0) rc = rows_map(&tdo, a.dout, a.ldo, b, a.h, a.sq, kBlk);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * a.h, a.sq / kBlk);
  flash_bwd_dq_wgmma<<<grid, kWgThreads, kDqSmem,
                       static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, tdo,
                                                            a);
  return (int)cudaGetLastError();
}

Layout layout_at(const long long* s, int i) {
  return Layout{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// 0 when the shapes are ones the kernels were built for
int check(int b, int h, int sq, int sk, int d, int window, int dtype) {
  if (d != kD || sq <= 0 || sk <= 0 || sq % kTile || sk % kTile || b < 0 ||
      h <= 0 || window < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

Args base_args(int h, int sq, int sk, float scale, int causal, int window) {
  Args a = {};
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.scale = scale;
  a.causal = causal;
  a.window = causal ? window : 0;
  return a;
}

}  // namespace

// Every entry point returns the launch's cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for shapes the kernels were not
// built for and for bf16 operands that are not 16-byte aligned (base
// and every stride). `strides` holds (batch, seq, head) element strides
// of each tensor argument in order; the last dimension must be
// contiguous. dtype: 0 = float32, 1 = bfloat16. window: 0 = none.
// bf16 K1 takes sequence lengths that are multiples of 128 and a
// positive scale; bf16 K2 a kv_len that is a multiple of 128, bf16 K3
// a q_len that is one, and both lse and dd 16-byte aligned.

// K1. strides: q, k, v, out.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const long long* strides, int b, int h,
                                   int sq, int sk, int d, float scale,
                                   int causal, int window, int dtype,
                                   void* stream) {
  const int bad = check(b, h, sq, sk, d, window, dtype);
  if (bad) return bad;
  if (b == 0) return 0;
  Args a = base_args(h, sq, sk, scale, causal, window);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.lq = layout_at(strides, 0);
  a.lk = layout_at(strides, 1);
  a.lv = layout_at(strides, 2);
  a.lout = layout_at(strides, 3);
  if (dtype == 0)
    return launch(flash_fwd_kernel, kThreads, sq / kTile, b,
                  smem_bytes(4, false), stream, a);
  return launch_fwd_wgmma(a, b, stream);
}

// dynamic shared memory of the bf16 K1 launch, in bytes
extern "C" int flash_attention_fwd_smem_bytes() { return kFwdSmem; }

// K2. strides: q, k, v, dout, dk, dv.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* dd,
                                       void* dk, void* dv,
                                       const long long* strides, int b,
                                       int h, int sq, int sk, int d,
                                       float scale, int causal, int window,
                                       int dtype, void* stream) {
  const int bad = check(b, h, sq, sk, d, window, dtype);
  if (bad) return bad;
  if (b == 0) return 0;
  Args a = base_args(h, sq, sk, scale, causal, window);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dd = static_cast<const float*>(dd);
  a.dk = dk;
  a.dv = dv;
  a.lq = layout_at(strides, 0);
  a.lk = layout_at(strides, 1);
  a.lv = layout_at(strides, 2);
  a.ldo = layout_at(strides, 3);
  a.ldk = layout_at(strides, 4);
  a.ldv = layout_at(strides, 5);
  if (dtype == 0)
    return launch(flash_bwd_dkv_kernel, kThreads, sk / kTile, b,
                  smem_bytes(6, true), stream, a);
  return launch_bwd_dkv_wgmma(a, b, stream);
}

// dynamic shared memory of the bf16 K2 launch, in bytes
extern "C" int flash_attention_bwd_dkv_smem_bytes() { return kBwdSmem; }

// K3. strides: q, k, v, dout, dq.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dd,
                                      void* dq, const long long* strides,
                                      int b, int h, int sq, int sk, int d,
                                      float scale, int causal, int window,
                                      int dtype, void* stream) {
  const int bad = check(b, h, sq, sk, d, window, dtype);
  if (bad) return bad;
  if (b == 0) return 0;
  Args a = base_args(h, sq, sk, scale, causal, window);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dd = static_cast<const float*>(dd);
  a.dq = dq;
  a.lq = layout_at(strides, 0);
  a.lk = layout_at(strides, 1);
  a.lv = layout_at(strides, 2);
  a.ldo = layout_at(strides, 3);
  a.ldq = layout_at(strides, 4);
  if (dtype == 0)
    return launch(flash_bwd_dq_kernel, kThreads, sq / kTile, b,
                  smem_bytes(5, true), stream, a);
  return launch_bwd_dq_wgmma(a, b, stream);
}

// dynamic shared memory of the bf16 K3 launch, in bytes
extern "C" int flash_attention_bwd_dq_smem_bytes() { return kDqSmem; }

// dd = rowsum(dO * O) in f32 into dd, [B, H, Sq] contiguous. strides:
// dout, out; both need a 16-byte aligned base and strides of whole 16
// bytes, f32 or bf16 alike.
extern "C" int flash_attention_row_dot(const void* dout, const void* out,
                                       void* dd, const long long* strides,
                                       int b, int h, int sq, int d,
                                       int dtype, void* stream) {
  if (d != kD || b < 0 || h <= 0 || sq <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Layout ldo = layout_at(strides, 0), lout = layout_at(strides, 1);
  const int elem_bytes = dtype == 0 ? 4 : 2;
  if (!rows_aligned(dout, ldo, elem_bytes) ||
      !rows_aligned(out, lout, elem_bytes) ||
      (long long)b * h * sq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rows = b * h * sq;
  if (rows == 0) return 0;
  const int grid = (rows + kDotRows - 1) / kDotRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const o = static_cast<float*>(dd);
  if (dtype == 0)
    row_dot_kernel<float><<<grid, kDotThreads, 0, s>>>(
        static_cast<const float*>(dout), static_cast<const float*>(out), ldo,
        lout, o, h, sq, rows);
  else
    row_dot_kernel<bf16><<<grid, kDotThreads, 0, s>>>(
        static_cast<const bf16*>(dout), static_cast<const bf16*>(out), ldo,
        lout, o, h, sq, rows);
  return (int)cudaGetLastError();
}
