// Fused paged attention for Hopper (sm_90a): gather-and-attend straight
// out of the paged KV pool through the block table, online softmax over
// pool blocks.
//
// Replaces the Pallas TPU kernel `_paged_attn_kernel`
// (paddle_tpu/nn/paged_attention.py:248). It computes what that kernel
// computes, in both of its forms: decode (C == 1 query per lane) and
// prefill chunk (C queries per lane at positions qpos[b, c]).
//
// What bounds it: bytes. Decode at 8 lanes reads every live K/V row of
// every lane once and does about 2 FLOP per byte read (one multiply-add
// per element for q.k, one for p.v), two orders of magnitude below the
// card's ridge point. The chunk form reuses each K/V row for up to 4
// query rows of a tile and is still far from the tensor-core limit.
//
// What the design does about it:
//   * each K/V pool row is read from device memory once per (lane,
//     kv-head, row tile), with 16-byte loads, and staged in shared
//     memory as f32, where every query row of the tile reuses it (GQA
//     groups and chunk queries are packed into the rows of one CUDA
//     block, as the TPU kernel packs rep * C rows into one tile);
//   * the eight warps of a block walk disjoint pool blocks (warp w takes
//     blocks j_begin + w, j_begin + w + 8, ...), each with its own
//     running (m, l, acc), so eight block loads are in flight per CUDA
//     block instead of one; the partial states are merged at the end
//     with the same rescaling the online softmax uses;
//   * the walk stops at the lane's last attended block and, with a
//     window, starts at the first one: fully masked blocks are never
//     read (skipping them is exact, see below);
//   * the gathered [B, Hkv, nblk * BS, D] view never exists.
// Later work (not here): split-K across CUDA blocks for small batches,
// cp.async/TMA double buffering, wgmma for the chunk form.
//
// Layout and grid. One CUDA block per (lane b, kv-head h, tile of
// kRowTile query rows); the TPU grid's sequential block dimension is the
// walk over j inside the block. Row i of the rep * C rows is (group r,
// query c) with c minor; its position is qpos[b, i % C]. q and out are
// f32 [B, Hkv, rep * C, D]; pools are [NB, Hkv, BS, D] f32 or bf16;
// tables [B, nblk] and qpos [B, C] are int32.
//
// Shapes: built for the serving path's GPT-2 small head_dim (D = 64) and
// pool blocks of at most 16 keys (the path uses 16), so two lanes of a
// warp share each key, each taking half of its q.k product. Any other
// head_dim or block size is rejected at the entry point.
//
// NaN contract (that of _lax_core, paddle_tpu/nn/paged_attention.py):
//   * masked scores are -inf before the max (a masked NaN never counts);
//   * shift = 0 while the running max is -inf (no inf - inf);
//   * V rows that no row of the lane keeps are zeroed before p.V, so
//     scratch-block garbage cannot leak through 0 * nan;
//   * the max propagates NaN (fmaxf would drop it), so an attended NaN
//     reaches the output; the merge of the warps' states keeps it too
//     (a NaN max or accumulator survives every rescale);
//   * out = (l == 0) ? 0 : acc / l.
// Build without --use_fast_math: it changes expf and isnan.
//
// A block that every row of the lane masks contributes nothing: its
// scores are -inf, so m and l are unchanged, alpha is 1 (or 0 while m is
// -inf, when acc is still 0) and its V rows are zeroed. Skipping such
// blocks, or giving them to another warp, therefore gives the same
// result up to the order of the sums.
//
// The kernel allocates nothing; the caller allocates `out`.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowTile = 4;
constexpr int kHeadDim = 64;
constexpr int kMaxBlockSize = 16;  // one key per half-warp lane pair
constexpr int kStaticSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// 16 bytes of pool -> f32 values (4 for f32 pools, 8 for bf16 pools)
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// q.k over N values from shared memory, four partial sums in flight
template <int N>
__device__ __forceinline__ float dot_product(const float* a,
                                             const float* b) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < N; d += 4) {
#pragma unroll
    for (int t = 0; t < 4; ++t) part[t] += a[d + t] * b[d + t];
  }
  return (part[0] + part[1]) + (part[2] + part[3]);
}

// per-warp staging: K (rows padded to d + 1), V, keep flags, and the
// probabilities of the tile's rows
__host__ __device__ constexpr int staging_floats(int bs, int d) {
  return bs * (2 * d + 1) + kMaxBlockSize + kRowTile * 32;
}

// Dynamic shared memory of one CUDA block, in bytes.
__host__ int smem_bytes(int bs, int d) {
  const int stage = kWarps * staging_floats(bs, d);
  const int merge = kWarps * kRowTile * (d + 2);
  return (kRowTile * d + kRowTile + (stage > merge ? stage : merge)) * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* __restrict__ q, const T* __restrict__ pk,
                  const T* __restrict__ pv, const int* __restrict__ tables,
                  const int* __restrict__ qpos, float* __restrict__ out,
                  int hkv, int rows, int c, int bs, int nblk, int nb,
                  float scale, int use_window, int window) {
  constexpr int D = kHeadDim;
  constexpr int kDPerLane = D / 32;
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* q_s = smem;                                     // [kRowTile][D]
  int* qp_s = reinterpret_cast<int*>(q_s + kRowTile * D);  // [kRowTile]
  float* area = q_s + kRowTile * D + kRowTile;
  __shared__ int range_s[2];

  const int bh = blockIdx.x;  // b * hkv + h
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int row0 = blockIdx.y * kRowTile;
  const int rows_here = min(kRowTile, rows - row0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int* lane_qpos = qpos + (size_t)b * c;

  for (int idx = tid; idx < kRowTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    q_s[idx] = r < rows_here ? q[((size_t)bh * rows + row0 + r) * D + d]
                             : 0.f;
  }
  if (tid < kRowTile)
    qp_s[tid] = tid < rows_here ? lane_qpos[(row0 + tid) % c] : 0;
  // the lane's attended key range over all C queries -> blocks to walk
  if (warp == 0) {
    int hi = INT_MIN, lo = INT_MAX;
    for (int i = lane; i < c; i += 32) {
      const int p = lane_qpos[i];
      hi = max(hi, p);
      lo = min(lo, p);
    }
    hi = warp_max_int(hi);
    lo = warp_min_int(lo);
    if (lane == 0) {
      const int j_end = hi < 0 ? 0 : min(nblk, hi / bs + 1);
      int j_begin = 0;
      if (use_window && window > 0) {
        const long long first = (long long)lo - window + 1;
        if (first > 0) {
          const long long jb = first / bs;
          j_begin = jb < j_end ? (int)jb : j_end;
        }
      }
      range_s[0] = j_begin;
      range_s[1] = j_end;
    }
  }
  __syncthreads();
  const int j_begin = range_s[0];
  const int j_end = range_s[1];

  float* k_s = area + warp * staging_floats(bs, D);  // [bs][D + 1]
  float* v_s = k_s + bs * (D + 1);                    // [bs][D]
  int* keep_s = reinterpret_cast<int*>(v_s + bs * D);  // [kMaxBlockSize]
  float* p_s = v_s + bs * D + kMaxBlockSize;          // [kRowTile][32]

  // lanes l and l + 16 share key l: each takes half of the q.k product
  const int key = lane & 15;
  const int d0 = (lane >> 4) * (D / 2);

  float m[kRowTile], l[kRowTile], acc[kRowTile][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[r][e] = 0.f;
  }

  for (int j = j_begin + warp; j < j_end; j += kWarps) {
    int blk = tables[(size_t)b * nblk + j];
    blk = min(max(blk, 0), nb - 1);  // memory safety only: ids come from
                                     // the host allocator, in range
    const size_t base = ((size_t)blk * hkv + h) * bs * D;
    if (lane < bs) {
      const int ks = j * bs + lane;
      int any = 0;
      for (int i = 0; i < c && !any; ++i) {
        const int p = lane_qpos[i];
        any = ks <= p && (!use_window || ks > p - window);
      }
      keep_s[lane] = any;
    }
    __syncwarp();
    for (int v = lane; v < bs * D / kVec; v += 32) {
      const int idx = v * kVec;
      const int s = idx / D, d = idx % D;
      float kt[kVec], vt[kVec];
      load16(pk + base + idx, kt);
      load16(pv + base + idx, vt);
      // V rows no row of the lane keeps are zeroed (0 * nan == nan)
      const bool kept = keep_s[s];
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        k_s[s * (D + 1) + d + t] = kt[t];
        v_s[s * D + d + t] = kept ? vt[t] : 0.f;
      }
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      if (r >= rows_here) break;  // uniform across the warp
      const int p_row = qp_s[r];
      const int ks = j * bs + key;
      const bool keep = key < bs && ks <= p_row &&
                        (!use_window || ks > p_row - window);
      float dot = 0.f;
      if (keep) {
        const float* qr = q_s + r * D + d0;
        const float* kr = k_s + key * (D + 1) + d0;
        dot = dot_product<D / 2>(qr, kr);
      }
      dot += __shfl_xor_sync(kFull, dot, 16);
      const float s = (lane < bs && keep) ? dot * scale : -INFINITY;
      const float m_new = nan_max(m[r], warp_max(s));
      const float shift = isfinite(m_new) ? m_new : 0.f;
      const float p = expf(s - shift);
      const float alpha = expf(m[r] - shift);
      l[r] = alpha * l[r] + warp_sum(p);
      p_s[r * 32 + lane] = p;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) {
        const int d = lane + 32 * e;
        float pv_acc = 0.f;
#pragma unroll 8
        for (int s2 = 0; s2 < bs; ++s2)
          pv_acc += p_s[r * 32 + s2] * v_s[s2 * D + d];
        acc[r][e] = alpha * acc[r][e] + pv_acc;
      }
      m[r] = m_new;
    }
    __syncwarp();
  }

  // merge the warps' (m, l, acc) per row: the online-softmax
  // rescale against the common max
  __syncthreads();  // staging area is reused below
  float* cm = area;                                 // [kWarps][kRowTile]
  float* cl = cm + kWarps * kRowTile;               // [kWarps][kRowTile]
  float* cacc = cl + kWarps * kRowTile;             // [kWarps][kRowTile][D]
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    if (r >= rows_here) break;
    if (lane == 0) {
      cm[warp * kRowTile + r] = m[r];
      cl[warp * kRowTile + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e)
      cacc[(warp * kRowTile + r) * D + lane + 32 * e] = acc[r][e];
  }
  __syncthreads();
  for (int r = warp; r < rows_here; r += kWarps) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = nan_max(mx, cm[w * kRowTile + r]);
    const float shift = isfinite(mx) ? mx : 0.f;
    float lsum = 0.f, o[kDPerLane];
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(cm[w * kRowTile + r] - shift);
      lsum += wt * cl[w * kRowTile + r];
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e)
        o[e] += wt * cacc[(w * kRowTile + r) * D + lane + 32 * e];
    }
    float* dst = out + ((size_t)bh * rows + row0 + r) * D;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e)
      dst[lane + 32 * e] = lsum == 0.f ? 0.f : o[e] / lsum;
  }
}

template <typename T>
int launch(int b, int hkv, cudaStream_t stream, const void* q,
           const void* pk, const void* pv, const void* tables,
           const void* qpos, void* out, int rows, int c, int bs, int nblk,
           int nb, float scale, int use_window, int window) {
  const dim3 grid(b * hkv, (rows + kRowTile - 1) / kRowTile);
  const int smem = smem_bytes(bs, kHeadDim);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(tables),
      static_cast<const int*>(qpos), static_cast<float*>(out), hkv, rows, c,
      bs, nblk, nb, scale, use_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 pools, 1 = bfloat16 pools. Returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape the kernel was not built for (head_dim 64, block size 1..16).
// Pools must be 16-byte aligned.
extern "C" int paged_attention_fwd(const void* q, const void* pk,
                                   const void* pv, const void* tables,
                                   const void* qpos, void* out, int b,
                                   int hkv, int rows, int c, int d, int bs,
                                   int nblk, int nb, float scale,
                                   int use_window, int window, int dtype,
                                   void* stream) {
  if (d != kHeadDim || bs < 1 || bs > kMaxBlockSize || c < 1 || nb < 1 ||
      nblk < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || hkv == 0 || rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(b, hkv, st, q, pk, pv, tables, qpos, out, rows, c,
                         bs, nblk, nb, scale, use_window, window);
  if (dtype == 1)
    return launch<__nv_bfloat16>(b, hkv, st, q, pk, pv, tables, qpos, out,
                                 rows, c, bs, nblk, nb, scale, use_window,
                                 window);
  return (int)cudaErrorInvalidValue;
}
