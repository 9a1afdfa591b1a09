// Fused paged attention for Hopper (sm_90a): gather-and-attend straight
// out of the paged KV pool through the block table, online softmax over
// pool blocks, split across CUDA blocks along the keys (flash-decoding)
// and finished by a small combine kernel.
//
// Replaces the Pallas TPU kernel `_paged_attn_kernel`
// (paddle_tpu/nn/paged_attention.py:248). It computes what that kernel
// computes, in both of its forms: decode (C == 1 query per lane) and
// prefill chunk (C queries per lane at positions start[b] + c).
//
// What bounds it: bytes, in both forms. Decode at 8 lanes reads every
// live K/V row of every lane once (14 MB at the serving shapes) and does
// about 2 FLOP per byte; the 64-query chunk reuses each K/V row for 64
// query rows, 128 FLOP per byte, still below the card's ridge point of
// about 295. The time to beat at these sizes is latency: 96 (lane,
// kv-head) pairs are fewer than the card's 132 SMs.
//
// What the design does about it:
//   * split-K: one CUDA block per (lane b, kv-head h, split s, row tile);
//     split s covers pool blocks [s P, (s + 1) P) of the lane's table
//     (P = `split`, set by the caller: 8 pool blocks up to 8 rows a
//     (lane, kv-head) and 4 past that, whose 64-row tiles make fewer
//     CUDA blocks). The
//     split count comes from the table width, never from the positions,
//     so the host never waits on the device: a split that lies wholly
//     outside the lane's attended range writes the empty state
//     (m = -inf, l = 0, acc = 0) and exits. Each split writes its
//     unnormalised (acc, m, l) in f32 to a workspace [B, Hkv, S, rows,
//     D + 2], and `paged_attn_combine` merges the S states of each row
//     with the online-softmax rescale and writes the output;
//   * decode and short row counts (rows = rep * C <= 4 with bf16 q and
//     pools, <= 8 with f32 q over bf16 pools; f32 pools at any row
//     count, in tiles of at most 4 rows), `paged_attn_split_kernel`:
//     four warps walk disjoint pool blocks of
//     the split; each warp loads its block's table entries at once, then
//     keeps the next pool block's K/V loads in flight (a register double
//     buffer of 16-byte loads) while it scores the current one; bf16
//     stays bf16 until it is used, and the warps' states merge in shared
//     memory. An 8-row tile of bf16 pools and a 4-row tile of f32 ones
//     hold accumulators that leave room for one pool block's K/V per
//     warp: there a warp loads and scores one block at a time. The
//     per-row positions are int32 (the double buffer with 64-bit
//     positions spilled 1080 bytes at bf16 8 rows, 12 at f32 4 rows);
//   * bf16 pools and q past 4 rows (the prefill chunk; the speculative
//     verify at C = k + 1 = 5..8; GQA decode at rep 5..8),
//     `paged_attn_chunk_mma`: 64 query rows per CUDA block, 16 per warp;
//     each pool block's K and V (16 x 64 bf16, 2 KB each) is staged once
//     per CUDA block into shared memory by cp.async in a 3-stage ring and
//     reused by all 64 rows; QK^T and P.V run on mma.sync m16n8k16
//     (ldmatrix.trans for V), P rounded to bf16 for the second product
//     as the flash kernels round it; the causal and window mask is
//     applied only on pool blocks that cross a row's diagonal or window
//     edge. wgmma needs 64-row warpgroup tiles and TMA wants tiles larger
//     than the scattered 2 KB pool blocks, so mma.sync with cp.async is
//     the first design here;
//   * f32 pools stay on the CUDA cores (mma.sync has no exact f32): the
//     split kernel takes them at any row count, re-reading K/V once per
//     4-row tile;
//   * blocks outside a lane's attended range (past its last key, before
//     its window) are never read (skipping them is exact, see below),
//     and the gathered [B, Hkv, nblk * BS, D] view never exists.
//
// Layout. q is read in place through its element strides (batch, head,
// query) with a contiguous head dim, f32 or bf16 (`_split_heads` gives a
// strided view of the [B, S, 3, H, D] projection). Row i of the rep * C
// rows of (b, h) is (group r, query c) with c minor, head h * rep + r,
// position start[b] + c; `start` is a device pointer to [B] int32 or
// int64 (stride 0 for one shared value) or a scalar. Pools are
// [NB, Hkv, BS, D] f32 or bf16, tables [B, nblk] int32. The output is
// [B, C, H, D] in the pool dtype (the caller views it as [B, H, C, D]);
// f32 -> bf16 rounds to nearest even, as Tensor.to does.
//
// Shapes: head_dim 64 and pool blocks of 1..16 keys (the serving path
// uses 16); anything else is rejected at the entry point.
//
// NaN contract (that of _lax_core, paddle_tpu/nn/paged_attention.py):
//   * masked scores are -inf before the max (a masked NaN never counts);
//   * shift = 0 while the running max is -inf (no inf - inf);
//   * V rows that no row of the lane keeps are zeroed before p.V, so
//     scratch-block garbage cannot leak through 0 * nan;
//   * the max propagates NaN (fmaxf would drop it), so an attended NaN
//     reaches the output; the merges of warp and split states keep it
//     (a NaN max or accumulator survives every rescale, and the shift is
//     0 while the merged max is -inf);
//   * out = (l == 0) ? 0 : acc / l.
// Build without --use_fast_math: it changes expf and isnan.
//
// A block that every row of the lane masks contributes nothing: its
// scores are -inf, so m and l are unchanged, alpha is 1 (or 0 while m is
// -inf, when acc is still 0) and its V rows are zeroed. Skipping such
// blocks, or giving them to another warp or split, therefore gives the
// same result up to the order of the sums.
//
// The kernels allocate nothing; the caller allocates the output and the
// workspace.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxBlockSize = 16;
constexpr int kStateLd = kHeadDim + 2;  // one row's state: acc[D], m, l
constexpr int kSplitWarps = 4;
constexpr int kMaxSplit = 32 * kSplitWarps;  // pool blocks per split
constexpr int kSplitRows = 8;  // rows the split kernel takes per block
// bf16 q and pools with more rows than this take the tensor cores: at the
// speculative verify's 5 rows the mma kernel (16-row fragments, 5 live)
// ran in half the split kernel's time on the card (PERF.md)
constexpr int kMaxSplitRowsBf16 = 4;
// the split kernel's per-row positions are int32: a lane start is clamped
// to +-kPosLimit. Tables hold fewer than kPosLimit keys and windows are
// at most kPosLimit / 2 (checked at the entry point), so a start past the
// limit walks no block (split_blocks, in 64 bits) and the clamp changes
// no result.
constexpr int kPosLimit = 1 << 30;
constexpr int kChunkRows = 64;  // rows of a tensor-core CUDA block
constexpr int kChunkThreads = 128;
constexpr int kLdh = kHeadDim + 8;  // bf16 row stride in shared memory
constexpr int kStages = 3;          // cp.async ring of pool blocks
constexpr int kCombineWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

struct Args {
  const void* q;
  long long qsb, qsh, qsc;  // q element strides: batch, head, query
  const void* pk;
  const void* pv;
  const int* tables;
  const void* start;  // [B] int32 / int64, or null for start_scalar
  long long start_scalar;
  int start_elt;      // bytes per start element (4 or 8)
  int start_stride;   // 0: one value for every lane
  void* out;          // [B, C, H, D], pool dtype
  float* work;        // [B, Hkv, S, rows, D + 2] f32
  int h, hkv, rep, c, rows, bs, nblk, nb, split, nsplit;
  float scale;
  int use_window, window;
  int q_bf16;
};

__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ long long lane_start(const Args& a, int b) {
  if (a.start == nullptr) return a.start_scalar;
  const long long i = (long long)b * a.start_stride;
  return a.start_elt == 8 ? static_cast<const long long*>(a.start)[i]
                          : (long long)static_cast<const int*>(a.start)[i];
}

// key ks attended by the query at position p
__device__ __forceinline__ bool kept(const Args& a, long long ks,
                                     long long p) {
  return ks <= p && (!a.use_window || ks > p - a.window);
}

// kept() in 32-bit arithmetic, for the split kernel's registers: ks >= 0
// and |p| <= kPosLimit + C (see split_start), so nothing overflows
__device__ __forceinline__ bool kept32(const Args& a, int ks, int p) {
  return ks <= p && (!a.use_window || p - ks < a.window);
}

// key ks attended by some query of a lane whose queries sit at
// st .. st + C - 1 (the union of their bands)
__device__ __forceinline__ bool kept_any(const Args& a, long long ks,
                                         long long st) {
  if (a.use_window && a.window <= 0) return false;
  return ks <= st + a.c - 1 && (!a.use_window || ks > st - a.window);
}

// the pool blocks [begin, end) of split `split` that the lane attends
__device__ __forceinline__ void split_blocks(const Args& a, long long st,
                                             int split, int* begin,
                                             int* end) {
  const long long hi = st + a.c - 1;  // the last key any query attends
  const int j_end =
      hi < 0 ? 0 : (int)min((long long)a.nblk, hi / a.bs + 1);
  int j_begin = 0;
  if (a.use_window && a.window > 0) {
    const long long first = st - a.window + 1;
    if (first > 0) j_begin = (int)min((long long)j_end, first / a.bs);
  }
  *begin = max(j_begin, split * a.split);
  *end = min(j_end, (split + 1) * a.split);
}

__device__ __forceinline__ int pool_block(const Args& a, int b, int j) {
  const int blk = a.tables[(size_t)b * a.nblk + j];
  return min(max(blk, 0), a.nb - 1);  // memory safety only: ids come from
                                      // the host allocator, in range
}

// element offset of row `row` of (b, kv-head h): head h * rep + row / C,
// query row % C
__device__ __forceinline__ long long q_offset(const Args& a, int b, int h,
                                              int row) {
  return (long long)b * a.qsb + (long long)(h * a.rep + row / a.c) * a.qsh +
         (long long)(row % a.c) * a.qsc;
}

__device__ __forceinline__ float load_q(const Args& a, int b, int h, int row,
                                        int d) {
  const long long off = q_offset(a, b, h, row) + d;
  return a.q_bf16 ? __bfloat162float(static_cast<const bf16*>(a.q)[off])
                  : static_cast<const float*>(a.q)[off];
}

// the state of a split that attends no key: m = -inf, l = 0, acc = 0
__device__ __forceinline__ void write_empty(float* work, int rows_here,
                                            int nthreads) {
  for (int i = threadIdx.x; i < rows_here * kStateLd; i += nthreads)
    work[i] = i % kStateLd == kHeadDim ? -INFINITY : 0.f;
}

// 16 bytes of pool -> f32 values (4 for f32 pools, 8 for bf16 pools)
__device__ __forceinline__ void unpack(const uint4& v, float (&o)[4]) {
  o[0] = __uint_as_float(v.x);
  o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z);
  o[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float (&o)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// split kernel on the CUDA cores: decode, short row counts, f32
// ---------------------------------------------------------------------------
//
// A warp reads a pool block (bs <= 16 rows of 64 values) as 16-byte
// vectors: lane l holds rows l / kVr + kRp * i (i < kNp), values
// (l % kVr) * kVec .. + kVec. A score is the sum over the kVr lanes of a
// row; the p.V partial sums stay per lane until the end of the walk.

template <typename T>
struct Geometry {
  static constexpr int kVec = 16 / sizeof(T);        // values per vector
  static constexpr int kVr = kHeadDim / kVec;        // lanes per key row
  static constexpr int kRp = 32 / kVr;               // key rows per pass
  static constexpr int kNp = kMaxBlockSize / kRp;    // passes per block
};

template <typename T>
struct Tile {
  uint4 k[Geometry<T>::kNp];
  uint4 v[Geometry<T>::kNp];
};

template <typename T>
__device__ __forceinline__ void load_block(const Args& a, Tile<T>& t,
                                           int blk, int h, int lane) {
  using G = Geometry<T>;
  const size_t base = ((size_t)blk * a.hkv + h) * a.bs * kHeadDim +
                      (lane % G::kVr) * G::kVec;
  const uint4* pk = reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.pk) + base);
  const uint4* pv = reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.pv) + base);
#pragma unroll
  for (int i = 0; i < G::kNp; ++i) {
    const int row = lane / G::kVr + G::kRp * i;
    if (row < a.bs) {
      t.k[i] = __ldg(pk + row * (kHeadDim / G::kVec));
      t.v[i] = __ldg(pv + row * (kHeadDim / G::kVec));
    } else {
      t.k[i] = make_uint4(0, 0, 0, 0);
      t.v[i] = make_uint4(0, 0, 0, 0);
    }
  }
}

template <typename T, int NR>
__device__ __forceinline__ void score_block(
    const Args& a, const Tile<T>& t, int j, long long st, const int (&qp)[NR],
    const float (*q_s)[kHeadDim], int lane, float (&m)[NR], float (&l)[NR],
    float (&acc)[NR][Geometry<T>::kVec]) {
  using G = Geometry<T>;
  constexpr int kVec = G::kVec;
  const int d0 = (lane % G::kVr) * kVec;
  int ks[G::kNp];
  bool in_block[G::kNp];
#pragma unroll
  for (int i = 0; i < G::kNp; ++i) {
    const int row = lane / G::kVr + G::kRp * i;
    in_block[i] = row < a.bs;
    ks[i] = j * a.bs + row;
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float q[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) q[e] = q_s[r][d0 + e];
    float s[G::kNp];
    float bmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < G::kNp; ++i) {
      float kf[kVec];
      unpack(t.k[i], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot = fmaf(q[e], kf[e], dot);
#pragma unroll
      for (int o = 1; o < G::kVr; o <<= 1)
        dot += __shfl_xor_sync(kFull, dot, o);
      s[i] = in_block[i] && kept32(a, ks[i], qp[r]) ? dot * a.scale
                                                    : -INFINITY;
      bmax = nan_max(bmax, s[i]);
    }
#pragma unroll
    for (int o = G::kVr; o < 32; o <<= 1)
      bmax = nan_max(bmax, __shfl_xor_sync(kFull, bmax, o));
    const float m_new = nan_max(m[r], bmax);
    const float shift = isfinite(m_new) ? m_new : 0.f;
    const float alpha = expf(m[r] - shift);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] *= alpha;
#pragma unroll
    for (int i = 0; i < G::kNp; ++i) {
      const float p = expf(s[i] - shift);
      psum += p;
      float vf[kVec];
      unpack(t.v[i], vf);
      // V rows no row of the lane keeps are zeroed (0 * nan == nan)
      const bool keep_v = kept_any(a, ks[i], st);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[r][e] = fmaf(p, keep_v ? vf[e] : 0.f, acc[r][e]);
    }
#pragma unroll
    for (int o = G::kVr; o < 32; o <<= 1)
      psum += __shfl_xor_sync(kFull, psum, o);
    l[r] = alpha * l[r] + psum;
    m[r] = m_new;
  }
}

// a warp keeps two pool blocks' K/V in registers (the next one loading
// while the current one is scored) where ptxas fits them beside the
// rows' accumulators: bf16 up to 4 rows, f32 (whose tiles take twice the
// registers) up to 2. With two tiles, bf16 at 8 rows spilled 1080 bytes
// and f32 at 4 rows 12 bytes.
template <typename T, int NR>
constexpr bool kDoubleBuffer = NR <= (sizeof(T) == 2 ? 4 : 2);

template <typename T, int NR>
__global__ void __launch_bounds__(kSplitWarps * 32)
paged_attn_split_kernel(const Args a) {
  using G = Geometry<T>;
  constexpr int kVec = G::kVec;
  constexpr int kThreads = kSplitWarps * 32;
  __shared__ float q_s[NR][kHeadDim];
  __shared__ float merge_s[kSplitWarps][NR][kStateLd];

  const int bh = blockIdx.x;  // b * hkv + h
  const int b = bh / a.hkv, h = bh % a.hkv;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * NR;
  const int rows_here = min(NR, a.rows - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* work = a.work +
                (((size_t)bh * a.nsplit + split) * a.rows + row0) * kStateLd;

  // loads that need not wait for the lane's start: this warp's table
  // entries (pool blocks jw + kSplitWarps * k of the split; lane k holds
  // the k-th) and the q rows
  const int jw = split * a.split + warp;
  const int jend = min(a.nblk, (split + 1) * a.split);
  const int my_blk = jw + kSplitWarps * lane < jend
                         ? pool_block(a, b, jw + kSplitWarps * lane)
                         : 0;
  for (int i = threadIdx.x; i < NR * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    q_s[r][d] = r < rows_here ? load_q(a, b, h, row0 + r, d) : 0.f;
  }
  const long long st = lane_start(a, b);
  int j0, j1;
  split_blocks(a, st, split, &j0, &j1);
  if (j0 >= j1) {  // uniform over the block
    write_empty(work, rows_here, kThreads);
    return;
  }
  const int st32 =
      (int)max(min(st, (long long)kPosLimit), -(long long)kPosLimit);
  int qp[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r)  // rows past the call's end attend nothing
    qp[r] = r < rows_here ? st32 + (row0 + r) % a.c : INT_MIN / 2;
  // the warp's blocks the lane attends: k in [k0, k1)
  const int k0 = j0 > jw ? (j0 - jw + kSplitWarps - 1) / kSplitWarps : 0;
  const int k1 = j1 > jw ? (j1 - jw + kSplitWarps - 1) / kSplitWarps : 0;
  __syncthreads();

  float m[NR], l[NR], acc[NR][kVec];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  }
  if constexpr (kDoubleBuffer<T, NR>) {
    // the next block's loads are issued before the current block's math
    Tile<T> ta, tb;
    if (k0 < k1)
      load_block<T>(a, ta, __shfl_sync(kFull, my_blk, k0), h, lane);
    for (int k = k0; k < k1; k += 2) {
      if (k + 1 < k1)
        load_block<T>(a, tb, __shfl_sync(kFull, my_blk, k + 1), h, lane);
      score_block<T, NR>(a, ta, jw + kSplitWarps * k, st, qp, q_s, lane, m,
                         l, acc);
      if (k + 1 >= k1) break;
      if (k + 2 < k1)
        load_block<T>(a, ta, __shfl_sync(kFull, my_blk, k + 2), h, lane);
      score_block<T, NR>(a, tb, jw + kSplitWarps * (k + 1), st, qp, q_s,
                         lane, m, l, acc);
    }
  } else {
    // one register tile; the other warps of the CUDA block hide the
    // load latency
    Tile<T> t;
    for (int k = k0; k < k1; ++k) {
      load_block<T>(a, t, __shfl_sync(kFull, my_blk, k), h, lane);
      score_block<T, NR>(a, t, jw + kSplitWarps * k, st, qp, q_s, lane, m,
                         l, acc);
    }
  }

  // the lanes of a value column sum their rows' p.V
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
#pragma unroll
      for (int o = G::kVr; o < 32; o <<= 1)
        acc[r][e] += __shfl_xor_sync(kFull, acc[r][e], o);
  if (lane < G::kVr) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        merge_s[warp][r][lane * kVec + e] = acc[r][e];
      if (lane == 0) {
        merge_s[warp][r][kHeadDim] = m[r];
        merge_s[warp][r][kHeadDim + 1] = l[r];
      }
    }
  }
  __syncthreads();
  // merge the warps' states against their common max
  for (int i = threadIdx.x; i < rows_here * kStateLd; i += kThreads) {
    const int r = i / kStateLd, d = i % kStateLd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mx = nan_max(mx, merge_s[w][r][kHeadDim]);
    const float shift = isfinite(mx) ? mx : 0.f;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = expf(merge_s[w][r][kHeadDim] - shift);
      v += wt * merge_s[w][r][d == kHeadDim ? kHeadDim + 1 : d];
    }
    work[i] = d == kHeadDim ? mx : v;
  }
}

// ---------------------------------------------------------------------------
// chunk kernel on the tensor cores: bf16 q and pools, rows > 4
// ---------------------------------------------------------------------------
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate); 4 warps, warp w owns rows
// [16 w, 16 w + 16) of the block's 64-row tile. Fragment layout (PTX
// ISA, lane = 4 g + t):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..);
//   B 16x8 col-major:  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C 16x8 f32:        c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1).
// The C fragments of the two 8-key tiles of S are the A fragment of the
// 16-deep P.V step. Tiles are bf16 rows of 72 elements, so the 32-bit
// fragment loads and ldmatrix's 16-byte rows hit distinct banks.

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 at tile[row][col], col even
__device__ __forceinline__ uint32_t ld2(const bf16* tile, int row, int col) {
  return *reinterpret_cast<const uint32_t*>(tile + row * kLdh + col);
}

// (lo, hi) rounded to bf16 (nearest even) and packed, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 bf16 matrices, transposed: lanes 8 m .. 8 m + 7 give the row
// addresses of matrix m; register m of lane 4 g + t gets its elements
// (row 2t, column g) and (row 2t + 1, column g), the first in the low half
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, zero-filled past src_bytes (0 or 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one pool block's K and V rows into a ring stage: 2 x 16 rows of 8
// 16-byte pieces, one K and one V piece per thread. Rows past the block
// size are zero-filled, and so are the V rows no row of the lane keeps.
__device__ __forceinline__ void issue_block(const Args& a, bf16* k_s,
                                            bf16* v_s, int blk, int h, int j,
                                            long long st) {
  const int row = threadIdx.x / 8, col = (threadIdx.x % 8) * 8;
  const size_t base = ((size_t)blk * a.hkv + h) * a.bs * kHeadDim;
  const bool in_block = row < a.bs;
  const size_t off = base + (in_block ? row * kHeadDim + col : 0);
  const bf16* pk = static_cast<const bf16*>(a.pk) + off;
  const bf16* pv = static_cast<const bf16*>(a.pv) + off;
  const bool keep_v = in_block && kept_any(a, (long long)j * a.bs + row, st);
  cp_async16(k_s + row * kLdh + col, pk, in_block ? 16 : 0);
  cp_async16(v_s + row * kLdh + col, pv, keep_v ? 16 : 0);
}

__global__ void __launch_bounds__(kChunkThreads)
paged_attn_chunk_mma(const Args a) {
  __shared__ __align__(16) bf16 q_s[kChunkRows * kLdh];
  __shared__ __align__(16) bf16 kv_s[kStages][2][kMaxBlockSize * kLdh];
  __shared__ int blk_s[kMaxSplit];

  const int bh = blockIdx.x;
  const int b = bh / a.hkv, h = bh % a.hkv;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * kChunkRows;
  const int rows_here = min(kChunkRows, a.rows - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float* work = a.work +
                (((size_t)bh * a.nsplit + split) * a.rows + row0) * kStateLd;

  // loads that need not wait for the lane's start: the split's table
  // entries and the q tile (16-byte pieces where q's rows allow them)
  const int jbase = split * a.split;
  for (int i = tid; i < min(a.nblk, jbase + a.split) - jbase;
       i += kChunkThreads)
    blk_s[i] = pool_block(a, b, jbase + i);
  const bf16* qg = static_cast<const bf16*>(a.q);
  if (reinterpret_cast<uintptr_t>(qg) % 16 == 0 && a.qsb % 8 == 0 &&
      a.qsh % 8 == 0 && a.qsc % 8 == 0) {
    for (int i = tid; i < kChunkRows * kHeadDim / 8; i += kChunkThreads) {
      const int r = i / (kHeadDim / 8), d = (i % (kHeadDim / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows_here)
        v = *reinterpret_cast<const uint4*>(qg + q_offset(a, b, h, row0 + r) +
                                            d);
      *reinterpret_cast<uint4*>(q_s + r * kLdh + d) = v;
    }
  } else {
    for (int i = tid; i < kChunkRows * kHeadDim; i += kChunkThreads) {
      const int r = i / kHeadDim, d = i % kHeadDim;
      q_s[r * kLdh + d] = r < rows_here ? qg[q_offset(a, b, h, row0 + r) + d]
                                        : __float2bfloat16(0.f);
    }
  }
  const long long st = lane_start(a, b);
  int j0, j1;
  split_blocks(a, st, split, &j0, &j1);
  if (j0 >= j1) {
    write_empty(work, rows_here, kChunkThreads);
    return;
  }
  const int n = j1 - j0;
  const int* blk = blk_s + (j0 - jbase);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue_block(a, kv_s[i][0], kv_s[i][1], blk[i], h, j0 + i, st);
    cp_async_commit();
  }

  // this lane's rows g and g + 8 of the warp, their positions, and the
  // warp's position range (rows past the call's end attend nothing)
  const int wr = warp * 16;
  const bool warp_live = wr < rows_here;
  long long qp[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wr + g + 8 * hr;
    qp[hr] = r < rows_here ? st + (row0 + r) % a.c : LLONG_MIN / 2;
  }
  long long pmin = min(qp[0], qp[1]), pmax = max(qp[0], qp[1]);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    pmin = min(pmin, __shfl_xor_sync(kFull, pmin, o));
    pmax = max(pmax, __shfl_xor_sync(kFull, pmax, o));
  }
  uint32_t aq[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    aq[ks][0] = ld2(q_s, wr + g, ks * 16 + 2 * t);
    aq[ks][1] = ld2(q_s, wr + g + 8, ks * 16 + 2 * t);
    aq[ks][2] = ld2(q_s, wr + g, ks * 16 + 8 + 2 * t);
    aq[ks][3] = ld2(q_s, wr + g + 8, ks * 16 + 8 + 2 * t);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

  const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix rows
  const int ncol = (lane >> 4) * 8;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // block i landed for all; stage (i - 1) is free
    const int nx = i + kStages - 1;
    if (nx < n) {
      const int sx = nx % kStages;
      issue_block(a, kv_s[sx][0], kv_s[sx][1], blk[nx], h, j0 + nx, st);
    }
    cp_async_commit();
    if (!warp_live) continue;
    const bf16* k_s = kv_s[i % kStages][0];
    const bf16* v_s = kv_s[i % kStages][1];
    const long long k0 = (long long)(j0 + i) * a.bs;

    float s[2][4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nn][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_bf16(s[nn], aq[ks], ld2(k_s, nn * 8 + g, ks * 16 + 2 * t),
                 ld2(k_s, nn * 8 + g, ks * 16 + 8 + 2 * t));
    }
    // the mask only where the block crosses a row's diagonal or window
    // edge, or holds fewer than 16 keys
    const bool full = a.bs == kMaxBlockSize &&
                      k0 + kMaxBlockSize - 1 <= pmin &&
                      (!a.use_window || k0 > pmax - a.window);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nn * 8 + 2 * t + (e & 1);
        const bool keep =
            full || (key < a.bs && kept(a, k0 + key, qp[e >> 1]));
        s[nn][e] = keep ? s[nn][e] * a.scale : -INFINITY;
      }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float bmax = nan_max(nan_max(s[0][2 * hr], s[0][2 * hr + 1]),
                           nan_max(s[1][2 * hr], s[1][2 * hr + 1]));
      bmax = nan_max(bmax, __shfl_xor_sync(kFull, bmax, 1));
      bmax = nan_max(bmax, __shfl_xor_sync(kFull, bmax, 2));
      const float m_new = nan_max(m[hr], bmax);
      const float shift = isfinite(m_new) ? m_new : 0.f;
      alpha[hr] = expf(m[hr] - shift);
      float psum = 0.f;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[nn][2 * hr + e] - shift);
          s[nn][2 * hr + e] = p;
          psum += p;
        }
      l[hr] = alpha[hr] * l[hr] + psum;  // this lane's columns only
      m[hr] = m_new;
    }
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      acc[nn][0] *= alpha[0];
      acc[nn][1] *= alpha[0];
      acc[nn][2] *= alpha[1];
      acc[nn][3] *= alpha[1];
    }
    // P (bf16) . V: one 16-deep step over the block's keys
    const uint32_t ap[4] = {pack2(s[0][0], s[0][1]), pack2(s[0][2], s[0][3]),
                            pack2(s[1][0], s[1][1]), pack2(s[1][2], s[1][3])};
#pragma unroll
    for (int nn = 0; nn < 8; nn += 2) {
      uint32_t bfr[4];
      ldsm_x4_trans(bfr, v_s + krow * kLdh + nn * 8 + ncol);
      mma_bf16(acc[nn], ap, bfr[0], bfr[1]);
      mma_bf16(acc[nn + 1], ap, bfr[2], bfr[3]);
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
    l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
    const int r = wr + g + 8 * hr;
    if (r >= rows_here) continue;
    float* dst = work + (size_t)r * kStateLd;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
      *reinterpret_cast<float2*>(dst + nn * 8 + 2 * t) =
          make_float2(acc[nn][2 * hr], acc[nn][2 * hr + 1]);
    if (t == 0) {
      dst[kHeadDim] = m[hr];
      dst[kHeadDim + 1] = l[hr];
    }
  }
}

// ---------------------------------------------------------------------------
// combine: the S split states of each row -> the output row
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// one warp per (lane b, kv-head h, row i); lane l owns values 2l, 2l + 1
template <typename T>
__global__ void __launch_bounds__(kCombineWarps * 32)
paged_attn_combine(const Args a, int total) {
  const int w = blockIdx.x * kCombineWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= total) return;
  const int i = w % a.rows, bh = w / a.rows;
  const int b = bh / a.hkv, h = bh % a.hkv;
  const size_t step = (size_t)a.rows * kStateLd;
  const float* st = a.work + ((size_t)bh * a.nsplit * a.rows + i) * kStateLd;
  // lane s reads split s's (m, l), 32 splits a pass
  float mx = -INFINITY;
  for (int s = lane; s < a.nsplit; s += 32)
    mx = nan_max(mx, st[s * step + kHeadDim]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = nan_max(mx, __shfl_xor_sync(kFull, mx, o));
  const float shift = isfinite(mx) ? mx : 0.f;
  float l = 0.f, o0 = 0.f, o1 = 0.f;
  for (int s0 = 0; s0 < a.nsplit; s0 += 32) {
    const int s = s0 + lane;
    float wt = 0.f;
    if (s < a.nsplit) {
      wt = expf(st[s * step + kHeadDim] - shift);
      l += wt * st[s * step + kHeadDim + 1];
    }
    const int cnt = min(32, a.nsplit - s0);
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const float w = __shfl_sync(kFull, wt, k);
      const float2 v =
          *reinterpret_cast<const float2*>(st + (s0 + k) * step + 2 * lane);
      o0 += w * v.x;
      o1 += w * v.y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
  const int r = i / a.c, cq = i % a.c;
  T* dst = static_cast<T*>(a.out) +
           (((size_t)b * a.c + cq) * a.h + h * a.rep + r) * kHeadDim;
  // == 0, not > 0: a nan denominator must propagate
  store2(dst + 2 * lane, l == 0.f ? 0.f : o0 / l, l == 0.f ? 0.f : o1 / l);
}

template <typename T, int NR>
int launch_split(const Args& a, int bhkv, cudaStream_t stream) {
  const dim3 grid(bhkv, a.nsplit, (a.rows + NR - 1) / NR);
  paged_attn_split_kernel<T, NR><<<grid, kSplitWarps * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int bhkv, cudaStream_t stream) {
  int rc;
  // f32 pools take at most 4 rows a CUDA block (their K/V tile takes
  // twice the registers of bf16's); more rows take more row tiles
  constexpr int kMaxRows = sizeof(T) == 4 ? kSplitRows / 2 : kSplitRows;
  if (sizeof(T) == 2 && a.q_bf16 && a.rows > kMaxSplitRowsBf16) {
    const dim3 grid(bhkv, a.nsplit, (a.rows + kChunkRows - 1) / kChunkRows);
    paged_attn_chunk_mma<<<grid, kChunkThreads, 0, stream>>>(a);
    rc = (int)cudaGetLastError();
  } else if (a.rows <= 1) {
    rc = launch_split<T, 1>(a, bhkv, stream);
  } else if (a.rows <= 2) {
    rc = launch_split<T, 2>(a, bhkv, stream);
  } else if (a.rows <= 4 || kMaxRows == 4) {
    rc = launch_split<T, 4>(a, bhkv, stream);
  } else {
    rc = launch_split<T, kMaxRows>(a, bhkv, stream);
  }
  if (rc != 0) return rc;
  const int total = bhkv * a.rows;
  paged_attn_combine<T>
      <<<(total + kCombineWarps - 1) / kCombineWarps, kCombineWarps * 32, 0,
         stream>>>(a, total);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the split kernel and the combine kernel on `stream`.
// q_strides: q's element strides for (batch, head, query); the head dim
// is contiguous. start: device pointer to start_elt-byte integers read at
// b * start_stride, or null for start_scalar. work: f32
// [b, hkv, ceil(nblk / split), (h / hkv) * c, d + 2]. q_dtype and
// pool_dtype: 0 = float32, 1 = bfloat16. Returns the launches'
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernels were not built for (head_dim 64, block size 1..16, split
// 1..128, fewer than 2^30 keys a table, a window of at most 2^29). Pools
// must be 16-byte aligned.
extern "C" int paged_attention_fwd(
    const void* q, const long long* q_strides, int q_dtype, const void* pk,
    const void* pv, const void* tables, const void* start,
    long long start_scalar, int start_elt, int start_stride, void* out,
    void* work, int b, int h, int hkv, int c, int d, int bs, int nblk, int nb,
    int split, float scale, int use_window, int window, int pool_dtype,
    void* stream) {
  if (d != kHeadDim || bs < 1 || bs > kMaxBlockSize || c < 1 || nb < 1 ||
      nblk < 1 || split < 1 || split > kMaxSplit || hkv < 1 || h % hkv ||
      (long long)nblk * bs >= kPosLimit ||
      (use_window && window > kPosLimit / 2) ||
      (q_dtype != 0 && q_dtype != 1) ||
      (start != nullptr && start_elt != 4 && start_elt != 8))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaSuccess;
  Args a;
  a.q = q;
  a.qsb = q_strides[0];
  a.qsh = q_strides[1];
  a.qsc = q_strides[2];
  a.pk = pk;
  a.pv = pv;
  a.tables = static_cast<const int*>(tables);
  a.start = start;
  a.start_scalar = start_scalar;
  a.start_elt = start_elt;
  a.start_stride = start_stride;
  a.out = out;
  a.work = static_cast<float*>(work);
  a.h = h;
  a.hkv = hkv;
  a.rep = h / hkv;
  a.c = c;
  a.rows = a.rep * c;
  a.bs = bs;
  a.nblk = nblk;
  a.nb = nb;
  a.split = split;
  a.nsplit = (nblk + split - 1) / split;
  a.scale = scale;
  a.use_window = use_window;
  a.window = window;
  a.q_bf16 = q_dtype;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 0) return launch<float>(a, b * hkv, st);
  if (pool_dtype == 1) return launch<__nv_bfloat16>(a, b * hkv, st);
  return (int)cudaErrorInvalidValue;
}
