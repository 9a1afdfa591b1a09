// Fused multi-tensor Adam / AdamW update for Hopper (sm_90a): one launch
// updates in place every parameter of one group (one dtype, master or
// none, learning-rate multiplier and regularizer term).
//
// No Pallas kernel stands behind it. The JAX package writes the update
// as jnp in Adam._update / AdamW._update
// (paddle_tpu/optimizer/optimizer.py:372-382, 413-425), and XLA fuses it
// into the compiled train step. Eager PyTorch would run it as a dozen
// `_foreach_*` passes over every parameter, plus a cast kernel per
// parameter; this kernel is that update in one pass.
//
// What it computes, element by element, in f32 and in the order of the
// port's plain twin (Optimizer._apply and Adam._update in
// optimizer/optimizer.py), which is the JAX rule's:
//   * base = the f32 master when multi_precision holds, else p;
//   * the regularizer's gradient term, independent of the update rule:
//     none, L2 g = g + c * base or L1 g = g + c * sign(base) (sign(0) =
//     0, as torch.sign), rounded to base's dtype at each operation (two
//     roundings for bf16 weights, as the plain twin's two bf16 ops; c
//     arrives rounded to base's dtype);
//   * m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2 (f32 moments);
//   * m_hat = m / (1 - b1^t), den = sqrt(v / (1 - b2^t)) + eps, with the
//     bias corrections computed in f32 from the device step t;
//   * lr = lr * lr_scale in f32 (the group's per-parameter multiplier;
//     exact for 1);
//   * Adam: upd = lr m_hat / den; AdamW (decoupled): upd = lr (m_hat /
//     den + coeff base), whatever the gradient term;
//   * base = base - upd rounded to base's dtype; with a master, p is the
//     master rounded to p's dtype.
// lr and t are read from a device f32 pair [lr, step] that the optimizer
// writes before each step, so a captured CUDA graph replays with fresh
// values. A NaN reaches only its own element's moments and weights.
//
// What bounds it: bytes. Every element is read once and written once: at
// GPT-2 small's 111.0M parameters in bf16 with f32 moments that is 22
// bytes a parameter (p read and written, g read, m and v read and
// written), 2.44 GB, or 0.729 ms at 3.35 TB/s, against about 20 f32
// operations a parameter (0.03 ms on the CUDA cores).
//
// What the design does:
//   * the tensors of one launch ride in the kernel's parameters (a
//     __grid_constant__ struct of up to kMaxTensors tensors: five pointers
//     and a size each, and a prefix sum of their blocks), so no pointer
//     table is copied to the device and a CUDA graph captures the launch
//     by value; the caller splits a longer list into several launches;
//   * each block takes kChunk consecutive elements of one tensor, found
//     by a binary search of the prefix sum;
//   * every thread moves 8 elements at a time in 16-byte accesses (8
//     bf16, or two float4 of f32), with a scalar tail for a size that is
//     not a multiple of 8;
//   * the bias corrections are computed once per block.
// Every pointer needs 16-byte alignment; the entry point rejects any
// other. Build without --use_fast_math: it changes division and sqrt.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxTensors = 256;   // tensors one launch carries
constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements a thread moves per access
constexpr int kIters = 2;
constexpr int kChunk = kThreads * kVec * kIters;   // elements a block

enum GradMode { kNoTerm = 0, kL2 = 1, kL1 = 2 };

// 5 x 8 x 256 + 8 x 256 + 4 x 257 + 56 bytes = 13.4 KB of parameters
// (CUDA 12.1 and later take up to 32764)
struct Params {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  float* master[kMaxTensors];
  long long n[kMaxTensors];
  int block_start[kMaxTensors + 1];   // prefix sum of blocks per tensor
  int count;
  const float* scalars;               // device [lr, step]
  float b1, b2, one_minus_b1, one_minus_b2, eps;
  float grad_coeff;                   // the gradient term's coefficient
  float decay;                        // AdamW's decoupled coefficient
  float lr_scale;                     // the group's lr multiplier
  int grad_mode;                      // GradMode
  int decoupled;                      // AdamW's rule
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T, back in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 8 consecutive elements in 16-byte accesses
__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

struct Step {
  float lr, bc1, bc2;
};

// One element: `base` is the f32 value of the weight the rule updates
// (the master, or p), rounded to BaseT at each operation; returns the
// new base and advances m and v.
template <typename BaseT>
__device__ __forceinline__ float update(float base, float g, float& m,
                                        float& v, const Params& P,
                                        const Step& s) {
  if (P.grad_mode == kL2) {
    g = round_to<BaseT>(
        __fadd_rn(g, round_to<BaseT>(__fmul_rn(P.grad_coeff, base))));
  } else if (P.grad_mode == kL1) {
    const float sign = base > 0.f ? 1.f : (base < 0.f ? -1.f : 0.f);
    g = round_to<BaseT>(
        __fadd_rn(g, round_to<BaseT>(__fmul_rn(P.grad_coeff, sign))));
  }
  // the roundings of torch's foreach add (x + alpha y) and addcmul (x +
  // alpha (y z)), as fused multiply-adds
  m = fmaf(P.one_minus_b1, g, __fmul_rn(P.b1, m));
  v = fmaf(P.one_minus_b2, __fmul_rn(g, g), __fmul_rn(P.b2, v));
  const float mhat = __fdiv_rn(m, s.bc1);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), P.eps);
  float upd;
  if (P.decoupled)
    upd = __fmul_rn(fmaf(P.decay, base, __fdiv_rn(mhat, den)), s.lr);
  else
    upd = __fdiv_rn(__fmul_rn(mhat, s.lr), den);
  return round_to<BaseT>(__fsub_rn(base, round_to<BaseT>(upd)));
}

// T: the weights' (and grads') type; MP: an f32 master is updated and
// the weights are its rounding
template <typename T, bool MP>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Params P) {
  __shared__ Step step;
  if (threadIdx.x == 0) {
    const float t = P.scalars[1];
    step.lr = __fmul_rn(P.scalars[0], P.lr_scale);
    step.bc1 = 1.f - powf(P.b1, t);
    step.bc2 = 1.f - powf(P.b2, t);
  }
  // the tensor whose blocks hold this one: the last start <= blockIdx.x
  int lo = 0, hi = P.count - 1;
  const int blk = blockIdx.x;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (P.block_start[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  __syncthreads();
  const Step s = step;
  const long long n = P.n[lo];
  const long long first = (long long)(blk - P.block_start[lo]) * kChunk;
  T* p = static_cast<T*>(P.p[lo]);
  const T* g = static_cast<const T*>(P.g[lo]);
  float* m = P.m[lo];
  float* v = P.v[lo];
  float* master = P.master[lo];
  using BaseT = typename std::conditional<MP, float, T>::type;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const long long i = first + (long long)(it * kThreads + threadIdx.x) *
                                    kVec;
    if (i + kVec <= n) {
      float pv[kVec], gv[kVec], mv[kVec], vv[kVec], bv[kVec];
      load8(g + i, gv);
      load8(m + i, mv);
      load8(v + i, vv);
      if (MP) load8(master + i, bv); else load8(p + i, bv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        bv[j] = update<BaseT>(bv[j], gv[j], mv[j], vv[j], P, s);
        pv[j] = bv[j];
      }
      store8(m + i, mv);
      store8(v + i, vv);
      if (MP) store8(master + i, bv);
      store8(p + i, pv);
    } else {
      for (long long j = i; j < n; ++j) {
        float mj = m[j], vj = v[j];
        const float b = update<BaseT>(MP ? master[j] : to_f32(p[j]),
                                      to_f32(g[j]), mj, vj, P, s);
        m[j] = mj;
        v[j] = vj;
        if (MP) master[j] = b;
        store(p + j, b);
      }
    }
  }
}

bool aligned(const void* p) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One fused Adam/AdamW step over `count` tensors of one dtype group, on
// `stream`. ptrs holds five pointers per tensor: p, g, moment1, moment2,
// master (null without multi_precision); numels their sizes (> 0).
// scalars: device f32 [lr, step]. dtype: 0 = float32, 1 = bfloat16 (p
// and g alike); multi_precision only with bfloat16. grad_mode: 0 none,
// 1 L2 (g + grad_coeff * base), 2 L1 (g + grad_coeff * sign(base));
// decoupled: AdamW's rule with coefficient `decay`, else Adam's;
// lr_scale: the learning-rate multiplier.
// Returns the launch's cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a count outside 1..256, a pointer that is
// null or not 16-byte aligned, or an unsupported combination.
extern "C" int optimizer_adam_step(const void* const* ptrs,
                                   const long long* numels, int count,
                                   const float* scalars, float b1, float b2,
                                   float one_minus_b1, float one_minus_b2,
                                   float eps, float grad_coeff,
                                   float decay, float lr_scale,
                                   int grad_mode, int decoupled, int dtype,
                                   int multi_precision, void* stream) {
  if (count < 1 || count > kMaxTensors || !aligned(scalars) ||
      (dtype != 0 && dtype != 1) || (multi_precision && dtype != 1) ||
      grad_mode < kNoTerm || grad_mode > kL1 || (decoupled != 0 &&
      decoupled != 1))
    return (int)cudaErrorInvalidValue;
  Params P = {};
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const void* const* t = ptrs + 5 * i;
    if (numels[i] <= 0 || !aligned(t[0]) || !aligned(t[1]) ||
        !aligned(t[2]) || !aligned(t[3]) ||
        (multi_precision ? !aligned(t[4]) : t[4] != nullptr))
      return (int)cudaErrorInvalidValue;
    P.p[i] = const_cast<void*>(t[0]);
    P.g[i] = t[1];
    P.m[i] = static_cast<float*>(const_cast<void*>(t[2]));
    P.v[i] = static_cast<float*>(const_cast<void*>(t[3]));
    P.master[i] = static_cast<float*>(const_cast<void*>(t[4]));
    P.n[i] = numels[i];
    P.block_start[i] = (int)blocks;
    blocks += (numels[i] + kChunk - 1) / kChunk;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  P.block_start[count] = (int)blocks;
  P.count = count;
  P.scalars = scalars;
  P.b1 = b1;
  P.b2 = b2;
  P.one_minus_b1 = one_minus_b1;
  P.one_minus_b2 = one_minus_b2;
  P.eps = eps;
  P.grad_coeff = grad_coeff;
  P.decay = decay;
  P.lr_scale = lr_scale;
  P.grad_mode = grad_mode;
  P.decoupled = decoupled;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    adam_kernel<float, false><<<(unsigned)blocks, kThreads, 0, s>>>(P);
  else if (multi_precision)
    adam_kernel<__nv_bfloat16, true><<<(unsigned)blocks, kThreads, 0, s>>>(P);
  else
    adam_kernel<__nv_bfloat16, false><<<(unsigned)blocks, kThreads, 0, s>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int optimizer_adam_max_tensors() { return kMaxTensors; }
