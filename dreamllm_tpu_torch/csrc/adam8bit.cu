// Fused 8-bit AdamW update for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_adam_kernel` of
// dreamllm_tpu/train/optim8bit.py (launched by `_fused_adam_update`). Same
// function, per 256-element block of a flattened leaf: dequantize the int8
// first moment (linear code) and second moment (sqrt-space code) with their
// fp32 absmax scales, take the Adam moment step, emit the update
//   -lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)
// in the gradient's dtype, and requantize m and sqrt(v) against their fresh
// absmax (round half to even; a strictly positive sqrt(v) never gets code 0).
// Codes and scales are overwritten in place. The update is emitted, not
// applied: gradient multipliers and the freeze act on it afterwards.
//
// Bound on an H100 SXM: bytes. Each element moves g, p and the update (2 B
// each in bf16) and two codes read and written (4 B): 10 B per element over
// 3.35 TB/s, against a few dozen flops. The unfused formulation writes the
// fp32 moments to HBM between the elementwise step and the two absmax
// reductions; this kernel keeps them in registers.
//
// Design: one warp per 256-element block, 8 consecutive elements a lane, so
// g and p load as one 16-byte vector (bf16) and the codes as one 8-byte
// vector; the two absmax reductions are five shuffles each and need no shared
// memory. The TPU kernel's rule that a leaf must tile into 128k rows is a
// lane constraint of that machine and is not carried over: the kernel takes
// the element count and reads a ragged tail as zero gradient and parameter.
// `lr`, `bc1`, `bc2` come from device memory so that a schedule evaluated on
// the card needs no host sync; `skip`, when given and nonzero, makes the
// kernel emit a zero update and leave codes and scales untouched (the train
// step's non-finite guard). The arithmetic uses the explicit round-to-nearest
// intrinsics, which the compiler never contracts into fused multiply-adds,
// so every intermediate rounds as in the plain, op-by-op version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQBlock = 256;   // elements per quantization block
constexpr int kPerLane = 8;    // elements a lane owns
constexpr int kThreads = 128;  // 4 warps = 4 quantization blocks a thread block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, off));
  return x;
}

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
adam8bit_kernel(const T* g, const T* __restrict__ p, T* upd,  // upd may alias g
                int8_t* __restrict__ m_codes, float* __restrict__ m_scale,
                int8_t* __restrict__ v_codes, float* __restrict__ v_scale,
                const float* __restrict__ scalars,  // lr, bc1, bc2
                const int* __restrict__ skip, long long n, long long n_blocks, Hyper hp) {
  const long long blk = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (blk >= n_blocks) return;
  const int lane = threadIdx.x % 32;
  const long long e0 = blk * kQBlock + lane * kPerLane;
  const bool full = e0 + kPerLane <= n;

  if (skip != nullptr && *skip != 0) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (e0 + i < n) from_float(upd[e0 + i], 0.f);
    return;
  }

  const float lr = scalars[0], bc1 = scalars[1], bc2 = scalars[2];

  __align__(16) T gv[kPerLane];
  __align__(16) T pv[kPerLane];
  if (full) {
    // rows of 8 elements are 16-byte (bf16) or 32-byte (fp32) aligned
    using Vec = typename std::conditional<sizeof(T) == 2, uint4, float4>::type;
    constexpr int kVecs = sizeof(T) * kPerLane / sizeof(Vec);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      reinterpret_cast<Vec*>(gv)[i] = reinterpret_cast<const Vec*>(g + e0)[i];
      reinterpret_cast<Vec*>(pv)[i] = reinterpret_cast<const Vec*>(p + e0)[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const bool in = e0 + i < n;
      from_float(gv[i], 0.f);
      from_float(pv[i], 0.f);
      if (in) { gv[i] = g[e0 + i]; pv[i] = p[e0 + i]; }
    }
  }

  // codes are stored padded to whole blocks: always a full 8-byte vector
  __align__(8) int8_t mc[kPerLane];
  __align__(8) int8_t vc[kPerLane];
  *reinterpret_cast<uint2*>(mc) = *reinterpret_cast<const uint2*>(m_codes + e0);
  *reinterpret_cast<uint2*>(vc) = *reinterpret_cast<const uint2*>(v_codes + e0);
  const float ms = __fdiv_rn(m_scale[blk], 127.0f);
  const float vs = __fdiv_rn(v_scale[blk], 127.0f);

  float m[kPerLane], vsq[kPerLane];
  float m_max = 0.f, v_max = 0.f;
  __align__(16) T out[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float gf = to_float(gv[i]);
    const float m_old = __fmul_rn((float)mc[i], ms);
    const float vsq_old = __fmul_rn((float)vc[i], vs);
    const float v_old = __fmul_rn(vsq_old, vsq_old);
    // m = b1 * m + (1 - b1) * g;  v = b2 * v + ((1 - b2) * g) * g
    const float mi = __fadd_rn(__fmul_rn(hp.b1, m_old), __fmul_rn(hp.one_minus_b1, gf));
    const float vi = __fadd_rn(__fmul_rn(hp.b2, v_old),
                               __fmul_rn(__fmul_rn(hp.one_minus_b2, gf), gf));
    float u = __fdiv_rn(__fdiv_rn(mi, bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bc2)), hp.eps));
    if (hp.wd != 0.f) u = __fadd_rn(u, __fmul_rn(hp.wd, to_float(pv[i])));
    from_float(out[i], __fmul_rn(-lr, u));
    m[i] = mi;
    vsq[i] = __fsqrt_rn(fmaxf(vi, 0.f));
    m_max = fmaxf(m_max, fabsf(mi));
    v_max = fmaxf(v_max, vsq[i]);
  }

  if (full) {
    using Vec = typename std::conditional<sizeof(T) == 2, uint4, float4>::type;
    constexpr int kVecs = sizeof(T) * kPerLane / sizeof(Vec);
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      reinterpret_cast<Vec*>(upd + e0)[i] = reinterpret_cast<const Vec*>(out)[i];
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (e0 + i < n) upd[e0 + i] = out[i];
  }

  m_max = warp_max(m_max);
  v_max = warp_max(v_max);
  const float m_safe = m_max == 0.f ? 1.f : m_max;
  const float v_safe = v_max == 0.f ? 1.f : v_max;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    mc[i] = (int8_t)(int)rintf(__fmul_rn(__fdiv_rn(m[i], m_safe), 127.0f));
    int c = (int)rintf(__fmul_rn(__fdiv_rn(vsq[i], v_safe), 127.0f));
    if (vsq[i] > 0.f && c == 0) c = 1;
    vc[i] = (int8_t)c;
  }
  *reinterpret_cast<uint2*>(m_codes + e0) = *reinterpret_cast<const uint2*>(mc);
  *reinterpret_cast<uint2*>(v_codes + e0) = *reinterpret_cast<const uint2*>(vc);
  if (lane == 0) {
    m_scale[blk] = m_max;
    v_scale[blk] = v_max;
  }
}

template <typename T>
int launch(const void* g, const void* p, void* upd, void* m_codes, float* m_scale,
           void* v_codes, float* v_scale, const float* scalars, const int* skip,
           long long n, const Hyper& hp, cudaStream_t stream) {
  const long long n_blocks = (n + kQBlock - 1) / kQBlock;
  if (n_blocks == 0) return 0;
  const int per = kThreads / 32;
  adam8bit_kernel<T><<<(unsigned)((n_blocks + per - 1) / per), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(p), static_cast<T*>(upd),
      static_cast<int8_t*>(m_codes), m_scale, static_cast<int8_t*>(v_codes), v_scale,
      scalars, skip, n, n_blocks, hp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for an
// unknown dtype. `dtype`: 0 = float32, 1 = bfloat16, for g, p and upd alike
// (contiguous, 16-byte aligned, n elements; upd may be g itself: every
// thread reads its gradient elements before it writes its update). Codes are int8 [n_blocks, 256],
// scales fp32 [n_blocks], with n_blocks = ceil(n / 256). `scalars` points at
// three floats on the device (lr, bc1, bc2); `skip` at one int or is null.
int dl_adam8bit(const void* g, const void* p, void* upd, void* m_codes, float* m_scale,
                void* v_codes, float* v_scale, const float* scalars, const int* skip,
                long long n, int dtype, float b1, float one_minus_b1, float b2,
                float one_minus_b2, float eps, float wd, void* stream) {
  Hyper hp{b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(g, p, upd, m_codes, m_scale, v_codes, v_scale, scalars, skip, n, hp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, p, upd, m_codes, m_scale, v_codes, v_scale, scalars, skip,
                                 n, hp, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
