// w4a16 int4 matmul for Hopper (sm_90a): y[B, N] = x[B, K] @ W for B <= 8.
//
// Replaces the TPU kernel `_w4_kernel` of dreamllm_tpu/ops/quant4.py
// (launched by `w4_matmul`), in its default "mask" variant. W is group-128
// symmetric int4: `packed` uint8 [K/2, N], the low nibble of row i holding
// logical row i and the high nibble logical row i + K/2, each stored as
// q + 8 in [0, 15]; `scale` fp32 [K/128, N]. Same function: x rounded to
// bf16, then for every 128-row group g and column n
//   (sum_k x_k * u_kn  -  8 * sum_k x_k) * scale[g, n]
// with the sums in fp32, the groups added in fp32, and the result cast to
// x's dtype. The TPU kernel's zero-padding of B to 8 rows is a tiling detail
// of that machine and is not carried over: B is a template parameter, 1..8.
//
// Bound on an H100 SXM: at B = 1 bytes (the packed weight, 0.5 B an element,
// plus 4 B of scale per 128 elements, over 3.35 TB/s); at B = 8 this design,
// which unpacks and multiplies on the CUDA cores, is bound by fp32 FMAs (two
// nibbles x 8 rows = 16 FMAs a packed byte: 55 G FMAs for the 7B step, about
// 1.6 ms at 67 TFLOP/s). Unpacking to bf16 in registers and feeding `mma`
// is where a later redesign starts.
//
// Design. The sequential k axis of the TPU grid becomes split-K over blocks,
// reduced without atomics: a block owns 128 output columns and a run of
// `chunks_per_split` chunks of 128 packed rows (one scale group in each half
// of K), and writes one fp32 partial row per output row; a second kernel
// adds the partials in split order and casts. Inside a block, four warps
// take 32 packed rows each; a lane reads 4 consecutive bytes of a packed row
// (4 columns; a warp reads one 128-byte line), unpacks both nibbles with
// shifts and masks, and keeps 2 x B x 4 fp32 dot products in registers. x
// for the chunk (both halves, rounded to bf16) sits in shared memory and is
// read as a broadcast. The warps' dots meet in shared memory and are added
// in warp order, so the result does not depend on scheduling.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;                     // output columns a block owns
constexpr int kChunk = 128;                    // packed rows a chunk (= GROUP)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kChunk / kWarps;  // 32
constexpr int kColsPerLane = kCols / 32;       // 4: one 32-bit load a packed row

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_round(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

template <int B, typename XT>
__global__ void __launch_bounds__(kThreads)
w4a16_partial(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
              const float* __restrict__ scale, float* __restrict__ partial, int kp, int n,
              int chunks_per_split) {
  __shared__ float xs[B][2 * kChunk];  // x of this chunk: low-half rows, then high-half rows
  __shared__ float corr[2][B];         // 8 * sum of each half's x, per row
  __shared__ float red[kWarps][2][B][kCols];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kCols;
  const int n_chunks = kp / kChunk;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const long long k = 2LL * kp;

  float running[B];
#pragma unroll
  for (int b = 0; b < B; ++b) running[b] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    for (int i = tid; i < B * 2 * kChunk; i += kThreads) {
      const int b = i / (2 * kChunk), j = i % (2 * kChunk);
      const long long row =
          j < kChunk ? (long long)c * kChunk + j : (long long)kp + (long long)c * kChunk + (j - kChunk);
      xs[b][j] = bf16_round(x[b * k + row]);
    }
    __syncthreads();

    // the zero-point corrections: one warp per (half, row) pair in turn,
    // a fixed-order shuffle tree
    for (int pair = warp; pair < 2 * B; pair += kWarps) {
      const int h = pair / B, b = pair % B;
      float s = 0.f;
#pragma unroll
      for (int j = lane; j < kChunk; j += 32) s += xs[b][h * kChunk + j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) corr[h][b] = 8.f * s;
    }

    float dlo[B][kColsPerLane], dhi[B][kColsPerLane];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) dlo[b][j] = dhi[b][j] = 0.f;

    const int r0 = warp * kRowsPerWarp;
    const uint8_t* prow = packed + ((long long)c * kChunk + r0) * n + n0 + lane * kColsPerLane;
#pragma unroll 8
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const uint32_t p = __ldg(reinterpret_cast<const unsigned int*>(prow + (long long)i * n));
      float ulo[kColsPerLane], uhi[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        ulo[j] = (float)((p >> (8 * j)) & 0xFu);
        uhi[j] = (float)((p >> (8 * j + 4)) & 0xFu);
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float xl = xs[b][r0 + i], xh = xs[b][kChunk + r0 + i];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          dlo[b][j] = fmaf(xl, ulo[j], dlo[b][j]);
          dhi[b][j] = fmaf(xh, uhi[j], dhi[b][j]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        red[warp][0][b][lane * kColsPerLane + j] = dlo[b][j];
        red[warp][1][b][lane * kColsPerLane + j] = dhi[b][j];
      }
    __syncthreads();

    // one column a thread: the warps' dots in warp order, then the group's
    // scale, low half first as in the TPU kernel
    const float s_lo = scale[(long long)c * n + n0 + tid];
    const float s_hi = scale[(long long)(n_chunks + c) * n + n0 + tid];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float lo = red[0][0][b][tid], hi = red[0][1][b][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        lo += red[w][0][b][tid];
        hi += red[w][1][b][tid];
      }
      float acc = __fmul_rn(lo - corr[0][b], s_lo);
      acc = __fadd_rn(acc, __fmul_rn(hi - corr[1][b], s_hi));
      running[b] += acc;
    }
    __syncthreads();  // xs, corr and red are rewritten by the next chunk
  }

#pragma unroll
  for (int b = 0; b < B; ++b)
    partial[((long long)blockIdx.y * B + b) * n + n0 + tid] = running[b];
}

// out[i] = sum over splits of partial[s][i], in split order, cast to OT
template <typename OT>
__global__ void __launch_bounds__(256)
w4a16_reduce(const float* __restrict__ partial, OT* __restrict__ out, int splits, int bn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(long long)sp * bn + i];
  store(out + i, s);
}

template <typename XT>
int launch(const void* x, const void* packed, const float* scale, float* partial, void* out,
           int b, int kp, int n, int chunks_per_split, cudaStream_t stream) {
  const int n_chunks = kp / kChunk;
  const int splits = (n_chunks + chunks_per_split - 1) / chunks_per_split;
  dim3 grid(n / kCols, splits);
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  switch (b) {
#define W4A16_CASE(BB)                                                                         \
  case BB:                                                                                    \
    w4a16_partial<BB, XT><<<grid, kThreads, 0, stream>>>(xp, pp, scale, partial, kp, n,        \
                                                         chunks_per_split);                   \
    break;
    W4A16_CASE(1)
    W4A16_CASE(2)
    W4A16_CASE(3)
    W4A16_CASE(4)
    W4A16_CASE(5)
    W4A16_CASE(6)
    W4A16_CASE(7)
    W4A16_CASE(8)
#undef W4A16_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bn = b * n;
  w4a16_reduce<XT><<<(bn + 255) / 256, 256, 0, stream>>>(partial, static_cast<XT*>(out), splits,
                                                         bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for an
// unknown dtype, a row count outside 1..8 or a shape the kernel does not
// tile. `dtype`: 0 = float32, 1 = bfloat16, for x [b, 2 * kp] and out
// [b, n] alike (contiguous). packed uint8 [kp, n] and scale fp32
// [kp / 64, n], contiguous, with kp % 128 == 0, n % 128 == 0 and packed
// 4-byte aligned. `partial`: fp32 scratch of ceil((kp / 128) /
// chunks_per_split) * b * n elements.
int dl_w4a16(const void* x, const void* packed, const float* scale, float* partial, void* out,
             int dtype, int b, int kp, int n, int chunks_per_split, void* stream) {
  if (kp <= 0 || n <= 0 || kp % kChunk || n % kCols || chunks_per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, packed, scale, partial, out, b, kp, n, chunks_per_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, packed, scale, partial, out, b, kp, n, chunks_per_split, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
