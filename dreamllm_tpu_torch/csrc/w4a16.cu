// w4a16 int4 matmul for Hopper (sm_90a): y[B, N] = x[B, K] @ W for B <= 8.
//
// Replaces the TPU kernel `_w4_kernel` of dreamllm_tpu/ops/quant4.py
// (launched by `w4_matmul`), in its default "mask" variant. W is group-128
// symmetric int4: `packed` uint8 [K/2, N], the low nibble of row i holding
// logical row i and the high nibble logical row i + K/2, each stored as
// q + 8 in [0, 15]; `scale` fp32 [K/128, N]. Same function: x rounded to
// bf16, then for every 128-row group g and column n the exact products
// x_k * (u_kn - 8) summed in fp32, times scale[g, n] in fp32, the groups
// added in fp32, and the result cast to x's dtype. The stored layout is
// read as it is: no repack and no second copy of the weight.
//
// Bound on an H100 SXM: bytes, at every B of 1..8 (the packed weight, 0.5 B
// an element, plus 4 B of scale per 128 elements, over 3.35 TB/s; 2.5 MFLOP
// per MB of weight at B = 8 is far below the tensor cores' rate).
//
// Design.
// - Tensor cores, batch as the N dimension: y^T = W^T x^T with
//   mma.sync.m16n8k16, A = 16 output columns x 16 k of the weight, B = x^T
//   with its 8 columns the batch rows (rows past B read as zeros). B = 1
//   and B = 8 cost the same instructions.
// - Nibbles to bf16 in registers, exactly: `prmt` puts two bytes' nibbles
//   16 bits apart, `lop3` ORs them into the mantissa of bf16 128.0
//   (0x4300 | u = 128 + u), and one bf16x2 FMA subtracts 136, giving u - 8.
//   The products with bf16 x are exact in the fp32 accumulators.
// - Fragments from JAX's layout. Inside one mma the order of k is free as
//   long as A and B agree, so a lane's four k slots are four consecutive
//   packed rows (4t..4t+3 of each 16): a lane reads 16 bytes of each, 16
//   neighbouring columns, and the x fragment is 4 consecutive elements.
//   Which 16 physical columns an mma's A rows are is free as well: lane
//   group g's bytes 2m and 2m+1 are the A rows g and g + 8 of column block
//   m, so the 16 bytes feed 8 mma per half of K. The two nibbles of a byte
//   lie in different groups (rows i and i + K/2), so each column block has
//   one accumulator for the low half and one for the high half, scaled
//   after each 128-row chunk by their own group's scale and added, low
//   first, into a running fp32 sum.
// - Bytes in flight: each warp owns a 128-column tile and a run of 128-row
//   chunks, and streams them with TMA, 16 rows (2 KB, 128-byte swizzle) and
//   the matching 16 x values of both halves of K a step (rows past B
//   zero-filled), into its own ring of 4 stages with one mbarrier each; its
//   lane 0 refills a stage once the warp has read it. A block's four warps
//   take four neighbouring tiles (512 bytes of each packed row) and the
//   same run of chunks where the width gives the card enough blocks that
//   way (kTiles = 4); at the 4096-wide projections they take one tile and
//   four runs of chunks (kTiles = 1), so that more, shorter runs fill the
//   SMs. The host picks kTiles and the split from the shape.
// - Split K in one launch, without atomics or scratch: the `blocks_k`
//   blocks that share a column block form a thread block cluster. Each warp
//   leaves its sums in its ring; after a cluster barrier, block y of the
//   cluster adds the sums of its slice of the block's columns from every
//   block's and every warp's shared memory, in split order, casts and
//   writes y; a second barrier keeps the shared memory alive until all have
//   read. The same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kCols = 128;   // output columns a warp owns (128 bytes of a packed row)
constexpr int kChunk = 128;  // packed rows a chunk (= GROUP)
constexpr int kWarps = 4;    // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;   // 16-row steps in flight a warp
constexpr int kXBytes = 16 * 8 * 4;                  // one x box: 16 k x 8 rows, at most fp32
constexpr int kStageBytes = 16 * kCols + 2 * kXBytes;  // weight box, x of both halves of K
constexpr int kRingBytes = kStages * kStageBytes;      // a multiple of 1024 (the swizzle atom)
constexpr int kSmem = kWarps * kRingBytes + kWarps * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// the nibbles at bits `shift` and 16 + `shift` of z as a bf16 pair u - 8
template <int kShift>
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t z) {
  const uint32_t v = ((z >> kShift) & 0x000F000Fu) | 0x43004300u;  // 128 + u
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"  // (128 + u) * 1 - 136, exact
      : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// kTiles: the neighbouring column tiles a block owns (4 or 1); its warps
// split K kWarps / kTiles ways
template <typename XT, int kTiles>
__global__ void __launch_bounds__(kThreads, 3)  // at most 168 registers: three blocks an SM
w4a16_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
             const float* __restrict__ scale, XT* __restrict__ out, int nb, int kp, int n) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle's 1024-byte atoms
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kSplits = kWarps / kTiles;  // runs of chunks a block
  const int n0 = (blockIdx.x * kTiles + warp % kTiles) * kCols;
  const int n_chunks = kp / kChunk;
  // this warp's run of chunks: split blockIdx.y * kSplits + warp / kTiles;
  // a warp past the last column tile (a width not a multiple of 512) only
  // joins the cluster barriers
  const int split = blockIdx.y * kSplits + warp / kTiles, n_splits = gridDim.y * kSplits;
  const int c_begin = (int)((long long)split * n_chunks / n_splits);
  const int c_end = (int)((long long)(split + 1) * n_chunks / n_splits);
  const int n_steps = n0 < n ? (c_end - c_begin) * (kChunk / 16) : 0;

  unsigned char* ring = smem_raw + (base - raw) + warp * kRingBytes;
  const uint32_t ring_s = base + warp * kRingBytes;
  const uint32_t bars = base + kWarps * kRingBytes + warp * kStages * 8;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
  }
  __syncwarp();

  // one 16-row step: the weight box and x at the same k of both halves
  auto issue = [&](int q, int stage) {
    if (lane == 0 && q < n_steps) {
      const int r = (c_begin + q / 8) * kChunk + (q % 8) * 16;
      const uint32_t dst = ring_s + stage * kStageBytes;
      const uint32_t bar = bars + 8 * stage;
      mbar_arrive_expect_tx(bar, 16 * kCols + 2 * 16 * 8 * (int)sizeof(XT));
      tma_load_2d(dst, &tw, bar, n0, r);
      tma_load_2d(dst + 16 * kCols, &tx, bar, r, 0);
      tma_load_2d(dst + 16 * kCols + kXBytes, &tx, bar, kp + r, 0);
    }
  };

  float run[8][4], acc_lo[8][4], acc_hi[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) run[m][e] = acc_lo[m][e] = acc_hi[m][e] = 0.f;
  float4 s_lo[4], s_hi[4];  // this lane's 16 columns' scales, low and high group

#pragma unroll
  for (int q = 0; q < kStages; ++q) issue(q, q);

  for (int q = 0; q < n_steps; ++q) {
    const int stage = q % kStages;
    if (q % 8 == 0) {  // a new chunk: fetch its two groups' scales early
      const int c = c_begin + q / 8;
      const float4* lo = reinterpret_cast<const float4*>(scale + (long long)c * n + n0 + 16 * g);
      const float4* hi =
          reinterpret_cast<const float4*>(scale + (long long)(n_chunks + c) * n + n0 + 16 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s_lo[i] = __ldg(lo + i);
        s_hi[i] = __ldg(hi + i);
      }
    }
    mbar_wait(bars + 8 * stage, (q / kStages) & 1);
    const unsigned char* st = ring + stage * kStageBytes;
    uint4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // row 4t + j, 16-byte chunk g, after the swizzle
      const int row = 4 * t + j;
      w[j] = *reinterpret_cast<const uint4*>(st + row * 128 + ((g ^ (row & 7)) << 4));
    }
    uint32_t xb_lo[2], xb_hi[2];  // x[g][4t .. 4t + 3] of each half, as bf16 pairs
    if (sizeof(XT) == 2) {
      const uint2 l = *reinterpret_cast<const uint2*>(st + 16 * kCols + g * 32 + t * 8);
      const uint2 h = *reinterpret_cast<const uint2*>(st + 16 * kCols + kXBytes + g * 32 + t * 8);
      xb_lo[0] = l.x; xb_lo[1] = l.y; xb_hi[0] = h.x; xb_hi[1] = h.y;
    } else {
      const float4 l = *reinterpret_cast<const float4*>(st + 16 * kCols + g * 64 + t * 16);
      const float4 h =
          *reinterpret_cast<const float4*>(st + 16 * kCols + kXBytes + g * 64 + t * 16);
      xb_lo[0] = pack_bf16(l.x, l.y); xb_lo[1] = pack_bf16(l.z, l.w);
      xb_hi[0] = pack_bf16(h.x, h.y); xb_hi[1] = pack_bf16(h.z, h.w);
    }

    const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&w[0]);
    const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&w[1]);
    const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&w[2]);
    const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&w[3]);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      // bytes 2m, 2m+1 of rows (0, 1) and of rows (2, 3), one word each
      const uint32_t sel = (m & 1) ? 0x7632u : 0x5410u;
      const uint32_t z01 = prmt(w0[m >> 1], w1[m >> 1], sel);
      const uint32_t z23 = prmt(w2[m >> 1], w3[m >> 1], sel);
      const uint32_t a_lo[4] = {nibbles_bf16<0>(z01), nibbles_bf16<8>(z01),
                                nibbles_bf16<0>(z23), nibbles_bf16<8>(z23)};
      const uint32_t a_hi[4] = {nibbles_bf16<4>(z01), nibbles_bf16<12>(z01),
                                nibbles_bf16<4>(z23), nibbles_bf16<12>(z23)};
      mma_bf16_16816(acc_lo[m], a_lo, xb_lo[0], xb_lo[1]);
      mma_bf16_16816(acc_hi[m], a_hi, xb_hi[0], xb_hi[1]);
    }
    __syncwarp();  // every lane has read the stage: refill it
    issue(q + kStages, stage);

    if (q % 8 == 7) {  // the chunk is done: scale each group's dots, add them
      const float* sl = reinterpret_cast<const float*>(s_lo);
      const float* sh = reinterpret_cast<const float*>(s_hi);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * m + (e >> 1);  // A row g -> byte 2m, g + 8 -> 2m + 1
          run[m][e] += __fadd_rn(__fmul_rn(acc_lo[m][e], sl[c]), __fmul_rn(acc_hi[m][e], sh[c]));
          acc_lo[m][e] = acc_hi[m][e] = 0.f;
        }
      }
    }
  }

  // the warp's sums as rows of kCols columns in its (now idle) ring
  float* rows = reinterpret_cast<float*>(ring);  // [8][kCols]
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rows[(2 * t + (e & 1)) * kCols + 16 * g + 2 * m + (e >> 1)] = run[m][e];
  cluster_sync();

  // this block's slice of the cluster's columns, 4 a thread: the splits'
  // sums in split order (cluster block, then warp), read from shared memory
  const int blocks = gridDim.y;  // the cluster: the blocks of this column block
  const int slice = kTiles * kCols / blocks;
  const int col_base = blockIdx.x * kTiles * kCols + (int)cluster_rank() * slice;
  for (int i = threadIdx.x * 4; i < nb * slice; i += kThreads * 4) {
    const int r = i / slice, c = col_base + i % slice;
    if (c >= n) continue;
    const int ct = c % (kTiles * kCols);  // the tile and column within the block
    const uint32_t addr =
        base + (ct / kCols) * kRingBytes + (r * kCols + ct % kCols) * (int)sizeof(float);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < blocks * kSplits; s0 += 16) {  // 16 loads in flight
      float4 p[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)  // split s0 + j: block (s0 + j) / kSplits, warp row j % kSplits
        if (s0 + j < blocks * kSplits)
          p[j] = ld_cluster_f4(addr + ((s0 + j) % kSplits) * kTiles * kRingBytes,
                               (s0 + j) / kSplits);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (s0 + j < blocks * kSplits) {
          v.x += p[j].x; v.y += p[j].y; v.z += p[j].z; v.w += p[j].w;
        }
    }
    store4(out + (long long)r * n + c, v);
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int cols, int rows,
             long long row_bytes, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename XT, int kTiles>
int launch_tiles(const CUtensorMap& tw, const CUtensorMap& tx, const float* scale, void* out,
                 int b, int kp, int n, int blocks_k, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(w4a16_kernel<XT, kTiles>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess && blocks_k > 8)  // clusters above 8 blocks are opt-in
    e = cudaFuncSetAttribute(w4a16_kernel<XT, kTiles>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n / kCols + kTiles - 1) / kTiles, blocks_k);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = blocks_k;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w4a16_kernel<XT, kTiles>, tw, tx, scale, static_cast<XT*>(out),
                         b, kp, n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename XT>
int launch(const void* x, const void* packed, const float* scale, void* out, int b, int kp, int n,
           int tiles, int blocks_k, cudaStream_t stream) {
  CUtensorMap tw, tx;
  // the packed weight, [kp rows, n bytes]: boxes of 16 rows x 128 columns
  int err = make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, n, kp, n, kCols, 16,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  // x, [b rows, 2 kp]: boxes of 8 rows (past b: zeros) x 16 k
  const CUtensorMapDataType xt =
      sizeof(XT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!err)
    err = make_map(&tx, xt, x, 2 * kp, b, 2LL * kp * sizeof(XT), 16, 8,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  if (tiles == 4) return launch_tiles<XT, 4>(tw, tx, scale, out, b, kp, n, blocks_k, stream);
  return launch_tiles<XT, 1>(tw, tx, scale, out, b, kp, n, blocks_k, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for an
// unknown dtype, a row count outside 1..8 or a shape the kernel does not
// tile. `dtype`: 0 = float32, 1 = bfloat16, for x [b, 2 * kp] and out
// [b, n] alike (contiguous, 16-byte aligned). packed uint8 [kp, n] and scale
// fp32 [kp / 64, n], contiguous and 16-byte aligned, with kp % 128 == 0 and
// n % 128 == 0. A block owns `tiles` (4 or 1) neighbouring 128-column tiles;
// `blocks_k` blocks (a cluster) share them: a power of two up to 16 and
// kp / 128 (a warp whose run of chunks is empty adds zeros).
int dl_w4a16(const void* x, const void* packed, const float* scale, void* out, int dtype, int b,
             int kp, int n, int tiles, int blocks_k, void* stream) {
  if (kp <= 0 || n <= 0 || kp % kChunk || n % kCols || b < 1 || b > 8 ||
      (tiles != 4 && tiles != 1) || blocks_k < 1 || blocks_k > 16 ||
      (blocks_k & (blocks_k - 1)) || blocks_k > kp / kChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, packed, scale, out, b, kp, n, tiles, blocks_k, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, packed, scale, out, b, kp, n, tiles, blocks_k, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
