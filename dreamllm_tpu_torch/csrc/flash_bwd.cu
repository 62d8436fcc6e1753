// Flash-attention backward for Hopper (sm_90a), bf16 in/out, fp32 accumulation.
//
// Replaces the TPU kernel `_flash_bwd_kernel` of dreamllm_tpu/ops/attention.py
// (launched by `_flash_attention_bwd_tpu`). Same function: from q, k, v, dO,
// the forward's output O and its fp32 log-sum-exp it computes
//   delta = rowsum(dO * O)
//   P  = exp(S * scale - LSE)            exactly, no running max
//   dV = P^T dO,  dP = dO V^T
//   dS = P * (dP - delta) * scale
//   dK = dS^T Q,  dQ = dS K
// with P and dS rounded to bf16 before their products, the causal mask
// (sq == skv), the segment mask (equal ids and a nonzero query id) and GQA by
// head index. Masked pairs have P = 0 by the mask itself, never by the LSE,
// so padding rows (segment 0) get dQ = 0 and add nothing to dK/dV.
//
// Bound on an H100 SXM: 10 * pairs * Hq * D flops (five products) against
// q, k, v, dO, O read and dQ, dK, dV written once; at the decoder's training
// shape (causal B1 H32 S2048 D128) that is 86.9 us of tensor-core time
// against 40 us of HBM time, so operations bound it.
//
// Design. The TPU kernel is one pass that emits per-KV-block fp32 dQ partials
// because a Pallas output block cannot be revisited; that serves its
// sequential grid and is not carried over. Here blocks run in no order, so
// the deterministic form is two passes and no atomics:
//   pass 1 (dK/dV): one 128-thread block owns a 64-row K/V tile of one KV
//     head, loops over the query heads of its group and over the query tiles
//     (causal: from the diagonal on), keeps dK and dV in fp32 registers and
//     writes them once - GQA needs no per-query-head copies;
//   pass 2 (dQ): one block owns a 64-row query tile of one head, loops over
//     the K/V tiles (causal: up to the diagonal), recomputes S and dP, and
//     writes dQ once.
// Pass 2 repeats two of the five products (7 in all against the TPU's 5);
// that is the price of a race-free dQ without partials in HBM.
// All products run on the tensor cores with mma.sync m16n8k16 (bf16
// operands, fp32 accumulation), each warp owning 16 rows of the tile its
// block owns; the scores are computed transposed in pass 1 (keys as rows) so
// that the P^T and dS^T accumulators are reused in registers as the A
// operands of the dV and dK products, as the forward reuses S for P V. The
// streamed tiles go through a two-stage cp.async ring and every operand
// fragment is read from shared memory with ldmatrix. A 64-wide tile is
// processed as two 32-wide halves to keep the live accumulators of D = 128
// (dK + dV = 128 registers a thread) under the register limit. wgmma, TMA and
// warp specialisation are later work. A small third kernel computes delta,
// one warp per (batch, row, head).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;    // rows of every tile, queries and keys alike
constexpr int kSub = 32;      // columns of the score tile processed at once
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  // src-size 0 zero-fills the 16 bytes: rows past the sequence end read as 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const __nv_bfloat16* o;
  const float* lse;    // [B, Hq, Sq]
  float* delta;        // [B, Hq, Sq] scratch, written by the delta kernel
  const int* qseg;     // [B, Sq] (row stride qseg_sb) or null
  const int* kseg;     // [B, Skv] (row stride kseg_sb) or null
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int batch, sq, skv, hq, groups;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, o_sb, o_ss, o_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  long long qseg_sb, kseg_sb;
  float sm_scale;
  float scale_log2;    // sm_scale * log2(e): P is computed in base 2
  int causal;
};

// Stage a [64, D] bf16 tile (rows row0.., head h, batch b) into shared memory
// with pitch D + 8; rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          long long sb, long long ss, long long sh,
                                          int b, int h, int row0, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kPitch = D + 8;
  static_assert((64 * kChunks) % kThreads == 0, "tile must split evenly over the block");
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + r < rows;
    const __nv_bfloat16* src =
        valid ? g + b * sb + (long long)(row0 + r) * ss + h * sh + col : g;
    cp_async_16(s + r * kPitch + col, src, valid);
  }
}

// Fragment loads with ldmatrix, one instruction for four 8x8 blocks of a
// row-major [rows][depth] tile (a 32-bit load per register would cost four
// times the shared-memory loads).
//
// A operand, 16 rows x 16 depth at depth kk*16: the four blocks are (rows
// 0-7, depth 0-7), (rows 8-15, depth 0-7), (rows 0-7, depth 8-15), (rows
// 8-15, depth 8-15), the order of a0..a3. `tile_rows` points at the first of
// the 16 rows.
template <int kPitch>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile_rows,
                                       int kk, int lane) {
  ldmatrix_x4(a, tile_rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + kk * 16 +
                     (lane >> 4) * 8);
}

// B operand ("col": memory is [n][depth]) of two neighbouring n-tiles, 16 rows
// x 16 depth at depth kk*16: b[0], b[1] are the first tile's b0, b1 and b[2],
// b[3] the second's. `tile_rows` points at the first of the 16 rows.
template <int kPitch>
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const __nv_bfloat16* tile_rows,
                                        int kk, int lane) {
  ldmatrix_x4(b, tile_rows + ((lane & 7) + (lane >> 4) * 8) * kPitch + kk * 16 +
                     ((lane >> 3) & 1) * 8);
}

// Write this thread's two rows of a [16, D] fp32 accumulator as bf16.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long sb, long long ss,
                                           long long sh, int b, int h, int row_a, int rows,
                                           int t, const float (&acc)[D / 8][4]) {
  if (row_a < rows) {
    __nv_bfloat16* dst = out + b * sb + (long long)row_a * ss + h * sh + t * 2;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) = pack_bf16(acc[nd][0], acc[nd][1]);
  }
  if (row_a + 8 < rows) {
    __nv_bfloat16* dst = out + b * sb + (long long)(row_a + 8) * ss + h * sh + t * 2;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) = pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

// ---------------------------------------------------------------------------
// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]; one warp per row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(const Params p) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const long long n_rows = (long long)p.batch * p.sq * p.hq;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int h = (int)(row % p.hq);
  const int s = (int)((row / p.hq) % p.sq);
  const int b = (int)(row / ((long long)p.hq * p.sq));
  constexpr int kPer = D / 32;  // 2 or 4 bf16 a lane
  const __nv_bfloat16* a = p.dout + b * p.do_sb + (long long)s * p.do_ss + h * p.do_sh + lane * kPer;
  const __nv_bfloat16* c = p.o + b * p.o_sb + (long long)s * p.o_ss + h * p.o_sh + lane * kPer;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; i += 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + i));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(c + i));
    acc += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffff, acc, off);
  if (lane == 0) p.delta[((long long)b * p.hq + h) * p.sq + s] = acc;
}

// ---------------------------------------------------------------------------
// pass 1: dK and dV. Block = (K/V tile, KV head, batch).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  constexpr int kPitch = D + 8;
  constexpr int kTile = 64 * kPitch;
  constexpr int kDSteps = D / 16;
  constexpr int kDTiles = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sQ = sV + kTile;        // 2 stages
  __nv_bfloat16* sdO = sQ + 2 * kTile;   // 2 stages
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kTile);  // 2 x 64, in base-2 units
  float* sDelta = sLse + 2 * kBlock;                         // 2 x 64
  int* sQseg = reinterpret_cast<int*>(sDelta + 2 * kBlock);  // 2 x 64

  const int ik = blockIdx.x;  // causal: tile 0 has the most query tiles and starts first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = ik * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int n_qtiles = (p.sq + kBlock - 1) / kBlock;
  const int iq_first = p.causal ? ik : 0;  // query tiles before the diagonal see none of these keys
  const int n_q = n_qtiles - iq_first;
  const int n_it = n_q > 0 ? n_q * p.groups : 0;

  const bool use_seg = p.qseg != nullptr;
  const int row_a = k0 + warp * 16 + g;  // this thread's two key rows
  const int row_b = row_a + 8;
  int kseg_a = 0, kseg_b = 0;
  if (use_seg) {
    if (row_a < p.skv) kseg_a = p.kseg[b * p.kseg_sb + row_a];
    if (row_b < p.skv) kseg_b = p.kseg[b * p.kseg_sb + row_b];
  }

  auto load_q = [&](int it, int stage) {
    const int h = hk * p.groups + it / n_q;
    const int q0 = (iq_first + it % n_q) * kBlock;
    load_tile<D>(sQ + stage * kTile, p.q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.sq);
    load_tile<D>(sdO + stage * kTile, p.dout, p.do_sb, p.do_ss, p.do_sh, b, h, q0, p.sq);
    if (threadIdx.x < kBlock) {
      const int qr = q0 + threadIdx.x;
      const bool valid = qr < p.sq;
      const long long off = ((long long)b * p.hq + h) * p.sq + qr;
      sLse[stage * kBlock + threadIdx.x] = valid ? p.lse[off] * kLog2e : 0.f;
      sDelta[stage * kBlock + threadIdx.x] = valid ? p.delta[off] : 0.f;
      if (use_seg)
        sQseg[stage * kBlock + threadIdx.x] = valid ? p.qseg[b * p.qseg_sb + qr] : 0;
    }
  };

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  if (n_it > 0) {
    load_tile<D>(sK, p.k, p.k_sb, p.k_ss, p.k_sh, b, hk, k0, p.skv);
    load_tile<D>(sV, p.v, p.v_sb, p.v_ss, p.v_sh, b, hk, k0, p.skv);
    load_q(0, 0);
    cp_async_commit();
  }

  const __nv_bfloat16* ka = sK + warp * 16 * kPitch;  // this warp's 16 key rows
  const __nv_bfloat16* va = sV + warp * 16 * kPitch;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* q_s = sQ + stage * kTile;
    const __nv_bfloat16* do_s = sdO + stage * kTile;
    const int q0 = (iq_first + it % n_q) * kBlock;

#pragma unroll 1
    for (int half = 0; half < kBlock / kSub; ++half) {
      const int qoff = half * kSub;
      // S^T = K Q^T and dP^T = V dO^T: 16 key rows x 32 queries (4 n-tiles)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        uint32_t ak[4], av[4];
        load_a<kPitch>(ak, ka, kk, lane);
        load_a<kPitch>(av, va, kk, lane);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t bq[4], bd[4];
          load_b2<kPitch>(bq, q_s + (qoff + nt * 8) * kPitch, kk, lane);
          load_b2<kPitch>(bd, do_s + (qoff + nt * 8) * kPitch, kk, lane);
          mma_bf16_16816(s[nt], ak, bq[0], bq[1]);
          mma_bf16_16816(s[nt + 1], ak, bq[2], bq[3]);
          mma_bf16_16816(dp[nt], av, bd[0], bd[1]);
          mma_bf16_16816(dp[nt + 1], av, bd[2], bd[3]);
        }
      }

      // P^T = exp2(S^T * scale_log2 - lse2), dS^T = P^T (dP^T - delta) scale
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qoff + nt * 8 + t * 2 + (e & 1);
          const int qidx = q0 + qc;
          const int kidx = (e < 2) ? row_a : row_b;
          bool keep = qidx < p.sq && kidx < p.skv;
          if (p.causal) keep = keep && kidx <= qidx;
          if (use_seg) {
            const int qs = sQseg[stage * kBlock + qc];
            keep = keep && (((e < 2) ? kseg_a : kseg_b) == qs) && (qs != 0);
          }
          const float pv =
              keep ? exp2f(s[nt][e] * p.scale_log2 - sLse[stage * kBlock + qc]) : 0.f;
          const float ds = pv * (dp[nt][e] - sDelta[stage * kBlock + qc]) * p.sm_scale;
          s[nt][e] = pv;
          dp[nt][e] = ds;
        }
      }

      // dV += P^T dO and dK += dS^T Q over this half's 32 queries (2 k-steps)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        const int roff = (qoff + kk * 16 + (lane & 15)) * kPitch + (lane >> 4) * 8;
#pragma unroll
        for (int nd = 0; nd < kDTiles; nd += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, do_s + roff + nd * 8);
          mma_bf16_16816(dv[nd], pa, bb[0], bb[1]);
          mma_bf16_16816(dv[nd + 1], pa, bb[2], bb[3]);
          ldmatrix_x4_trans(bb, q_s + roff + nd * 8);
          mma_bf16_16816(dk[nd], da, bb[0], bb[1]);
          mma_bf16_16816(dk[nd + 1], da, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  store_rows<D>(p.dk, p.dk_sb, p.dk_ss, p.dk_sh, b, hk, row_a, p.skv, t, dk);
  store_rows<D>(p.dv, p.dv_sb, p.dv_ss, p.dv_sh, b, hk, row_a, p.skv, t, dv);
}

// ---------------------------------------------------------------------------
// pass 2: dQ. Block = (query tile, query head, batch).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int kPitch = D + 8;
  constexpr int kTile = 64 * kPitch;
  constexpr int kDSteps = D / 16;
  constexpr int kDTiles = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kTile;
  __nv_bfloat16* sK = sdO + kTile;      // 2 stages
  __nv_bfloat16* sV = sK + 2 * kTile;   // 2 stages
  int* sKseg = reinterpret_cast<int*>(sV + 2 * kTile);  // 2 x 64

  const int n_qtiles = gridDim.x;
  // causal: heaviest query tiles first
  const int iq = p.causal ? n_qtiles - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.groups;
  const int q0 = iq * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  int n_ktiles = (p.skv + kBlock - 1) / kBlock;
  if (p.causal) n_ktiles = min(n_ktiles, iq + 1);  // skip tiles above the diagonal

  const bool use_seg = p.qseg != nullptr;
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  int qseg_a = 0, qseg_b = 0;
  float lse_a = 0.f, lse_b = 0.f, delta_a = 0.f, delta_b = 0.f;
  {
    const long long off = ((long long)b * p.hq + h) * p.sq;
    if (row_a < p.sq) {
      lse_a = p.lse[off + row_a] * kLog2e;
      delta_a = p.delta[off + row_a];
      if (use_seg) qseg_a = p.qseg[b * p.qseg_sb + row_a];
    }
    if (row_b < p.sq) {
      lse_b = p.lse[off + row_b] * kLog2e;
      delta_b = p.delta[off + row_b];
      if (use_seg) qseg_b = p.qseg[b * p.qseg_sb + row_b];
    }
  }

  auto load_kv = [&](int j, int stage) {
    load_tile<D>(sK + stage * kTile, p.k, p.k_sb, p.k_ss, p.k_sh, b, hk, j * kBlock, p.skv);
    load_tile<D>(sV + stage * kTile, p.v, p.v_sb, p.v_ss, p.v_sh, b, hk, j * kBlock, p.skv);
    if (use_seg && threadIdx.x < kBlock) {
      const int kr = j * kBlock + threadIdx.x;
      sKseg[stage * kBlock + threadIdx.x] = kr < p.skv ? p.kseg[b * p.kseg_sb + kr] : 0;
    }
  };

  load_tile<D>(sQ, p.q, p.q_sb, p.q_ss, p.q_sh, b, h, q0, p.sq);
  load_tile<D>(sdO, p.dout, p.do_sb, p.do_ss, p.do_sh, b, h, q0, p.sq);
  load_kv(0, 0);
  cp_async_commit();

  float dq[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const __nv_bfloat16* qa = sQ + warp * 16 * kPitch;  // this warp's 16 query rows
  const __nv_bfloat16* doa = sdO + warp * 16 * kPitch;

  for (int j = 0; j < n_ktiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_ktiles) {
      load_kv(j + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* k_s = sK + stage * kTile;
    const __nv_bfloat16* v_s = sV + stage * kTile;

#pragma unroll 1
    for (int half = 0; half < kBlock / kSub; ++half) {
      const int koff = half * kSub;
      // S = Q K^T and dP = dO V^T: 16 query rows x 32 keys (4 n-tiles)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        uint32_t aq[4], ad[4];
        load_a<kPitch>(aq, qa, kk, lane);
        load_a<kPitch>(ad, doa, kk, lane);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t bk[4], bv[4];
          load_b2<kPitch>(bk, k_s + (koff + nt * 8) * kPitch, kk, lane);
          load_b2<kPitch>(bv, v_s + (koff + nt * 8) * kPitch, kk, lane);
          mma_bf16_16816(s[nt], aq, bk[0], bk[1]);
          mma_bf16_16816(s[nt + 1], aq, bk[2], bk[3]);
          mma_bf16_16816(dp[nt], ad, bv[0], bv[1]);
          mma_bf16_16816(dp[nt + 1], ad, bv[2], bv[3]);
        }
      }

#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = koff + nt * 8 + t * 2 + (e & 1);
          const int kidx = j * kBlock + kc;
          const int qidx = (e < 2) ? row_a : row_b;
          bool keep = qidx < p.sq && kidx < p.skv;
          if (p.causal) keep = keep && kidx <= qidx;
          if (use_seg) {
            const int qs = (e < 2) ? qseg_a : qseg_b;
            keep = keep && (sKseg[stage * kBlock + kc] == qs) && (qs != 0);
          }
          const float pv =
              keep ? exp2f(s[nt][e] * p.scale_log2 - ((e < 2) ? lse_a : lse_b)) : 0.f;
          dp[nt][e] = pv * (dp[nt][e] - ((e < 2) ? delta_a : delta_b)) * p.sm_scale;
        }
      }

      // dQ += dS K over this half's 32 keys (2 k-steps)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t da[4];
        da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        const int roff = (koff + kk * 16 + (lane & 15)) * kPitch + (lane >> 4) * 8;
#pragma unroll
        for (int nd = 0; nd < kDTiles; nd += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, k_s + roff + nd * 8);
          mma_bf16_16816(dq[nd], da, bb[0], bb[1]);
          mma_bf16_16816(dq[nd + 1], da, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }

  store_rows<D>(p.dq, p.dq_sb, p.dq_ss, p.dq_sh, b, h, row_a, p.sq, t, dq);
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t kTiles = 6 * 64 * (D + 8) * sizeof(__nv_bfloat16);
  constexpr size_t kSmemDkv = kTiles + 2 * kBlock * (2 * sizeof(float) + sizeof(int));
  constexpr size_t kSmemDq = kTiles + 2 * kBlock * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemDkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemDq);
  if (err != cudaSuccess) return (int)err;

  const long long n_rows = (long long)p.batch * p.sq * p.hq;
  const int rows_per_block = kThreads / 32;
  flash_bwd_delta_kernel<D>
      <<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_qtiles = (p.sq + kBlock - 1) / kBlock;
  const int n_ktiles = (p.skv + kBlock - 1) / kBlock;
  flash_bwd_dkv_kernel<D>
      <<<dim3(n_ktiles, p.hq / p.groups, p.batch), kThreads, kSmemDkv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<dim3(n_qtiles, p.hq, p.batch), kThreads, kSmemDq, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for an
// unsupported head dim. Pointers and strides are in elements; the last dim
// of every bf16 tensor is contiguous and rows are 16-byte aligned (checked
// by the caller). `delta` is fp32 scratch of the LSE's shape [B, Hq, Sq].
int dl_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const void* o, const float* lse, float* delta,
                      const int* qseg, const int* kseg, void* dq, void* dk, void* dv,
                      int batch, int sq, int skv, int hq, int hkv, int d,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh,
                      long long do_sb, long long do_ss, long long do_sh,
                      long long o_sb, long long o_ss, long long o_sh,
                      long long dq_sb, long long dq_ss, long long dq_sh,
                      long long dk_sb, long long dk_ss, long long dk_sh,
                      long long dv_sb, long long dv_ss, long long dv_sh,
                      long long qseg_sb, long long kseg_sb,
                      float sm_scale, int causal, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.lse = lse;
  p.delta = delta;
  p.qseg = qseg;
  p.kseg = kseg;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.batch = batch;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.groups = hq / hkv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.qseg_sb = qseg_sb;
  p.kseg_sb = kseg_sb;
  p.sm_scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(p, s);
  if (d == 128) return launch<128>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
