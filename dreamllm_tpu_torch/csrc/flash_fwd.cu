// Flash-attention forward for Hopper (sm_90a), bf16 in/out, fp32 statistics.
//
// Replaces the TPU kernel `_flash_kernel_t` of dreamllm_tpu/ops/attention.py
// (launched by `_flash_attention_tpu`). Same function: online-softmax
// attention over BSHD q/k/v, optional causal mask (sq == skv), optional
// segment mask (equal ids and a nonzero query id), GQA by head index, and an
// optional fp32 log-sum-exp per query row. Masked scores are the finite
// NEG_INF = -1e30, so a fully masked row emits mean(V) as in the JAX
// contract and never NaN.
//
// Bound on an H100 SXM: at the UNet's shapes (D = 64, S = 1024 and 4096)
// the kernel does 4*B*H*Sq*Skv*D flops against (q + k + v + o) bytes, about
// 2000 flops per byte at S = 4096, so the tensor cores (989 TFLOP/s bf16
// dense) bound it, not the 3.35 TB/s of HBM: 43 us for B2 H5 S4096 D64. At
// D = 64 the softmax's exponentials (one per score, 16 a clock on an SM's
// MUFU units) take as long as the products, so they have to overlap.
//
// Design. One block of three warpgroups per (128-row query tile, head,
// batch); causal blocks run heaviest first and skip key tiles above the
// diagonal.
// - Warpgroup 0 is the producer: after `setmaxnreg` gives its registers to
//   the consumers, one thread issues TMA loads (Q once; K and V tiles of 128
//   rows into a ring of 3 stages at D = 64, 2 at D = 128), each box 64
//   columns wide with the 128-byte swizzle, over 4-D tensor maps of the
//   BSHD views with their real strides; TMA zero-fills rows past the end.
//   Its first warp also stages the key tile's segment ids in shared memory.
//   Full and empty mbarriers, separate for K and V, hand the stages over.
// - Warpgroups 1 and 2 each own 64 query rows. S = Q K^T is one wgmma
//   m64n128k16 per 16 columns of D, both operands K-major from shared
//   memory. P is rounded to bf16 in registers and fed as wgmma's register A
//   operand for O += P V, with V the MN-major B operand in shared memory.
// - Overlap: each iteration issues the next tile's Q K^T and the previous
//   tile's P V together, then runs the softmax of the new scores while P V
//   is still in flight, and rescales O once it lands. The two consumer
//   warpgroups also cover each other's softmax on the tensor cores.
// - Per-element mask compares run only on tiles that need them: the causal
//   diagonal, the ragged last key tile, and every tile of a call with
//   segment ids. Other tiles only scale.
// - Epilogue: O normalised and stored as bf16 straight from the
//   accumulators; the LSE in natural-log units, fp32.
// Nothing is atomic and every sum has a fixed order, so the same inputs
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;  // query rows a block (two consumer warpgroups of 64)
constexpr int kBN = 128;  // keys a tile
constexpr int kThreads = 384;
constexpr float kNegInf = -1e30f;  // finite: (-1e30) - (-1e30) = 0, never NaN
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int kHalves = D / 64;             // 64-column TMA boxes a row
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;       // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kSeg = kV + kStages * kKVBytes;   // int [stages][kBN]
  static constexpr int kBar = kSeg + kStages * kBN * 4;  // 1 + 4 * stages mbarriers
  static constexpr int kBytes = kBar + (1 + 4 * kStages) * 8;
  static constexpr int kSmem = kBytes + 1024;            // room to align the base
};

struct Params {
  __nv_bfloat16* o;
  float* lse;         // [B, Hq, Sq] or null
  const int* qseg;    // [B, Sq] (row stride qseg_sb) or null
  const int* kseg;    // [B, Skv] (row stride kseg_sb) or null
  int sq, skv, hq, groups;
  long long o_sb, o_ss, o_sh;
  long long qseg_sb, kseg_sb;
  float scale_log2;   // sm_scale * log2(e): softmax runs in base 2
  int causal;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Scale a tile of scores into base-2 units and, where the tile needs it,
// mask: NEG_INF where causality or the segments drop a key, -inf past the
// end of the keys (weight 0, as if the key did not exist). s[4i + e] holds
// row a (e < 2) or row b (e >= 2), key 8i + 2t + (e & 1) of the tile.
template <bool kMask>
__device__ __forceinline__ void scale_mask(float (&s)[kBN / 2], const Params& p, int k0,
                                           int row_a, int row_b, int qs_a, int qs_b,
                                           const int* seg, int t) {
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * p.scale_log2;
      if (kMask) {
        const int kc = 8 * i + 2 * t + (e & 1);
        const int kidx = k0 + kc;
        bool keep = !p.causal || kidx <= (e < 2 ? row_a : row_b);
        if (p.kseg != nullptr) {
          const int qs = e < 2 ? qs_a : qs_b;
          keep = keep && seg[kc] == qs && qs != 0;
        }
        if (!keep) x = kNegInf;
        if (kidx >= p.skv) x = __int_as_float(0xff800000);
      }
      s[4 * i + e] = x;
    }
  }
}

// Online softmax over one scaled tile: the running max and sum of rows a
// and b move on, s becomes exp2(s - max) in place, and the factors that
// rescale the rows' earlier output come back in alpha_a/alpha_b.
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], float& m_a, float& m_b,
                                             float& l_a, float& l_b, float& alpha_a,
                                             float& alpha_b) {
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  alpha_a = ex2(m_a - mx_a);
  alpha_b = ex2(m_b - mx_b);
  m_a = mx_a;
  m_b = mx_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    s[4 * i] = ex2(s[4 * i] - mx_a);
    s[4 * i + 1] = ex2(s[4 * i + 1] - mx_a);
    s[4 * i + 2] = ex2(s[4 * i + 2] - mx_b);
    s[4 * i + 3] = ex2(s[4 * i + 3] - mx_b);
    sum_a += s[4 * i] + s[4 * i + 1];
    sum_b += s[4 * i + 2] + s[4 * i + 3];
  }
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
}

// P (bf16) as the A fragments of the P V products: key steps of 16, each
// the S accumulators of two 8-key column blocks
__device__ __forceinline__ void to_bf16_fragments(const float (&s)[kBN / 2],
                                                  uint32_t (&pf)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], float alpha_a, float alpha_b) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i] *= alpha_a;
    o[4 * i + 1] *= alpha_a;
    o[4 * i + 2] *= alpha_b;
    o[4 * i + 3] *= alpha_b;
  }
}

// S = Q K^T for this warpgroup's 64 rows: D/16 steps of k16. Within a
// 64-column box the k-step moves the descriptor by 32 bytes (the swizzle is
// applied by address); the next box is kBM (Q) or kBN (K) rows further.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t da = wgmma_desc(q_base + (kk >> 2) * kBM * 128 + off, 16, 1024);
    const uint64_t db = wgmma_desc(k_base + (kk >> 2) * kBN * 128 + off, 16, 1024);
    wgmma_ss<kBN>(s, da, db, kk > 0);
  }
}

// O += P V: kBN/16 steps of 16 keys (2048 bytes of V each); V is MN-major,
// its second 64 columns (D = 128) kBN rows further on
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[kBN / 16][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = wgmma_desc(v_base + kk * 16 * 128, kBN * 128, 1024);
    wgmma_rs_mn<D>(o, pf[kk], db, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the swizzle atoms of TMA and wgmma
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + C::kQ, sK = base + C::kK, sV = base + C::kV;
  int* sSeg = reinterpret_cast<int*>(smem + C::kSeg);
  const uint32_t bar_q = base + C::kBar;
  auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty_k = [&](int s) { return bar_q + 8 * (1 + S + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (1 + 2 * S + s); };
  auto empty_v = [&](int s) { return bar_q + 8 * (1 + 3 * S + s); };

  const int n_qtiles = gridDim.x;
  const int iq = p.causal ? n_qtiles - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.groups;
  const int q0 = iq * kBM;
  int n_ktiles = (p.skv + kBN - 1) / kBN;
  if (p.causal) n_ktiles = min(n_ktiles, (q0 + kBM - 1) / kBN + 1);  // skip above the diagonal
  const bool use_seg = p.kseg != nullptr;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // lane 0 of each consumer warp
      mbar_init(empty_v(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int x = 0; x < C::kHalves; ++x)
        tma_load_4d(sQ + x * kBM * 128, &tq, bar_q, 64 * x, h, q0, b);
    }
    for (int j = 0; j < n_ktiles; ++j) {
      const int s = j % S;
      const uint32_t ph = ((j / S) & 1) ^ 1;
      mbar_wait(empty_k(s), ph);
      if (use_seg) {
#pragma unroll
        for (int e = 0; e < kBN / 32; ++e) {
          const int kr = j * kBN + lane + 32 * e;
          sSeg[s * kBN + lane + 32 * e] = kr < p.skv ? p.kseg[b * p.kseg_sb + kr] : 0;
        }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(full_k(s), C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kHalves; ++x)
          tma_load_4d(sK + s * C::kKVBytes + x * kBN * 128, &tk, full_k(s), 64 * x, hk, j * kBN, b);
      }
      mbar_wait(empty_v(s), ph);
      if (lane == 0) {
        mbar_arrive_expect_tx(full_v(s), C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kHalves; ++x)
          tma_load_4d(sV + s * C::kKVBytes + x * kBN * 128, &tv, full_v(s), 64 * x, hk, j * kBN, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int g = lane >> 2;  // row within the warp's 16 (and +8)
    const int t = lane & 3;   // column pair within each 8-column block
    const int wg_row0 = q0 + cw * 64;
    const int row_a = wg_row0 + warp * 16 + g;
    const int row_b = row_a + 8;
    int qs_a = 0, qs_b = 0;
    if (use_seg) {
      if (row_a < p.sq) qs_a = p.qseg[b * p.qseg_sb + row_a];
      if (row_b < p.sq) qs_b = p.qseg[b * p.qseg_sb + row_b];
    }
    const uint32_t q_base = sQ + cw * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[kBN / 2];
    uint32_t pf[kBN / 16][4];
    float m_a = kNegInf, m_b = kNegInf;  // running max (base-2 units), rows a/b
    float l_a = 0.f, l_b = 0.f;          // per-thread partial row sums
    float alpha_a, alpha_b;

    // a tile needs per-element compares when it crosses this warpgroup's
    // causal diagonal, runs past the last key, or the call has segments
    auto needs_mask = [&](int j) {
      return use_seg || (j + 1) * kBN > p.skv ||
             (p.causal && (j + 1) * kBN - 1 > wg_row0);
    };
    auto score_tile = [&](int j) {
      const int st = j % S;
      if (needs_mask(j))
        scale_mask<true>(s, p, j * kBN, row_a, row_b, qs_a, qs_b, sSeg + st * kBN, t);
      else
        scale_mask<false>(s, p, j * kBN, row_a, row_b, qs_a, qs_b, sSeg + st * kBN, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k(st));  // K and its segment ids are free
      softmax_tile(s, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
    };

    mbar_wait(bar_q, 0);

    // tile 0: scores alone
    mbar_wait(full_k(0), 0);
    wgmma_fence();
    issue_qk<D>(s, q_base, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    score_tile(0);
    to_bf16_fragments(s, pf);

    for (int j = 1; j < n_ktiles; ++j) {
      const int st = j % S, sp = (j - 1) % S;
      mbar_wait(full_k(st), (j / S) & 1);
      wgmma_fence();
      issue_qk<D>(s, q_base, sK + st * C::kKVBytes);
      wgmma_commit();
      mbar_wait(full_v(sp), ((j - 1) / S) & 1);
      issue_pv<D>(o, pf, sV + sp * C::kKVBytes);
      wgmma_commit();
      wgmma_wait<1>();  // the scores of tile j; P V of tile j-1 may still run
      fence_regs(s);
      score_tile(j);
      wgmma_wait<0>();
      fence_regs(o);
      for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(pf[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v(sp));
      rescale<D>(o, alpha_a, alpha_b);
      to_bf16_fragments(s, pf);
    }

    // P V of the last tile
    {
      const int sp = (n_ktiles - 1) % S;
      mbar_wait(full_v(sp), ((n_ktiles - 1) / S) & 1);
      wgmma_fence();
      issue_pv<D>(o, pf, sV + sp * C::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v(sp));
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
    const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);

    if (row_a < p.sq) {
      __nv_bfloat16* out = p.o + b * p.o_sb + (long long)row_a * p.o_ss + h * p.o_sh + t * 2;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + i * 8) =
            pack_bf16(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
      if (p.lse != nullptr && t == 0)
        p.lse[((long long)b * p.hq + h) * p.sq + row_a] = (m_a + log2f(fmaxf(l_a, 1e-30f))) * kLn2;
    }
    if (row_b < p.sq) {
      __nv_bfloat16* out = p.o + b * p.o_sb + (long long)row_b * p.o_ss + h * p.o_sh + t * 2;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + i * 8) =
            pack_bf16(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
      if (p.lse != nullptr && t == 0)
        p.lse[((long long)b * p.hq + h) * p.sq + row_b] = (m_b + log2f(fmaxf(l_b, 1e-30f))) * kLn2;
    }
  }
}

// A 4-D tensor map over a BSHD bf16 view (dims innermost first: D, H, S, B;
// strides in elements), boxes of 64 columns x `rows` rows of one head and
// one batch, 128-byte swizzle. Rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int d, int heads, int seq, int batch,
             long long sb, long long ss, long long sh, int rows) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p, int batch, int hkv,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, p.hq, p.sq, batch, q_sb, q_ss, q_sh, kBM);
  if (!err) err = make_map(&tk, k, D, hkv, p.skv, batch, k_sb, k_ss, k_sh, kBN);
  if (!err) err = make_map(&tv, v, D, hkv, p.skv, batch, v_sb, v_ss, v_sh, kBN);
  if (err) return err;
  constexpr int kSmem = Cfg<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.sq + kBM - 1) / kBM, p.hq, batch);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for an
// unsupported head dim or a view TMA cannot describe. Pointers and strides
// are in elements; the last dim of q/k/v/o is contiguous, bases are 16-byte
// aligned and the other strides multiples of 8 (checked by the caller).
int dl_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                      const int* qseg, const int* kseg,
                      int batch, int sq, int skv, int hq, int hkv, int d,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh,
                      long long o_sb, long long o_ss, long long o_sh,
                      long long qseg_sb, long long kseg_sb,
                      float sm_scale, int causal, void* stream) {
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.qseg = qseg;
  p.kseg = kseg;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.groups = hq / hkv;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.qseg_sb = qseg_sb;
  p.kseg_sb = kseg_sb;
  p.scale_log2 = sm_scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, p, batch, hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                      v_sh, s);
  if (d == 128)
    return launch<128>(q, k, v, p, batch, hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                       v_sh, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
