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
// head index (dK and dV summed over the group in fp32 and rounded once).
// Masked pairs have P = 0 by the mask itself, never by the LSE, so padding
// rows (segment 0) get dQ = 0 and add nothing to dK/dV.
//
// Bound on an H100 SXM: 10 * pairs * Hq * D flops (five products over the
// kept pairs) at 989 TFLOP/s against q, k, v, dO, O read and dQ, dK, dV
// written once at 3.35 TB/s; at the 7B training shape (causal + segments, B2
// H32 S2048 D128) that is 132 us of tensor-core time against 40 us of HBM
// time, so operations bound it, as everywhere but at short packed segments.
//
// Design. The TPU kernel is one pass that emits per-KV-block fp32 dQ partials
// because a Pallas output block cannot be revisited; that serves its
// sequential grid and is not carried over (the partials would be 0.5 GB a
// call at the training shape). Here blocks run in no order, so the
// deterministic form is two passes with no atomics and no scratch beyond
// delta and the segment ranges; the dQ pass repeats two of the five products
// (7 in all). Both passes run in one launch (first every dK/dV block, then
// every dQ block, so the dQ blocks fill the dK/dV pass's last wave) and have
// K1's block layout (csrc/flash_fwd.cu):
// - Warpgroup 0 is the producer: after `setmaxnreg` gives its registers to
//   the consumers, one warp stages the small per-row data (LSE, delta or
//   segment ids) of each streamed tile in shared memory and one thread
//   issues TMA loads into a ring of stages, 64-column boxes with the 128-byte
//   swizzle over 4-D tensor maps of the BSHD views with their real strides
//   (TMA zero-fills rows past the end). Full and empty mbarriers hand the
//   stages over.
// - Warpgroups 1 and 2 each own 64 of the block's 128 rows (240 registers a
//   thread) and run every product with wgmma: the two score-like products
//   from shared memory (SS, both operands K-major) and the accumulating ones
//   with the bf16-rounded P or dS as register A operands (RS, the streamed
//   tile as the MN-major B operand), as K1 feeds P V.
// - Overlap: the two consumer warpgroups take turns to issue their products
//   (ping-pong on named barriers), so one's products run while the other
//   computes exponentials. In the dQ pass each step also issues the new
//   tile's SS products with the previous tile's RS product; the dK/dV pass
//   has no registers for that. No wgmma sits in a branch on data: ptxas
//   would serialise every wgmma of the kernel.
// pass 1 (dK/dV): a block owns 128 K/V rows of one KV head, staged once, and
//   streams tiles of Q and dO (64 rows at D = 128, 128 at D = 64) with their
//   LSE, delta and segment ids over the group's query heads and the query
//   tiles (causal: from the diagonal on). Per tile S^T = K Q^T and
//   dP^T = V dO^T (SS), then dV += P^T dO and dK += dS^T Q (RS). LSE and delta
//   are per column of these accumulators and are read from the tile's staged
//   slice. dK and dV stay in fp32 registers (128 a thread at D = 128) and are
//   stored once as bf16.
// pass 2 (dQ): a block owns 128 query rows of one head, Q and dO staged once,
//   and streams K/V tiles (as above; causal: up to the diagonal). Per tile
//   S = Q K^T and dP = dO V^T (SS), then dQ += dS K (RS).
// - Skipping: causal tiles above the diagonal, and (with segment ids) every
//   tile pair that no kept pair lies in: a small kernel writes, for each
//   64-row chunk of queries and of keys, the minimum and maximum of its
//   nonzero ids and whether it holds a 0; a block skips a streamed tile when
//   its query rows have no nonzero id or the two ranges are disjoint. A block
//   whose loop is empty still stores zeros. `flash_bwd_tile_pairs` in
//   ops/attention.py is the same rule in plain PyTorch. Given a `tiles`
//   pointer, each block's producer adds the tiles it staged and the causal
//   tiles it walked to four int counters (dK/dV pass, dQ pass), so a caller
//   can read how many tile pairs the kernel computed.
// - Per-element mask compares run only on causal diagonal tiles, ragged last
//   tiles and segment tiles whose ids are not one and the same nonzero id on
//   both sides of a warpgroup's 64 rows.
// - Causal blocks start heaviest first: low K/V blocks in pass 1, high query
//   blocks in pass 2.
// Nothing the outputs depend on is atomic and every sum has a fixed order, so
// the same inputs give the same bits. A small kernel computes delta, D / 8 lanes per (batch, row,
// head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;  // rows a block owns (two consumer warpgroups of 64)
constexpr int kChunk = 64;  // rows of a segment-range chunk
constexpr int kThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;

// D: head dim; N: rows of a streamed tile
template <int D, int N>
struct Cfg {
  static constexpr int kHalves = D / 64;          // 64-column TMA boxes a row
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kOwnBytes = kBM * D * 2;   // one owned tile (K or V; Q or dO)
  static constexpr int kTileBytes = N * D * 2;    // one streamed tile
  // the owned pair, then the streamed pairs of every stage
  static constexpr int kA = 0;
  static constexpr int kB = kA + kOwnBytes;
  static constexpr int kX = kB + kOwnBytes;
  static constexpr int kY = kX + kStages * kTileBytes;
  static constexpr int kRow = kY + kStages * kTileBytes;  // 3 x [stages][N] 4-byte values
  static constexpr int kBar = kRow + 3 * kStages * N * 4;  // 1 + 2 * stages mbarriers
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kSmem = kBytes + 1024;     // room to align the base
};

struct Params {
  const __nv_bfloat16* dout;
  const __nv_bfloat16* o;
  const float* lse;    // [B, Hq, Sq]
  float* delta;        // [B, Hq, Sq] scratch, written by the delta kernel
  const int* qseg;     // [B, Sq] (row stride qseg_sb) or null
  const int* kseg;     // [B, Skv] (row stride kseg_sb) or null
  int4* qrange;        // [B, ceil(Sq / 64)] (lo, hi, has 0, -), written by the range kernel
  int4* krange;        // [B, ceil(Skv / 64)]
  int* tiles;          // null, or 4 counters: staged / causal tiles of each pass
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int batch, sq, skv, hq, hkv, groups;
  int n_kb, n_qb;      // 128-row K/V blocks (dK/dV pass) and query blocks (dQ pass)
  long long do_sb, do_ss, do_sh, o_sb, o_ss, o_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  long long qseg_sb, kseg_sb;
  float sm_scale;
  float scale_log2;    // sm_scale * log2(e): P is computed in base 2
  int causal;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The value of lane 0 in every lane, which ptxas then knows to be the same
// across the warp. Branches on the role, the skip rule and the mask take it:
// without these shuffles the kernel ran slower at every shape timed on an
// H100.
__device__ __forceinline__ int warp_uniform(int x) { return __shfl_sync(0xffffffffu, x, 0); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// segment ranges: (lo, hi) of the nonzero ids of a 64-row chunk (lo > hi when
// it has none) and whether it holds a 0
// ---------------------------------------------------------------------------

__device__ __forceinline__ int4 merge(int4 a, int4 b) {
  return make_int4(min(a.x, b.x), max(a.y, b.y), a.z | b.z, 0);
}

__device__ __forceinline__ int4 empty_range() { return make_int4(0x7fffffff, -0x7fffffff - 1, 0, 0); }

// no kept pair can lie in a (query chunk, key chunk) pair this rejects
__device__ __forceinline__ bool ranges_meet(int4 q, int4 k) {
  return q.x <= q.y && k.x <= k.y && q.x <= k.y && k.x <= q.y;
}

// every pair is kept: one and the same nonzero id on both sides
__device__ __forceinline__ bool ranges_uniform(int4 q, int4 k) {
  return q.x == q.y && k.x == k.y && q.x == k.x && !q.z && !k.z;
}

// the range of `count` chunks from `first` (those below n)
__device__ __forceinline__ int4 chunks_range(const int4* r, int first, int count, int n) {
  int4 x = empty_range();
  for (int c = first; c < min(n, first + count); ++c) x = merge(x, r[c]);
  return x;
}

__global__ void flash_bwd_range_kernel(const Params p) {
  const int nqc = (p.sq + kChunk - 1) / kChunk, nkc = (p.skv + kChunk - 1) / kChunk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.batch * (nqc + nkc)) return;
  const int b = i / (nqc + nkc), c = i % (nqc + nkc);
  const bool is_q = c < nqc;
  const int chunk = is_q ? c : c - nqc;
  const int* seg = is_q ? p.qseg + b * p.qseg_sb : p.kseg + b * p.kseg_sb;
  const int rows = is_q ? p.sq : p.skv;
  int4 r = empty_range();
  for (int x = chunk * kChunk; x < min(rows, (chunk + 1) * kChunk); ++x) {
    const int id = seg[x];
    if (id == 0) {
      r.z = 1;
    } else {
      r.x = min(r.x, id);
      r.y = max(r.y, id);
    }
  }
  if (is_q)
    p.qrange[b * nqc + chunk] = r;
  else
    p.krange[b * nkc + chunk] = r;
}

// ---------------------------------------------------------------------------
// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]; D / 8 lanes a row,
// 16 bytes of dO and of O a lane
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_delta_kernel(const Params p) {
  constexpr int kLanes = D / 8;
  const long long row = (long long)blockIdx.x * (128 / kLanes) + threadIdx.x / kLanes;
  const bool valid = row < (long long)p.batch * p.sq * p.hq;
  const int lane = threadIdx.x % kLanes;
  const int h = (int)(row % p.hq);
  const int s = (int)((row / p.hq) % p.sq);
  const int b = (int)(row / ((long long)p.hq * p.sq));
  uint4 x = make_uint4(0, 0, 0, 0), y = x;
  if (valid) {
    x = *reinterpret_cast<const uint4*>(p.dout + b * p.do_sb + (long long)s * p.do_ss +
                                        h * p.do_sh + lane * 8);
    y = *reinterpret_cast<const uint4*>(p.o + b * p.o_sb + (long long)s * p.o_ss + h * p.o_sh +
                                        lane * 8);
  }
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(xs[i]), c = __bfloat1622float2(ys[i]);
    acc += a.x * c.x + a.y * c.y;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffff, acc, off);
  if (valid && lane == 0) p.delta[((long long)b * p.hq + h) * p.sq + s] = acc;
}

// ---------------------------------------------------------------------------
// wgmma issue helpers
// ---------------------------------------------------------------------------

// acc[64 x N] = A[64 x D] B[N x D]^T, both K-major: D/16 steps of k16. In a
// 64-column box a k-step moves the descriptor 32 bytes (the swizzle is by
// address); the next box is `a_rows` (A) or N (B) rows further.
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a_base, int a_rows,
                                         uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t da = wgmma_desc(a_base + (kk >> 2) * a_rows * 128 + off, 16, 1024);
    const uint64_t db = wgmma_desc(b_base + (kk >> 2) * N * 128 + off, 16, 1024);
    wgmma_ss<N>(acc, da, db, kk > 0);
  }
}

// acc[64 x D] += F[64 x N] B[N x D] with F from registers: N/16 steps of 16
// rows of B (2048 bytes each), B MN-major, its second 64 columns (D = 128)
// one box (N rows) further on
template <int D, int N>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&f)[N / 16][4],
                                         uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t db = wgmma_desc(b_base + kk * 16 * 128, N * 128, 1024);
    wgmma_rs_mn<D>(acc, f[kk], db, 1);
  }
}

// Ping-pong of the two consumer warpgroups (named barriers 1 and 2, of both
// warpgroups' 256 threads): a warpgroup waits for its turn before it issues a
// tile's products and then passes the turn on, so one warpgroup's products
// run while the other computes its exponentials, where waiting on the same
// full barrier would otherwise keep the two in step.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + cw) : "memory");
}

__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + cw) : "memory");
}

// an accumulator as bf16 A fragments: k-steps of 16 columns, each the
// accumulators of two 8-column blocks
template <int N>
__device__ __forceinline__ void to_fragments(const float (&s)[N / 2], uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    f[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    f[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    f[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    f[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero_fragments(uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) f[i][0] = f[i][1] = f[i][2] = f[i][3] = 0u;
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(f[i]);
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

// Store a warpgroup's [64, D] fp32 accumulator as bf16 rows row_a, row_b
// (those below `rows`), straight from the registers.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, long long sb, long long ss,
                                          long long sh, int b, int h, int row_a, int rows, int t,
                                          const float (&acc)[D / 2]) {
  if (row_a < rows) {
    __nv_bfloat16* dst = out + b * sb + (long long)row_a * ss + h * sh + t * 2;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * 8) = pack_bf16(acc[4 * i], acc[4 * i + 1]);
  }
  if (row_a + 8 < rows) {
    __nv_bfloat16* dst = out + b * sb + (long long)(row_a + 8) * ss + h * sh + t * 2;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * 8) = pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ---------------------------------------------------------------------------
// pass 1: dK and dV. Block = (KV head, batch, 128-row K/V block).
// ---------------------------------------------------------------------------

// P^T and dS^T of one tile in place: s[4i + e] holds key row a (e < 2) or b,
// query column 8i + 2t + (e & 1) of the tile; LSE (base 2), delta and the
// query ids of the columns come from the tile's staged slice.
template <bool kMask, int N>
__device__ __forceinline__ void dkv_tile(float (&s)[N / 2], float (&dp)[N / 2],
                                         const Params& p, const float* lse, const float* delta,
                                         const int* qs, int q0, int row_a, int row_b, int ks_a,
                                         int ks_b, int t) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    // one 8-column block at a time: loads hoisted over the whole tile would
    // hold 48 registers beside dK, dV, S^T and dP^T
    asm volatile("" ::: "memory");
    const int c = 8 * i + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse + c);
    const float2 dl = *reinterpret_cast<const float2*>(delta + c);
    int2 qid = make_int2(0, 0);
    if (kMask && p.qseg != nullptr) qid = *reinterpret_cast<const int2*>(qs + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e & 1;
      float pv = ex2(s[4 * i + e] * p.scale_log2 - (hi ? l.y : l.x));
      if (kMask) {
        const int qidx = q0 + c + hi;
        const int kidx = e < 2 ? row_a : row_b;
        bool keep = qidx < p.sq;
        if (p.causal) keep = keep && kidx <= qidx;
        if (p.qseg != nullptr) {
          const int qv = hi ? qid.y : qid.x;
          keep = keep && qv == (e < 2 ? ks_a : ks_b) && qv != 0;
        }
        if (!keep) pv = 0.f;
      }
      s[4 * i + e] = pv;
      dp[4 * i + e] = pv * (dp[4 * i + e] - (hi ? dl.y : dl.x)) * p.sm_scale;
    }
  }
}

template <int D, int N>
__device__ __forceinline__ void dkv_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& tdo,
                                          const Params& p, int hk, int b, int ik) {
  using C = Cfg<D, N>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the swizzle atoms of TMA and wgmma
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base + C::kA, sV = base + C::kB, sQ = base + C::kX, sdO = base + C::kY;
  float* sLse = reinterpret_cast<float*>(smem + C::kRow);  // base-2 units
  float* sDelta = sLse + S * N;
  int* sQseg = reinterpret_cast<int*>(sDelta + S * N);
  const uint32_t bar_kv = base + C::kBar;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + S + s); };

  const int k0 = ik * kBM;
  const int n_qt = (p.sq + N - 1) / N;
  const int n_qc = (p.sq + kChunk - 1) / kChunk, n_kc = (p.skv + kChunk - 1) / kChunk;
  const int iq_first = p.causal ? k0 / N : 0;  // earlier query tiles see none of these keys
  const bool use_seg = p.qseg != nullptr;

  // the block's key range, and whether the block needs a query tile
  int4 kr_block = empty_range();
  if (use_seg) {
    kr_block = p.krange[b * n_kc + 2 * ik];
    if (2 * ik + 1 < n_kc) kr_block = merge(kr_block, p.krange[b * n_kc + 2 * ik + 1]);
  }
  auto q_tile_range = [&](int iq) {
    return chunks_range(p.qrange + b * n_qc, iq * (N / kChunk), N / kChunk, n_qc);
  };
  auto block_needs = [&](int iq) { return !use_seg || ranges_meet(q_tile_range(iq), kr_block); };

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warp_uniform(threadIdx.x / 128);
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * C::kOwnBytes);
#pragma unroll
      for (int x = 0; x < C::kHalves; ++x) {
        tma_load_4d(sK + x * kBM * 128, &tk, bar_kv, 64 * x, hk, k0, b);
        tma_load_4d(sV + x * kBM * 128, &tv, bar_kv, 64 * x, hk, k0, b);
      }
    }
    int n = 0;
    for (int gi = 0; gi < p.groups; ++gi) {
      const int h = hk * p.groups + gi;
      for (int iq = iq_first; iq < n_qt; ++iq) {
        if (!block_needs(iq)) continue;
        const int s = n % S;
        mbar_wait(empty(s), ((n / S) & 1) ^ 1);
        const int q0 = iq * N;
        const long long off = ((long long)b * p.hq + h) * p.sq;
#pragma unroll
        for (int e = 0; e < N / 32; ++e) {
          const int r = lane + 32 * e, qr = q0 + r;
          const bool valid = qr < p.sq;
          sLse[s * N + r] = valid ? p.lse[off + qr] * kLog2e : 0.f;
          sDelta[s * N + r] = valid ? p.delta[off + qr] : 0.f;
          if (use_seg) sQseg[s * N + r] = valid ? p.qseg[b * p.qseg_sb + qr] : 0;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(full(s), 2 * C::kTileBytes);
#pragma unroll
          for (int x = 0; x < C::kHalves; ++x) {
            tma_load_4d(sQ + s * C::kTileBytes + x * N * 128, &tq, full(s), 64 * x, h, q0, b);
            tma_load_4d(sdO + s * C::kTileBytes + x * N * 128, &tdo, full(s), 64 * x, h, q0, b);
          }
        }
        ++n;
      }
    }
    if (p.tiles != nullptr && lane == 0) {
      atomicAdd(p.tiles, n);
      atomicAdd(p.tiles + 1, p.groups * (n_qt - iq_first));
    }
  } else {
    // ---------------- consumers: 64 key rows each ----------------
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int g = lane >> 2;  // row within the warp's 16 (and +8)
    const int t = lane & 3;   // column pair within each 8-column block
    const int kr0 = k0 + cw * 64;
    const int row_a = kr0 + warp * 16 + g;
    const int row_b = row_a + 8;
    int ks_a = 0, ks_b = 0;
    int4 kr = empty_range();
    if (use_seg) {
      if (row_a < p.skv) ks_a = p.kseg[b * p.kseg_sb + row_a];
      if (row_b < p.skv) ks_b = p.kseg[b * p.kseg_sb + row_b];
      if (kr0 < p.skv) kr = p.krange[b * n_kc + 2 * ik + cw];
    }
    const uint32_t k_base = sK + cw * 64 * 128, v_base = sV + cw * 64 * 128;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[N / 2], dp[N / 2];
    uint32_t pf[N / 16][4], df[N / 16][4];
    // No overlap inside a warpgroup here: a second set of S^T and dP^T beside
    // dK, dV and the fragments (D + 3N/2 fp32 registers a thread: 224 at
    // D = 128, 256 at D = 64) does not fit the 240, so each tile's RS
    // products follow its exponentials; the other warpgroup covers them.

    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    };

    mbar_wait(bar_kv, 0);
    if (cw == 1) turn_pass(0);  // warpgroup 0 issues first
    int n = 0;
    for (int gi = 0; gi < p.groups; ++gi) {
      for (int iq = iq_first; iq < n_qt; ++iq) {
        if (!warp_uniform(block_needs(iq))) continue;
        const int st = n % S;
        mbar_wait(full(st), (n / S) & 1);
        const int q0 = iq * N;
        const uint32_t q_tile = sQ + st * C::kTileBytes, do_tile = sdO + st * C::kTileBytes;
        // per-element compares: the causal diagonal, a ragged tile, and
        // segment ids that are not one nonzero id on both sides (this also
        // zeroes the tiles this warpgroup's keys do not meet at all)
        bool mask = (p.causal && kr0 + 63 > q0) || q0 + N > p.sq;
        if (use_seg) mask = mask || !ranges_uniform(q_tile_range(iq), kr);
        wgmma_fence();
        turn_wait(cw);
        issue_ss<D, N>(s, k_base, kBM, q_tile);
        issue_ss<D, N>(dp, v_base, kBM, do_tile);
        wgmma_commit();
        turn_pass(1 - cw);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        const float* lse = sLse + st * N;
        const float* delta = sDelta + st * N;
        const int* qs = sQseg + st * N;
        if (warp_uniform(mask))
          dkv_tile<true, N>(s, dp, p, lse, delta, qs, q0, row_a, row_b, ks_a, ks_b, t);
        else
          dkv_tile<false, N>(s, dp, p, lse, delta, qs, q0, row_a, row_b, ks_a, ks_b, t);
        to_fragments<N>(s, pf);
        to_fragments<N>(dp, df);
        wgmma_fence();
        issue_rs<D, N>(dv, pf, do_tile);  // dV += P^T dO
        issue_rs<D, N>(dk, df, q_tile);   // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_frags(pf);
        fence_frags(df);
        release(st);
        ++n;
      }
    }

    store_acc<D>(p.dk, p.dk_sb, p.dk_ss, p.dk_sh, b, hk, row_a, p.skv, t, dk);
    store_acc<D>(p.dv, p.dv_sb, p.dv_ss, p.dv_sh, b, hk, row_a, p.skv, t, dv);
  }
}

// ---------------------------------------------------------------------------
// pass 2: dQ. Block = (query head, batch, 128-row query block).
// ---------------------------------------------------------------------------

// dS of one tile in place of dP: s[4i + e] holds query row a (e < 2) or b,
// key column 8i + 2t + (e & 1) of the tile; the keys' ids come from the
// tile's staged slice. P itself is not needed here: lse_a/lse_b carry
// -log2(scale), so the exponential is P * scale.
template <bool kMask, int N>
__device__ __forceinline__ void dq_tile(const float (&s)[N / 2], float (&dp)[N / 2],
                                        const Params& p, const int* ks, int k0, int row_a,
                                        int row_b, float lse_a, float lse_b, float delta_a,
                                        float delta_b, int qs_a, int qs_b, int t) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = 8 * i + 2 * t;
    int2 kid = make_int2(0, 0);
    if (kMask && p.kseg != nullptr) kid = *reinterpret_cast<const int2*>(ks + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e & 1;
      const bool rb = e >= 2;
      float pv = ex2(s[4 * i + e] * p.scale_log2 - (rb ? lse_b : lse_a));
      if (kMask) {
        const int kidx = k0 + c + hi;
        const int qidx = rb ? row_b : row_a;
        bool keep = kidx < p.skv;
        if (p.causal) keep = keep && kidx <= qidx;
        if (p.kseg != nullptr) {
          const int qv = rb ? qs_b : qs_a;
          keep = keep && (hi ? kid.y : kid.x) == qv && qv != 0;
        }
        if (!keep) pv = 0.f;
      }
      dp[4 * i + e] = pv * (dp[4 * i + e] - (rb ? delta_b : delta_a));
    }
  }
}

template <int D, int N>
__device__ __forceinline__ void dq_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& tdo,
                                         const Params& p, int h, int b, int iqb) {
  using C = Cfg<D, N>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + C::kA, sdO = base + C::kB, sK = base + C::kX, sV = base + C::kY;
  int* sKseg = reinterpret_cast<int*>(smem + C::kRow);
  const uint32_t bar_q = base + C::kBar;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + S + s); };

  const int hk = h / p.groups;
  const int q0 = iqb * kBM;
  const int n_qc = (p.sq + kChunk - 1) / kChunk, n_kc = (p.skv + kChunk - 1) / kChunk;
  int n_kt = (p.skv + N - 1) / N;
  if (p.causal) n_kt = min(n_kt, (q0 + kBM - 1) / N + 1);  // skip tiles above the diagonal
  const bool use_seg = p.kseg != nullptr;

  int4 qr_block = empty_range();
  if (use_seg) {
    qr_block = p.qrange[b * n_qc + 2 * iqb];
    if (2 * iqb + 1 < n_qc) qr_block = merge(qr_block, p.qrange[b * n_qc + 2 * iqb + 1]);
  }
  auto k_tile_range = [&](int j) {
    return chunks_range(p.krange + b * n_kc, j * (N / kChunk), N / kChunk, n_kc);
  };
  auto block_needs = [&](int j) { return !use_seg || ranges_meet(qr_block, k_tile_range(j)); };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warp_uniform(threadIdx.x / 128);
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * C::kOwnBytes);
#pragma unroll
      for (int x = 0; x < C::kHalves; ++x) {
        tma_load_4d(sQ + x * kBM * 128, &tq, bar_q, 64 * x, h, q0, b);
        tma_load_4d(sdO + x * kBM * 128, &tdo, bar_q, 64 * x, h, q0, b);
      }
    }
    int n = 0;
    for (int j = 0; j < n_kt; ++j) {
      if (!block_needs(j)) continue;
      const int s = n % S;
      mbar_wait(empty(s), ((n / S) & 1) ^ 1);
      if (use_seg) {
#pragma unroll
        for (int e = 0; e < N / 32; ++e) {
          const int kr = j * N + lane + 32 * e;
          sKseg[s * N + lane + 32 * e] = kr < p.skv ? p.kseg[b * p.kseg_sb + kr] : 0;
        }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_expect_tx(full(s), 2 * C::kTileBytes);
#pragma unroll
        for (int x = 0; x < C::kHalves; ++x) {
          tma_load_4d(sK + s * C::kTileBytes + x * N * 128, &tk, full(s), 64 * x, hk, j * N, b);
          tma_load_4d(sV + s * C::kTileBytes + x * N * 128, &tv, full(s), 64 * x, hk, j * N, b);
        }
      }
      ++n;
    }
    if (p.tiles != nullptr && lane == 0) {
      atomicAdd(p.tiles + 2, n);
      atomicAdd(p.tiles + 3, n_kt);
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int qr0 = q0 + cw * 64;
    const int row_a = qr0 + warp * 16 + g;
    const int row_b = row_a + 8;
    float lse_a = 0.f, lse_b = 0.f, delta_a = 0.f, delta_b = 0.f;
    int qs_a = 0, qs_b = 0;
    {
      const long long off = ((long long)b * p.hq + h) * p.sq;
      // base 2, less log2(scale): the exponentials below are P * scale
      const float log2_scale = log2f(p.sm_scale);
      if (row_a < p.sq) {
        lse_a = p.lse[off + row_a] * kLog2e - log2_scale;
        delta_a = p.delta[off + row_a];
        if (use_seg) qs_a = p.qseg[b * p.qseg_sb + row_a];
      }
      if (row_b < p.sq) {
        lse_b = p.lse[off + row_b] * kLog2e - log2_scale;
        delta_b = p.delta[off + row_b];
        if (use_seg) qs_b = p.qseg[b * p.qseg_sb + row_b];
      }
    }
    int4 qr = empty_range();
    if (use_seg && qr0 < p.sq) qr = p.qrange[b * n_qc + 2 * iqb + cw];
    const uint32_t q_base = sQ + cw * 64 * 128, do_base = sdO + cw * 64 * 128;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    float s[N / 2], dp[N / 2];
    uint32_t df[N / 16][4];
    zero_fragments(df);
    // Each step issues this tile's SS products and the previous tile's dQ
    // product together (the first step's with zero fragments on the staged Q
    // tile, which adds nothing), so no wgmma sits in a branch on data, which
    // ptxas would serialise.
    int prev = -1;
    uint32_t prev_k = sQ;

    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    };
    auto issue_rs_tile = [&](uint32_t k_tile) {  // dQ += dS K
      issue_rs<D, N>(dq, df, k_tile);
      wgmma_commit();
    };
    auto fence_all = [&]() {
      fence_regs(dq);
      fence_frags(df);
    };

    mbar_wait(bar_q, 0);
    if (cw == 1) turn_pass(0);
    int n = 0;
    for (int j = 0; j < n_kt; ++j) {
      if (!warp_uniform(block_needs(j))) continue;
      const int st = n % S;
      mbar_wait(full(st), (n / S) & 1);
      const int k0 = j * N;
      const uint32_t k_tile = sK + st * C::kTileBytes;
      bool mask = (p.causal && k0 + N - 1 > qr0) || k0 + N > p.skv;
      if (use_seg) mask = mask || !ranges_uniform(qr, k_tile_range(j));
      wgmma_fence();
      turn_wait(cw);
      issue_ss<D, N>(s, q_base, kBM, k_tile);
      issue_ss<D, N>(dp, do_base, kBM, sV + st * C::kTileBytes);
      wgmma_commit();
      issue_rs_tile(prev_k);
      turn_pass(1 - cw);
      wgmma_wait<1>();  // this tile's scores; the previous tile's dQ product may still run
      fence_regs(s);
      fence_regs(dp);
      const int* ks = sKseg + st * N;
      if (warp_uniform(mask))
        dq_tile<true, N>(s, dp, p, ks, k0, row_a, row_b, lse_a, lse_b, delta_a, delta_b, qs_a,
                      qs_b, t);
      else
        dq_tile<false, N>(s, dp, p, ks, k0, row_a, row_b, lse_a, lse_b, delta_a, delta_b, qs_a,
                       qs_b, t);
      wgmma_wait<0>();
      fence_all();
      if (prev >= 0) release(prev);
      to_fragments<N>(dp, df);
      prev = st;
      prev_k = k_tile;
      ++n;
    }
    wgmma_fence();
    issue_rs_tile(prev_k);
    wgmma_wait<0>();
    fence_all();
    if (prev >= 0) release(prev);

    store_acc<D>(p.dq, p.dq_sb, p.dq_ss, p.dq_sh, b, h, row_a, p.sq, t, dq);
  }
}

// Both passes in one launch: first every dK/dV block, then every dQ block,
// each pass's blocks by rank (rank r: K/V block r, query block r, causal
// n_qb - 1 - r: heaviest first) and by head and batch within a rank. The
// dQ blocks fill the SMs the last dK/dV wave leaves idle; interleaving the
// passes rank by rank timed slower at the 7B training shape.
template <int D, int NKV, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq_s, const __grid_constant__ CUtensorMap tdo_s,
                 const __grid_constant__ CUtensorMap tk_o, const __grid_constant__ CUtensorMap tv_o,
                 const __grid_constant__ CUtensorMap tq_o, const __grid_constant__ CUtensorMap tdo_o,
                 const __grid_constant__ CUtensorMap tk_s, const __grid_constant__ CUtensorMap tv_s,
                 const Params p) {
  const int a = p.hkv * p.batch, q = p.hq * p.batch;  // blocks of a rank in each pass
  int i = blockIdx.x, r;
  const bool dkv = i < p.n_kb * a;
  if (dkv) {
    r = i / a;
    i %= a;
  } else {
    i -= p.n_kb * a;
    r = i / q;
    i %= q;
  }
  if (dkv)
    dkv_block<D, NKV>(tq_s, tk_o, tv_o, tdo_s, p, i % p.hkv, i / p.hkv, r);
  else
    dq_block<D, NQ>(tq_o, tk_s, tv_s, tdo_o, p, i % p.hq, i / p.hq,
                    p.causal ? p.n_qb - 1 - r : r);
}

struct Views {
  const void *q, *k, *v, *dout;
  int hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

// Tiles, by head dim. Both passes own 128 rows a block (two consumer
// warpgroups of 64). The dK/dV pass streams 64 query rows at D = 128, where
// they keep dK + dV (128 fp32 registers a thread), S^T and dP^T (32 each)
// and their fragments within the consumers' 240 registers, and 128 at
// D = 64, where 64-wide score products read as many shared-memory bytes as
// the tensor cores can use (faster at the UNet's shapes on an H100 than 64
// rows with overlap; 128 rows leave no registers to overlap). The dQ pass
// streams 64 key rows (128 at D = 64 timed slower). `bwd_tiles` in
// ops/attention.py mirrors these sizes; chip_smoke.py holds the kernel's
// tile count to the plain skip rule over them.
template <int D>
int launch(const Views& w, const Params& p, cudaStream_t stream) {
  constexpr int kNkv = D == 64 ? 128 : 64;  // query rows a tile, dK/dV pass
  constexpr int kNq = 64;                   // key rows a tile, dQ pass
  CUtensorMap tq_s, tdo_s, tk_o, tv_o, tq_o, tdo_o, tk_s, tv_s;  // streamed / owned boxes
  const long long do_sb = p.do_sb, do_ss = p.do_ss, do_sh = p.do_sh;
  int err = make_map(&tq_s, w.q, D, p.hq, p.sq, p.batch, w.q_sb, w.q_ss, w.q_sh, kNkv);
  if (!err) err = make_map(&tdo_s, w.dout, D, p.hq, p.sq, p.batch, do_sb, do_ss, do_sh, kNkv);
  if (!err) err = make_map(&tk_o, w.k, D, w.hkv, p.skv, p.batch, w.k_sb, w.k_ss, w.k_sh, kBM);
  if (!err) err = make_map(&tv_o, w.v, D, w.hkv, p.skv, p.batch, w.v_sb, w.v_ss, w.v_sh, kBM);
  if (kNkv == kBM) {  // D = 64: the streamed and the owned Q and dO boxes are one size
    tq_o = tq_s;
    tdo_o = tdo_s;
  } else {
    if (!err) err = make_map(&tq_o, w.q, D, p.hq, p.sq, p.batch, w.q_sb, w.q_ss, w.q_sh, kBM);
    if (!err) err = make_map(&tdo_o, w.dout, D, p.hq, p.sq, p.batch, do_sb, do_ss, do_sh, kBM);
  }
  if (!err) err = make_map(&tk_s, w.k, D, w.hkv, p.skv, p.batch, w.k_sb, w.k_ss, w.k_sh, kNq);
  if (!err) err = make_map(&tv_s, w.v, D, w.hkv, p.skv, p.batch, w.v_sb, w.v_ss, w.v_sh, kNq);
  if (err) return err;

  constexpr int kSmem = Cfg<D, kNkv>::kSmem > Cfg<D, kNq>::kSmem ? Cfg<D, kNkv>::kSmem
                                                                 : Cfg<D, kNq>::kSmem;
  // the shared-memory limit is set once per device (a context holds it)
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !smem_set[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_kernel<D, kNkv, kNq>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) smem_set[dev] = true;
  }

  const long long n_rows = (long long)p.batch * p.sq * p.hq;
  constexpr int kDeltaRows = 128 / (D / 8);  // rows a block of the delta kernel
  flash_bwd_delta_kernel<D>
      <<<(unsigned)((n_rows + kDeltaRows - 1) / kDeltaRows), 128, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (p.qseg != nullptr) {
    const int n = p.batch * ((p.sq + kChunk - 1) / kChunk + (p.skv + kChunk - 1) / kChunk);
    flash_bwd_range_kernel<<<(n + 127) / 128, 128, 0, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = p.n_kb * p.hkv * p.batch + p.n_qb * p.hq * p.batch;
  flash_bwd_kernel<D, kNkv, kNq><<<blocks, kThreads, kSmem, stream>>>(
      tq_s, tdo_s, tk_o, tv_o, tq_o, tdo_o, tk_s, tv_s, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for an
// unsupported head dim or a view TMA cannot describe. Pointers and strides
// are in elements; the last dim of every bf16 tensor is contiguous, bases
// are 16-byte aligned and the other strides multiples of 8 (checked by the
// caller). `delta` is fp32 scratch of the LSE's shape [B, Hq, Sq]; `ranges`
// is int32 scratch of 4 * B * (ceil(Sq / 64) + ceil(Skv / 64)) values when
// segment ids are given, else null. `tiles` is null, or 4 zeroed int32
// counters the kernel adds to: tile pairs computed and causal tile pairs of
// the dK/dV pass, then of the dQ pass.
int dl_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const void* o, const float* lse, float* delta,
                      const int* qseg, const int* kseg, int* ranges, int* tiles,
                      void* dq, void* dk, void* dv,
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
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.lse = lse;
  p.delta = delta;
  p.qseg = qseg;
  p.kseg = kseg;
  p.qrange = reinterpret_cast<int4*>(ranges);
  p.krange = ranges == nullptr ? nullptr
                               : reinterpret_cast<int4*>(ranges) + batch * ((sq + kChunk - 1) / kChunk);
  p.tiles = tiles;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.batch = batch;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.groups = hq / hkv;
  p.n_kb = (skv + kBM - 1) / kBM;
  p.n_qb = (sq + kBM - 1) / kBM;
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
  if ((qseg == nullptr) != (ranges == nullptr)) return (int)cudaErrorInvalidValue;
  const Views w{q, k, v, dout, hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(w, p, s);
  if (d == 128) return launch<128>(w, p, s);
  return (int)cudaErrorInvalidValue;
}

const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
