// Flash attention forward (online softmax) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `_kernel` / `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py).  Same function: q (B,H,Sq,dh) with
// k, v (B,KVH,Skv,dh), grouped-query attention by indexing k/v at h / G
// (no repeat of K/V), causal and sliding-window masks, running max / running
// sum / f32 accumulator carried over the walk along the keys, NEG_INF = -1e30,
// final divide by max(l, 1e-20), fully masked (q-tile, k-tile) pairs never
// visited, out in q's type.  In both kernels one thread block owns one
// (b, h, q-tile), the last q-tiles (which see the most keys under a causal
// mask) start first, and the block loops over the k-tiles itself with the
// running max, running sum and output accumulator in registers, so nothing
// but q, k, v (read once per block) and o (written once) touches device
// memory (and, when asked, the row log-sum-exp: see below).  Masked k-tiles
// are cut from the loop bounds (causal: upper bound,
// window: lower bound); the ragged edge (Sq or Skv not a multiple of the
// tile, dh below the padded width) is masked inside, so any Sq, Skv >= 1 is
// accepted.  A query row that sees no key comes out as zeros, as from the TPU
// kernel.
//
// The row log-sum-exp (lse, (B, H, Sq) f32, written only when its pointer is
// not null): max(m * scale, -1e4) + ln(max(l, 1e-20)), with m the running
// max and l the running sum the epilogue already holds — what the reference
// saves for its chunked backward (`_flash_xla_fwd`, models/attention.py),
// the running max floored as there (`_M_INIT`).  One f32 store per row: the
// backward needs no second Q K^T pass to re-derive it.
//
// What bounds it on this card: operations, not bytes.  At B=4, H=24,
// S=2048, dh=128 (causal) q, k, v and o move 0.13 GB while the two products
// cost 1.0e11 operations: 0.104 ms at the 989 TFLOP/s of the bf16 tensor
// cores against 0.040 ms for the bytes.
//
// bf16 (fa_wgmma_kernel, every bf16 call): the products run on the tensor
// cores, in the FA3 shape.
//   * S = Q K^T is a chain of wgmma.mma_async m64n128k16 (128 keys a tile)
//     with Q and K read from shared memory through descriptors (K-major,
//     128-byte swizzle).  P (f32, as in the reference, which keeps it f32
//     for P V) is split into hi = bf16(P) and lo = bf16(P - hi), both fed to
//     O += P_hi V + P_lo V, one m64nDHPk16 product each a 16-key step, V the
//     B operand read MN-major from its (keys, dh) tile through the transpose
//     bit, the descriptor's LBO stepping from one 64-column chunk to the
//     next.  hi + lo holds P to about 2^-16, where bf16(P) alone holds it to
//     2^-8: the kernel then rounds nothing the f32 plain version does not but
//     its output, at twice the P V products.  Accumulators are f32 in
//     registers; the softmax uses ex2.approx with the scale folded into
//     scale * log2(e).
//   * P_lo goes through shared memory: each consumer stores it with
//     stmatrix as its 64 x 128 K-major A tile in the 128-byte swizzle (the
//     16-byte unit of keys at its index XOR the row's), fences it for the
//     async proxy, and P_lo V reads it by descriptor.  P_hi stays a register
//     A operand up to a head of 80; above, it takes the same path (below).
//   * Tiles of 128 queries x 128 keys at every head width.  A block is three
//     warpgroups: one producer (one thread issues every copy) and two
//     consumers of 64 query rows each.  The producer loads Q once and
//     streams K/V through a ring of two stages in shared memory with TMA
//     (cp.async.bulk.tensor, 4-D tensor maps over (dh, S, H, B) with the
//     caller's strides, so strided views need no copy), signalled by
//     mbarriers (full: bytes arrived; empty, for K and V apart: the eight
//     consumer warps are done with them).  setmaxnreg hands the producer's
//     registers to the consumers (24 / 240).
//   * Ping-pong and overlap.  The consumers take turns at the tensor cores
//     (two named barriers, one a consumer): a turn issues S of tile i and
//     P V of tile i - 1 together, then the warpgroup runs the softmax of
//     tile i while its P V and the other consumer's turn hold the tensor
//     cores; the S and P registers are split only after that P V is done.
//   * Registers.  ptxas -v reports the 168 a thread of the 384-thread block
//     is launched with; after setmaxnreg.inc 240 the consumers' code uses
//     more (their SASS names registers above R168), so the budget is
//     setmaxnreg's.  Yet with S (64 registers), O (DHP / 2) and P_hi (32)
//     all live across the overlapped products, ptxas serialises the
//     products for want of registers (C7512) and spills at heads of 96, 112
//     and 128 (40, 152, 252 bytes, CUDA 12.9).  There P_hi goes through
//     shared memory as well, and S + O fit without a spill at every width.
//   * A row of a 64-column chunk is 128 bytes, the swizzle span; a head
//     wider than 64 is two chunks (two TMA boxes).  Columns past dh and rows
//     past Sq / Skv are TMA's out-of-bounds zeros, and the products run only
//     over dh rounded up to 16 (zamba2's dh 80: 5 k-steps for Q K^T, N = 80
//     for P V), so no product is padded to 128.
//   * Masks are evaluated only on tiles that need them: the diagonal tiles
//     under a causal mask, the edge tiles of a window and the ragged last
//     k-tile, each judged per consumer warpgroup.  A fully visible tile runs
//     no mask arithmetic.
//   Shared memory: Q 16 KB a chunk, 2 stages x (K + V) of 16 KB a chunk
//   each, and the P tiles, 16 KB each a consumer (P_lo; and P_hi above a
//   head of 80): 115,784 bytes at heads up to 64, 197,704 at 80 and
//   230,472 above, of 232,448; one block per SM.  TMA needs a 16-byte-
//   aligned base and strides that are multiples of 16 bytes; the wrapper
//   refuses other layouts.
//
// f32 (fa_fwd_kernel): f32 inputs must hold a 1e-4 tolerance, which bf16
// tensor cores cannot give, and no main path runs attention in f32, so both
// products run in f32 on the FP32 pipes (67 TFLOP/s): 256 threads form a
// 16 x 16 grid, each owning a register micro-tile of the logits (rows
// ty + 16 i, columns tx + 16 j) and of the output; a row is held by the 16
// lanes of one half-warp, so row maxima and sums are four xor-shuffles.  Q, K,
// V tiles are staged in shared memory as f32 with padded row strides.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kMInit = -1e4f;   // the reference's running-max floor

__device__ __forceinline__ bool visible(int r, int c, int Skv, int causal,
                                        int window) {
  bool ok = c < Skv;
  if (causal) ok = ok && (r >= c);
  if (window > 0) ok = ok && (r - c < window);
  return ok;
}

// ===========================================================================
// f32: FP32 pipes
// ===========================================================================

constexpr int kThreads = 256;            // 16 x 16

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;   // (B, H, Sq) or null
  int B, H, KVH, Sq, Skv, dh;
  // strides in elements; the last (dh) dimension has stride 1
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  int window;   // <= 0: no window
  float scale;
};

__device__ __forceinline__ float component(const float4& x, int i) {
  return i == 0 ? x.x : (i == 1 ? x.y : (i == 2 ? x.z : x.w));
}

// Copies ROWS x DHP values into shared memory, rows beyond `n_rows` and
// columns beyond `dh` filled with zeros.
template <int ROWS, int DHP, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long base, long long row_stride,
                                          int row0, int n_rows, int dh,
                                          int tid) {
  constexpr int V4 = DHP / 4;
  for (int idx = tid; idx < ROWS * V4; idx += kThreads) {
    const int r = idx / V4;
    const int c = (idx % V4) * 4;
    const int gr = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n_rows && c < dh) {
      val = *reinterpret_cast<const float4*>(
          src + base + static_cast<long long>(gr) * row_stride + c);
    }
    *reinterpret_cast<float4*>(dst + r * STRIDE + c) = val;
  }
}

template <int BQ, int BK, int DHP>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(const Params p) {
  constexpr int TM = BQ / 16;   // rows per thread
  constexpr int TN = BK / 16;   // logit columns per thread
  constexpr int TD = DHP / 16;  // output columns per thread
  constexpr int QS = DHP + 4;
  constexpr int KS = DHP + 4;
  constexpr int VS = DHP;
  constexpr int PS = BK + 16;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * VS;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // the last q-tiles see the most keys under a causal mask: start them first
  const int qt = static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * BQ;

  const long long q_base = b * p.q_sb + h * p.q_sh;
  const long long o_base = b * p.o_sb + h * p.o_sh;
  const long long k_base = b * p.k_sb + kvh * p.k_sh;
  const long long v_base = b * p.v_sb + kvh * p.v_sh;

  load_tile<BQ, DHP, QS>(Qs, p.q, q_base, p.q_ss, q0, p.Sq, p.dh, tid);

  float m_run[TM], l_run[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int t = 0; t < TD; ++t) acc[i][t] = 0.f;
  }

  // k-tiles that hold at least one visible (q, k) pair for this q-tile
  int k_end = p.Skv;
  if (p.causal) k_end = min(k_end, min(q0 + BQ, p.Sq));
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  const int kt_begin = k_begin / BK;
  const int kt_end = (k_end + BK - 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<BK, DHP, KS>(Ks, p.k, k_base, p.k_ss, k0, p.Skv, p.dh, tid);
    load_tile<BK, DHP, VS>(Vs, p.v, v_base, p.v_ss, k0, p.Skv, p.dh, tid);
    __syncthreads();

    // ---- S = Q K^T on a TM x TN register tile --------------------------
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;

#pragma unroll 2
    for (int d = 0; d < DHP; d += 4) {
      float4 qv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // ---- online softmax; a row lives in the 16 lanes of a half-warp ----
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = k0 + tx + 16 * j;
        s[i][j] = visible(r, c, p.Skv, p.causal, p.window)
                      ? s[i][j] * p.scale
                      : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = k0 + tx + 16 * j;
        const float pij = visible(r, c, p.Skv, p.causal, p.window)
                              ? expf(s[i][j] - m_new)
                              : 0.f;
        sum += pij;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = pij;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int t = 0; t < TD; ++t) acc[i][t] *= alpha;
    }
    __syncwarp();  // P rows are read by the half-warp that wrote them

    // ---- acc += P V on a TM x TD register tile --------------------------
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * VS;
        float vv[TD];
        if constexpr (TD >= 4) {
#pragma unroll
          for (int ch = 0; ch < TD / 4; ++ch) {
            const float4 t4 =
                *reinterpret_cast<const float4*>(vrow + (ch * 16 + tx) * 4);
            vv[ch * 4 + 0] = t4.x;
            vv[ch * 4 + 1] = t4.y;
            vv[ch * 4 + 2] = t4.z;
            vv[ch * 4 + 3] = t4.w;
          }
        } else {
#pragma unroll
          for (int t = 0; t < TD; ++t) vv[t] = vrow[tx * TD + t];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float pi = component(pv[i], cc);
#pragma unroll
          for (int t = 0; t < TD; ++t) acc[i][t] = fmaf(pi, vv[t], acc[i][t]);
        }
      }
    }
    // P is rewritten only after the block barrier at the top of the loop
  }

  // ---- o = acc / max(l, 1e-20) ------------------------------------------
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    const float denom = fmaxf(l_run[i], 1e-20f);
    // m and l are the same in the 16 lanes of the row's half-warp
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + r] =
          fmaxf(m_run[i], kMInit) + logf(denom);
    const long long row = o_base + static_cast<long long>(r) * p.o_ss;
    if constexpr (TD >= 4) {
#pragma unroll
      for (int ch = 0; ch < TD / 4; ++ch) {
        const int col = (ch * 16 + tx) * 4;
        if (col < p.dh) {
          *reinterpret_cast<float4*>(p.o + row + col) =
              make_float4(acc[i][ch * 4 + 0] / denom,
                          acc[i][ch * 4 + 1] / denom,
                          acc[i][ch * 4 + 2] / denom,
                          acc[i][ch * 4 + 3] / denom);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int col = tx * TD + t;
        if (col < p.dh) p.o[row + col] = acc[i][t] / denom;
      }
    }
  }
}

// Bytes of shared memory of one block of fa_fwd_kernel<BQ, BK, DHP>: the
// Q, K and V tiles and the P strip, as the kernel lays them out.
constexpr size_t f32_smem_bytes(int bq, int bk, int dhp) {
  return sizeof(float) *
         (static_cast<size_t>(bq) * (dhp + 4) + static_cast<size_t>(bk) *
          (dhp + 4) + static_cast<size_t>(bk) * dhp +
          static_cast<size_t>(bq) * (bk + 16));
}

template <int BQ, int BK, int DHP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = f32_smem_bytes(BQ, BK, DHP);
  if constexpr (bytes > kSmemLimit) {
    return cudaErrorInvalidValue;  // this tile does not fit; never built
  } else {
    auto kern = fa_fwd_kernel<BQ, BK, DHP>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
    kern<<<grid, kThreads, bytes, stream>>>(p);
    return cudaGetLastError();
  }
}

template <int BQ, int BK>
cudaError_t launch_dh(const Params& p, cudaStream_t stream) {
  if (p.dh <= 16) return launch<BQ, BK, 16>(p, stream);
  if (p.dh <= 32) return launch<BQ, BK, 32>(p, stream);
  if (p.dh <= 64) return launch<BQ, BK, 64>(p, stream);
  return launch<BQ, BK, 128>(p, stream);
}

template <int BQ>
cudaError_t launch_bk(const Params& p, int block_k, cudaStream_t stream) {
  switch (block_k) {
    case 32: return launch_dh<BQ, 32>(p, stream);
    case 64: return launch_dh<BQ, 64>(p, stream);
    case 128: return launch_dh<BQ, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ===========================================================================
// bf16: wgmma tensor cores, TMA-fed K/V ring, warp specialisation
// ===========================================================================

constexpr int kBQ = 128;           // query rows of a block (2 x 64)
constexpr int kWgThreads = 384;    // producer warpgroup + 2 consumers
constexpr int kChunkCols = 64;     // bf16 columns of one 128-byte row chunk
constexpr int kRowBytes = 128;     // = the 128-byte swizzle span
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBarTurn = 1;        // named barriers 1, 2: consumer 0's, 1's

template <int DHP>
struct Tile {
  static constexpr int kChunks = (DHP + kChunkCols - 1) / kChunkCols;
  // keys of a tile and stages of the K/V ring (a third stage does not fit
  // at heads above 64)
  static constexpr int kBK = 128;
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kChunks * kBQ * kRowBytes;
  static constexpr int kKVBytes = kChunks * kBK * kRowBytes;  // one stage
  // P_hi in shared memory too above a head of 80: S, O and P_hi live across
  // the overlapped products do not fit the consumers' registers there
  static constexpr bool kHiSmem = DHP > 80;
  // a P tile of one consumer: its 64 rows x kBK keys, K-major, in 64-key
  // chunks; P_lo, after P_hi where P_hi is in shared memory
  static constexpr int kPTile = kBK / kChunkCols * 64 * kRowBytes;
  static constexpr int kPBytes = (kHiSmem ? 2 : 1) * kPTile;
  static constexpr int kPOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kBarOffset = kPOffset + 2 * kPBytes;
  // 1024 bytes of slack to align the tiles to the swizzle atom
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 4 * kStages);
};

struct BParams {
  __nv_bfloat16* o;
  float* lse;                   // (B, H, Sq) or null
  long long o_sb, o_sh, o_ss;   // elements; the last dimension has stride 1
  int H, KVH, Sq, Skv, dh;
  int causal;
  int window;                   // <= 0: no window
  float scale;                  // softmax scale
  float scale_log2;             // softmax scale * log2(e)
};

// S (64 x 128) = Q K^T over this warpgroup's 64 rows: one committed group.
// `qd`, `kd`: descriptors of the Q rows and the K stage.  The caller fences
// the registers (wgmma_fence) before the first product of a turn.  The
// first k-step writes S without reading it, so S's registers are free from
// the split of P until here.
template <int DHP>
__device__ __forceinline__ void issue_qk(float* sc, uint64_t qd,
                                         uint64_t kd) {
  constexpr int kBK = Tile<DHP>::kBK;
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;     // 16 columns = 32 bytes
    const uint64_t a = desc_at(qd, (kk >> 2) * kBQ * kRowBytes + col);
    const uint64_t b = desc_at(kd, (kk >> 2) * kBK * kRowBytes + col);
    if (kk == 0) wgmma_ss_n128_fresh(sc, a, b);
    else wgmma_ss_n128(sc, a, b, 1);
  }
  wgmma_commit();
}

// O (64 x DHP) += P_hi V + P_lo V: one committed group, two products over
// the whole head a 16-key step.  P_lo is in shared memory at `pd` (after
// P_hi's tile where P_hi is there too), P_hi otherwise in registers as bf16
// A fragments (`pa`); `vd`: the descriptor of the V stage, whose LBO steps
// from one 64-column chunk to the next.
template <int DHP>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*pa)[4],
                                         uint64_t pd, uint64_t vd) {
  using T = Tile<DHP>;
#pragma unroll
  for (int kk = 0; kk < T::kBK / 16; ++kk) {
    const uint64_t v = desc_at(vd, kk * 16 * kRowBytes);    // 16 keys
    const uint32_t a = (kk >> 2) * 64 * kRowBytes + (kk & 3) * 32;
    if constexpr (T::kHiSmem) wgmma_ss_t<DHP>(o, desc_at(pd, a), v);
    else wgmma_rs<DHP>(o, pa[kk], v);
    wgmma_ss_t<DHP>(o, desc_at(pd, (T::kHiSmem ? T::kPTile : 0) + a), v);
  }
  wgmma_commit();
}

// Running max and sum of the rows r0 and r0 + 8 of a thread (the sum is
// this thread's part; the quad's parts are added at the end).
struct Rows {
  float m0, m1, l0, l1;
};

// The online-softmax step of one tile: masks S where `edge` says a pair may
// be hidden, updates the running max and sum, overwrites S with P (f32), and
// returns the factors by which O is to be rescaled.
template <int kBK>
__device__ __forceinline__ float2 softmax_tile(float* sc, Rows& st, bool edge,
                                               int r0, int c0,
                                               const BParams& p) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!visible(r0 + (e >> 1) * 8, c0 + 8 * j + (e & 1), p.Skv,
                     p.causal, p.window))
          sc[4 * j + e] = kNegInf;
  }
  float mx0 = st.m0, mx1 = st.m1;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float c2 = p.scale_log2;
  const float2 alpha = make_float2(fast_exp2((st.m0 - mx0) * c2),
                                   fast_exp2((st.m1 - mx1) * c2));
  st.m0 = mx0;
  st.m1 = mx1;
  // a row that has seen no visible key yet keeps p = 0 (exp2 of -1e30)
  const float mc0 = mx0 == kNegInf ? 0.f : mx0 * c2;
  const float mc1 = mx1 == kNegInf ? 0.f : mx1 * c2;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    sc[4 * j] = fast_exp2(fmaf(sc[4 * j], c2, -mc0));
    sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], c2, -mc0));
    sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], c2, -mc1));
    sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], c2, -mc1));
    s0 += sc[4 * j] + sc[4 * j + 1];
    s1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l0 = st.l0 * alpha.x + s0;
  st.l1 = st.l1 * alpha.y + s1;
  return alpha;
}

// P (f32, in the accumulator layout of S) split into hi and lo bf16, the
// A fragments of P V (`pa`: the two 8-column blocks of a 16-key step are one
// m64k16 fragment).  lo, and hi where kHiSmem, go into this warpgroup's P
// tiles in shared memory, the same fragments stored by stmatrix.
// `st_row`: the shared address of the row this lane addresses (lanes
// 8m..8m+7 the rows of matrix m: rows + 8 for odd m, the second 8-key block
// for m >= 2, `odd`); a 16-byte unit of keys lands at its index XOR the
// row's (`row7`), the 128-byte swizzle that the descriptors and TMA use.
template <int kBK, int kPTile, bool kHiSmem>
__device__ __forceinline__ void pack_p(const float* sc, uint32_t (*pa)[4],
                                       uint32_t st_row, int odd, int row7) {
#pragma unroll
  for (int f = 0; f < kBK / 16; ++f) {
    uint32_t lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 2 * f + (e >> 1), h = 2 * (e & 1);   // block, row half
      split_pair(sc[4 * j + h], sc[4 * j + h + 1], pa[f][e], lo[e]);
    }
    const uint32_t unit = (2 * (f & 3) + odd) ^ row7;
    const uint32_t at = st_row + (f >> 2) * 64 * kRowBytes + unit * 16;
    if constexpr (kHiSmem) {
      stmatrix_x4(at, pa[f]);
      stmatrix_x4(at + kPTile, lo);
    } else {
      stmatrix_x4(at, lo);
    }
  }
}

template <int DHP>
__global__ void __launch_bounds__(kWgThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const BParams p) {
  using T = Tile<DHP>;
  constexpr int kBK = T::kBK;
  constexpr int kStages = T::kStages;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + T::kQBytes;               // stage s at s * kKVBytes
  uint8_t* v_s = k_s + kStages * T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // the last q-tiles see the most keys under a causal mask: start them first
  const int qt = static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kBQ;

  // k-tiles that hold at least one visible (q, k) pair for this q-tile
  int k_end = p.Skv;
  if (p.causal) k_end = min(k_end, min(q0 + kBQ, p.Sq));
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_begin = k_begin / kBK;
  const int n_tiles = max(0, (k_end + kBK - 1) / kBK - kt_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 8);   // one arrival per consumer warp
      mbar_init(v_empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every copy ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(q_s + c * kBQ * kRowBytes, &tm_q, q_full, c * kChunkCols,
                 q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (kt_begin + i) * kBK;
        // K and V of a stage are released apart: K once S is formed, V once
        // P V is, so the next K is in flight while P V still runs
        if (i >= kStages) mbar_wait(k_empty + s, parity);
        mbar_expect_tx(k_full + s, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(k_s + s * T::kKVBytes + c * kBK * kRowBytes, &tm_k,
                   k_full + s, c * kChunkCols, k0, kvh, b);
        if (i >= kStages) mbar_wait(v_empty + s, parity);
        mbar_expect_tx(v_full + s, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(v_s + s * T::kKVBytes + c * kBK * kRowBytes, &tm_v,
                   v_full + s, c * kChunkCols, k0, kvh, b);
      }
    }
  } else {
    // ---- two consumer warpgroups of 64 query rows each --------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int ct = tid - 128;
    const int cw = ct >> 7;                  // which consumer warpgroup
    const int lane = ct & 31;
    const int wq_lo = q0 + cw * 64;          // this warpgroup's query rows
    const int wq_hi = wq_lo + 63;
    const int wq = (ct >> 5) & 3;            // warp of the warpgroup
    const int r0 = wq_lo + wq * 16 + (lane >> 2);  // and r0 + 8
    const int cq = 2 * (lane & 3);
    // one descriptor is held (the tiles' base); Q's rows of this warpgroup
    // and the K and V stages are offsets from it, formed at each product
    const uint64_t base_desc = smem_desc(smem_u32(q_s));
    // V, the B operand of one product over the whole head: LBO steps from
    // one 64-column chunk to the next
    const uint64_t v_desc = smem_desc(smem_u32(q_s), kBK * kRowBytes);
    const uint32_t q_off = cw * 64 * kRowBytes;
    const uint32_t p_off = T::kPOffset + cw * T::kPBytes;
    // the P row this lane addresses for stmatrix (its warp's 16 rows)
    const uint32_t st_row = smem_u32(q_s) + p_off
        + (wq * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRowBytes;

    // masks only where a pair of this warpgroup may be hidden
    auto edge = [&](int k0) {
      return (k0 + kBK > p.Skv) || (p.causal && k0 + kBK - 1 > wq_lo)
             || (p.window > 0 && wq_hi - k0 >= p.window);
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);   // this warp is done with the stage
    };

    float o[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
    Rows st = {kNegInf, kNegInf, 0.f, 0.f};
    float sc[kBK / 2];          // S, then P in f32
    uint32_t pa[kBK / 16][4];   // P_hi: the A fragments of P V

    auto parity = [](int i) { return static_cast<uint32_t>(i / kStages) & 1; };
    // from a turn to its wait no register of a product in flight is touched
    // by anything but the products.  S is not fenced before Q K^T (its
    // first step only writes S): it holds its registers only while used
    auto qk = [&](int s) {
      issue_qk<DHP>(sc, opaque(desc_at(base_desc, q_off)),
                    opaque(desc_at(base_desc,
                                   T::kQBytes + s * T::kKVBytes)));
    };
    auto pv = [&](int s) {
      issue_pv<DHP>(o, pa, opaque(desc_at(base_desc, p_off)),
                    opaque(desc_at(v_desc, T::kQBytes + (kStages + s)
                                                  * T::kKVBytes)));
    };
    auto softmax = [&](int i) {
      const int k0 = (kt_begin + i) * kBK;
      return softmax_tile<kBK>(sc, st, edge(k0), r0, k0 + cq, p);
    };
    auto rescale = [&](float2 alpha) {
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        o[4 * j] *= alpha.x;
        o[4 * j + 1] *= alpha.x;
        o[4 * j + 2] *= alpha.y;
        o[4 * j + 3] *= alpha.y;
      }
    };
    auto pack = [&]() {
      pack_p<kBK, T::kPTile, T::kHiSmem>(sc, pa, st_row, lane >> 4,
                                         lane & 7);
      fence_proxy_async();   // the P tiles, for the product that reads them
    };
    // the registers the products of a turn read or write, written before it
    auto fence_turn = [&]() {
      fence_regs<DHP / 2>(o);
      if constexpr (!T::kHiSmem) fence_regs<kBK / 4>(&pa[0][0]);
    };

    // Ping-pong: the consumers take turns at the tensor cores (named
    // barrier kBarTurn + w is consumer w's turn; the other arrives on it
    // once its own turn is issued), so one's softmax runs under the other's
    // products.  Both walk the same n_tiles and take n_tiles + 1 turns
    // whatever their masks; consumer 1 arrives on consumer 0's barrier
    // before its first turn and not after its last, so no arrival is left
    // over.  The turn barrier also orders every warp's P stores (fenced for
    // the async proxy) before the product that reads them.
    auto turn_begin = [&]() { named_sync(kBarTurn + cw, 256); };
    auto turn_end = [&](bool last) {
      if (!(last && cw == 1)) named_arrive(kBarTurn + (cw ^ 1), 256);
    };
    if (n_tiles > 0) {
      mbar_wait(q_full, 0);
      if (cw == 1) named_arrive(kBarTurn, 256);   // consumer 0 goes first
      // the first turn: S of the first tile alone
      mbar_wait(k_full, 0);
      turn_begin();
      wgmma_fence();
      qk(0);
      turn_end(false);
      wgmma_wait<0>();
      fence_regs<kBK / 2>(sc);
      release(k_empty);
      softmax(0);            // O is still 0: nothing to rescale
      pack();
    }
    // turn i: S of tile i beside P V of tile i - 1, then the softmax of
    // tile i while that P V is in flight
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      mbar_wait(k_full + s, parity(i));
      mbar_wait(v_full + sp, parity(i - 1));
      fence_turn();
      turn_begin();
      wgmma_fence();
      qk(s);
      pv(sp);
      turn_end(false);
      wgmma_wait<1>();       // S of tile i
      fence_regs<kBK / 2>(sc);
      release(k_empty + s);
      const float2 alpha = softmax(i);
      wgmma_wait<0>();       // P V of tile i - 1: O, P_hi and P_lo free
      fence_turn();
      release(v_empty + sp);
      rescale(alpha);
      pack();
    }
    if (n_tiles > 0) {
      // the last turn: P V of the last tile
      const int sl = (n_tiles - 1) % kStages;
      mbar_wait(v_full + sl, parity(n_tiles - 1));
      fence_turn();
      turn_begin();
      wgmma_fence();
      pv(sl);
      turn_end(true);
      wgmma_wait<0>();
      fence_regs<DHP / 2>(o);
    }

    // ---- o = acc / max(l, 1e-20) ------------------------------------------
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, off);
      st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, off);
    }
    const float d0 = fmaxf(st.l0, 1e-20f);
    const float d1 = fmaxf(st.l1, 1e-20f);
    // m (raw logits; the scale is folded into the exponent) and l are the
    // same in the four lanes of a quad
    if (p.lse != nullptr && (lane & 3) == 0) {
      float* lrow = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
      if (r0 < p.Sq) lrow[r0] = fmaxf(st.m0 * p.scale, kMInit) + logf(d0);
      if (r0 + 8 < p.Sq)
        lrow[r0 + 8] = fmaxf(st.m1 * p.scale, kMInit) + logf(d1);
    }
    __nv_bfloat16* row0 = p.o + b * p.o_sb + h * p.o_sh
                          + static_cast<long long>(r0) * p.o_ss;
    __nv_bfloat16* row1 = row0 + 8 * p.o_ss;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < p.dh) {
        if (r0 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(row0 + col) =
              __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
        if (r0 + 8 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
              __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
      }
    }
  }
}

template <int DHP>
cudaError_t launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                         const CUtensorMap& tv, const BParams& p, int B,
                         cudaStream_t stream) {
  constexpr int bytes = Tile<DHP>::kSmem;
  static_assert(bytes <= kSmemLimit, "the bf16 tile must fit one block");
  auto kern = fa_wgmma_kernel<DHP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
  kern<<<grid, kWgThreads, bytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

int padded16(int dh) { return (dh + 15) / 16 * 16; }

// The tile of the instance for a padded head width: keys, stages, bytes of
// shared memory; keys 0 for a width no instance serves.
struct TileInfo {
  int keys, stages, smem;
};

template <int DHP>
TileInfo info() {
  return {Tile<DHP>::kBK, Tile<DHP>::kStages, Tile<DHP>::kSmem};
}

TileInfo tile_of(int dhp) {
  switch (dhp) {
    case 16: return info<16>();
    case 32: return info<32>();
    case 48: return info<48>();
    case 64: return info<64>();
    case 80: return info<80>();
    case 96: return info<96>();
    case 112: return info<112>();
    case 128: return info<128>();
    default: return {0, 0, -1};
  }
}

}  // namespace

// The f32 kernel: launches on `stream`, allocates nothing, does not
// synchronise; writes the row log-sum-exp into `lse` ((B, H, Sq) f32,
// contiguous) unless it is null.  Returns the CUDA error code of the launch (0 = success).
// block_q, block_k in {32, 64, 128}; a tile that exceeds the shared memory of
// one block is refused with cudaErrorInvalidValue.  dh must be a multiple of
// 4, at most 128, and every row (pointer and strides) 16-byte aligned.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H,
    int KVH, int Sq, int Skv, int dh, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, int block_q,
    int block_k, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || Sq <= 0 || Skv <= 0 || dh <= 0 ||
      dh > 128 || dh % 4 != 0 || H % KVH != 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.H = H; p.KVH = KVH; p.Sq = Sq; p.Skv = Skv; p.dh = dh;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal; p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (block_q) {
    case 32: err = launch_bk<32>(p, block_k, s); break;
    case 64: err = launch_bk<64>(p, block_k, s); break;
    case 128: err = launch_bk<128>(p, block_k, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The f32 kernel's tile (block_q, block_k) at head width dh: the bytes of
// shared memory of one block, as launch<> sets them.  Returns
// cudaErrorInvalidValue for a tile or dh it does not take, or a tile that
// does not fit one block (never built).
extern "C" int flash_attention_f32_tile(int block_q, int block_k, int dh,
                                        long long* smem_bytes) {
  const bool built = (block_q == 32 || block_q == 64 || block_q == 128) &&
                     (block_k == 32 || block_k == 64 || block_k == 128);
  if (!built || dh <= 0 || dh > 128 || dh % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dhp = dh <= 16 ? 16 : (dh <= 32 ? 32 : (dh <= 64 ? 64 : 128));
  const size_t bytes = f32_smem_bytes(block_q, block_k, dhp);
  if (bytes > hopper::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  *smem_bytes = static_cast<long long>(bytes);
  return 0;
}

// The bf16 kernel's tile for head width dh: query rows and keys of a tile,
// stages of the K/V ring, bytes of shared memory of one block.  Returns
// cudaErrorInvalidValue for a dh the kernel does not take.
extern "C" int flash_attention_tile(int dh, int* block_q, int* block_k,
                                    int* stages, long long* smem_bytes) {
  if (dh <= 0 || dh > 128 || dh % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TileInfo t = tile_of(padded16(dh));
  *block_q = kBQ;
  *block_k = t.keys;
  *stages = t.stages;
  *smem_bytes = t.smem;
  return 0;
}

// The bf16 kernel: launches on `stream`, allocates nothing, does not
// synchronise; encodes the three tensor maps on the host for every call;
// writes the row log-sum-exp as the f32 kernel does.
// Returns the CUDA error code (0 = success): cudaErrorMisalignedAddress when
// a base pointer is not 16-byte aligned or a stride (elements) of a dimension
// of extent > 1 is not a multiple of 8, cudaErrorInvalidValue for a shape
// the kernel does not take.  Strides in elements; o's last dimension has
// stride 1 and its rows are 4-byte aligned.
extern "C" int flash_attention_forward_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H,
    int KVH, int Sq, int Skv, int dh, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || Sq <= 0 || Skv <= 0 || dh <= 0 ||
      dh > 128 || dh % 4 != 0 || H % KVH != 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  const int keys = tile_of(padded16(dh)).keys;
  cudaError_t err = encode_map(&tq, q, B, H, Sq, dh, q_sb, q_sh, q_ss, kBQ);
  if (err == cudaSuccess)
    err = encode_map(&tk, k, B, KVH, Skv, dh, k_sb, k_sh, k_ss, keys);
  if (err == cudaSuccess)
    err = encode_map(&tv, v, B, KVH, Skv, dh, v_sb, v_sh, v_ss, keys);
  if (err != cudaSuccess) return static_cast<int>(err);
  BParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.H = H; p.KVH = KVH; p.Sq = Sq; p.Skv = Skv; p.dh = dh;
  p.causal = causal; p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded16(dh)) {
    case 16: err = launch_wgmma<16>(tq, tk, tv, p, B, s); break;
    case 32: err = launch_wgmma<32>(tq, tk, tv, p, B, s); break;
    case 48: err = launch_wgmma<48>(tq, tk, tv, p, B, s); break;
    case 64: err = launch_wgmma<64>(tq, tk, tv, p, B, s); break;
    case 80: err = launch_wgmma<80>(tq, tk, tv, p, B, s); break;
    case 96: err = launch_wgmma<96>(tq, tk, tv, p, B, s); break;
    case 112: err = launch_wgmma<112>(tq, tk, tv, p, B, s); break;
    default: err = launch_wgmma<128>(tq, tk, tv, p, B, s); break;
  }
  return static_cast<int>(err);
}
