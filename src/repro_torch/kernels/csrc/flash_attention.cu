// Flash attention forward (online softmax) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `_kernel` / `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py).  Same function: q (B,H,Sq,dh) with
// k, v (B,KVH,Skv,dh), grouped-query attention by indexing k/v at h / G
// (no repeat of K/V), causal and sliding-window masks, running max / running
// sum / f32 accumulator carried over the walk along the keys, NEG_INF = -1e30,
// final divide by max(l, 1e-20), fully masked (q-tile, k-tile) pairs never
// visited.  f32 or bf16 in, all arithmetic in f32 (both products and the
// probabilities), out in q's type.
//
// What differs from the TPU kernel.  There the walk along the keys is the
// innermost, sequential grid dimension and the running state sits in VMEM
// scratch between grid steps.  Here one thread block owns one (b, h, q-tile)
// and loops over the k-tiles itself; the running max, running sum and the
// output accumulator stay in registers for the whole loop, so nothing but
// q, k, v (read) and o (written) touches device memory.  Masked k-tiles are cut
// from the loop bounds (causal: upper bound, window: lower bound) instead of
// being predicated, and the ragged edge (Sq or Skv not a multiple of the tile,
// dh below the padded width) is masked here, so any Sq, Skv >= 1 is accepted.
//
// Layout of the work.  256 threads form a 16 x 16 grid (ty, tx).  For the
// logits tile S = Q K^T (BQ x BK) thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j; for the output tile (BQ x dh) it owns the same rows and
// float4 column chunks strided by 16.  A row is therefore held by the 16
// lanes of one half-warp: row maxima and row sums are four xor-shuffles, the
// rescale factor of the accumulator is known locally, and the probability
// tile written to shared memory is read back only by the half-warp that wrote
// it (a __syncwarp, not a block barrier).  Q, K, V tiles are staged in shared
// memory as f32 (row strides padded so that the 128-bit reads of a quarter
// warp fall on distinct banks), K/V indexed at h / G.
//
// What bounds it on this card.  The function is bound by operations, not
// bytes (at B=4, H=24, S=2048, dh=128 the q, k, v, o traffic is ~0.1 GB against
// ~1e11 floating-point operations).  Because the reference keeps the
// probabilities in f32 for p.v and f32 inputs must hold a 1e-4 tolerance, the
// products here run on the FP32 pipes (fused multiply-adds on register
// micro-tiles), whose peak is 67 TFLOP/s against 989 TFLOP/s of the bf16
// tensor cores that the bound is stated for.  The design answers with register
// tiling (up to 8 x 8 outputs per thread per operand fetch) and 128-bit
// shared-memory reads; moving the bf16 case onto mma/wgmma with TMA-fed tiles
// is the next step and is left out of this first version on purpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;            // 16 x 16
constexpr size_t kSmemLimit = 232448;    // bytes one block may use on sm_90

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KVH, Sq, Skv, dh;
  // strides in elements; the last (dh) dimension has stride 1
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  int window;   // <= 0: no window
  int is_bf16;
  float scale;
};

__device__ __forceinline__ float4 load4(const void* base, long long off,
                                        bool bf16) {
  if (bf16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(base) + off);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    const float2 fa = __bfloat1622float2(a);
    const float2 fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(base) +
                                          off);
}

__device__ __forceinline__ void store4(void* base, long long off, float4 val,
                                       bool bf16) {
  if (bf16) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(val.x, val.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(val.z, val.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned int*>(&a);
    u.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + off) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + off) = val;
  }
}

__device__ __forceinline__ void store1(void* base, long long off, float val,
                                       bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(base)[off] = __float2bfloat16_rn(val);
  } else {
    static_cast<float*>(base)[off] = val;
  }
}

__device__ __forceinline__ float component(const float4& x, int i) {
  return i == 0 ? x.x : (i == 1 ? x.y : (i == 2 ? x.z : x.w));
}

// Copies ROWS x DHP values into shared memory as f32, rows beyond `n_rows`
// and columns beyond `dh` filled with zeros.
template <int ROWS, int DHP, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          long long base, long long row_stride,
                                          int row0, int n_rows, int dh,
                                          bool bf16, int tid) {
  constexpr int V4 = DHP / 4;
  for (int idx = tid; idx < ROWS * V4; idx += kThreads) {
    const int r = idx / V4;
    const int c = (idx % V4) * 4;
    const int gr = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n_rows && c < dh) {
      val = load4(src, base + static_cast<long long>(gr) * row_stride + c,
                  bf16);
    }
    *reinterpret_cast<float4*>(dst + r * STRIDE + c) = val;
  }
}

__device__ __forceinline__ bool visible(int r, int c, int Skv, int causal,
                                        int window) {
  bool ok = c < Skv;
  if (causal) ok = ok && (r >= c);
  if (window > 0) ok = ok && (r - c < window);
  return ok;
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
  const bool bf16 = p.is_bf16 != 0;

  const long long q_base = b * p.q_sb + h * p.q_sh;
  const long long o_base = b * p.o_sb + h * p.o_sh;
  const long long k_base = b * p.k_sb + kvh * p.k_sh;
  const long long v_base = b * p.v_sb + kvh * p.v_sh;

  load_tile<BQ, DHP, QS>(Qs, p.q, q_base, p.q_ss, q0, p.Sq, p.dh, bf16, tid);

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
    load_tile<BK, DHP, KS>(Ks, p.k, k_base, p.k_ss, k0, p.Skv, p.dh, bf16,
                           tid);
    load_tile<BK, DHP, VS>(Vs, p.v, v_base, p.v_ss, k0, p.Skv, p.dh, bf16,
                           tid);
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
    const long long row = o_base + static_cast<long long>(r) * p.o_ss;
    if constexpr (TD >= 4) {
#pragma unroll
      for (int ch = 0; ch < TD / 4; ++ch) {
        const int col = (ch * 16 + tx) * 4;
        if (col < p.dh) {
          store4(p.o, row + col,
                 make_float4(acc[i][ch * 4 + 0] / denom,
                             acc[i][ch * 4 + 1] / denom,
                             acc[i][ch * 4 + 2] / denom,
                             acc[i][ch * 4 + 3] / denom),
                 bf16);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        const int col = tx * TD + t;
        if (col < p.dh) store1(p.o, row + col, acc[i][t] / denom, bf16);
      }
    }
  }
}

template <int BQ, int BK, int DHP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes =
      sizeof(float) *
      (BQ * (DHP + 4) + BK * (DHP + 4) + BK * DHP + BQ * (BK + 16));
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

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise.  Returns the
// CUDA error code of the launch (0 = success).  block_q, block_k in
// {32, 64, 128}; a tile that exceeds the shared memory of one block is
// refused with cudaErrorInvalidValue.  dh must be a multiple of 4, at most
// 128, and every row (pointer and strides) 16-byte aligned for f32, 8-byte
// for bf16.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KVH, int Sq, int Skv, int dh, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, int block_q,
    int block_k, int is_bf16, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || Sq <= 0 || Skv <= 0 || dh <= 0 ||
      dh > 128 || dh % 4 != 0 || H % KVH != 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.KVH = KVH; p.Sq = Sq; p.Skv = Skv; p.dh = dh;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal; p.window = window; p.is_bf16 = is_bf16;
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
