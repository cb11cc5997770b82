// Mamba2 SSD scan (state-space duality) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `_kernel` / `ssd_scan` of the JAX package
// (src/repro/kernels/ssd_scan.py).  Same function: x (Bz,H,L,P), dt (Bz,H,L),
// A (H,), B and C (Bz,G,L,N) with B/C read at group h / (H/G) (no repeat);
// per chunk of Q steps
//     cum   = cumsum(dt * A)
//     W     = (C B^T) * exp(cum_i - cum_j) * dt_j      for j <= i, else 0
//     y     = W x + (C * exp(cum)) h_prev^T
//     h_new = exp(cum_Q) h_prev + (B * dt * exp(cum_Q - cum))^T x
// with the (P, N) state carried from chunk to chunk; y in x's type, h_final
// (Bz,H,P,N) in f32.  The exponent exp(cum_i - cum_j) is evaluated only
// where j <= i (above the diagonal it would overflow): the exponent is
// masked, never the product, as in the reference.
//
// What differs from the TPU kernel.  There the chunks are the innermost,
// sequential grid dimension and the state sits in VMEM scratch between grid
// steps.  Hopper has no ordered grid dimension: in both kernels below one
// thread block owns a (b, h, slice of P) and walks the chunks itself with the
// state on the chip, so the state never goes back to device memory between
// chunks.  Columns p of y and rows p of the state are independent, so P may
// be split across blocks; each block then recomputes the cumsum and C B^T.
//
// What bounds it on this card.  Per (b, h, chunk) the function moves Q(P + 2N)
// inputs and QP outputs and does 2(Q^2 N + Q^2 P + 2QPN) operations (counted
// as the reference's schedule_props counts them): at the serving paths'
// shapes the bytes (x in, y out) set the bound, 0.053 ms at zamba2-2.7b's
// shape and 0.023 ms at mamba2-370m's.  The same operations take 0.48 ms on
// the FP32 pipes (67 TFLOP/s) and 0.033 ms on the bf16 tensor cores.
//
// The variant is chosen before the launch, by the caller (`pick_variant` in
// kernels/ssd_scan.py), and passed in; ssd_scan_tile reports its tile.
//
// bf16 (ssd_wgmma_kernel: x, B and C all bf16, chunk 64, 128 or 256, P and
// N multiples of 16 up to 128, every operand readable by TMA):
//   * The chunk has the shape of attention with a decay mask: C plays q, B
//     plays k, x plays v and W plays P.  Q / 64 consumer warpgroups of 64
//     chunk rows and a producer.  At chunk 128 the producer is a warpgroup:
//     ptxas budgets 168 registers a thread for 384 threads (as for 288: the
//     register file is split over four sub-partitions), and setmaxnreg
//     moves them to the consumers, 40 / 232, exactly the block's 384 x 168
//     (asking for more leaves setmaxnreg.inc waiting forever).  At chunk 64
//     one warp produces for one consumer warpgroup (160 threads).
//   * A ring of 3 chunk stages (2 at chunk 128 with N > 64, where 3 do not
//     fit) holds x (Q x 64), B and C (Q x N) in bf16, filled by TMA through
//     4-D tensor maps with the caller's strides (x over (P, L, H, Bz), B and
//     C over (N, L, G, Bz)), 128-byte swizzle, zeros past P and N.  dt
//     cannot go through TMA (its per-head box is 4 bytes wide): a producer
//     warp loads it with ordinary loads and writes cum, dt and
//     dt exp(cum_Q - cum) of each stage, signalled on the same mbarrier as
//     the copies.
//   * All four products run on wgmma with f32 accumulators: S = C B^T (both
//     K-major), y = C h^T (h K-major), then y scaled by exp(cum_i) and
//     y += W x (W the A operand from registers, x MN-major through the
//     transpose bit), and h = exp(cum_Q) h + (x w_end)^T B (A from registers,
//     read transposed from the x tile by ldmatrix; B MN-major).  The 64 x 64
//     tiles of S and W above the diagonal are skipped: the first warpgroup
//     forms 64 columns, the second 128.
//   * The decay exp(cum_i - cum_j) of W is ex2.approx of the difference
//     times log2(e) (relative error near 1e-6 at the serving paths' decays,
//     and cheaper than expf); the other exponents, a few per row, are expf.
//   * No rounding that the f32 reference does not make: x, B and C are exact
//     in bf16, so S needs one product; W, h and x w_end are f32 values, each
//     fed as hi = bf16(v) and lo = bf16(v - hi), both products summed (about
//     17 significant bits, against 8 for a single bf16 operand).
//   * The state stays in the accumulator registers of the first warpgroup
//     for the whole walk (it has half the S work of the second); after each
//     chunk it writes h as hi/lo bf16 into shared memory, the K-major B
//     operand of the next chunk's C h^T, ordered by named barriers (h
//     written -> read; read -> overwritten).  That warpgroup overlaps its
//     products in pairs (S beside C h^T, W x beside the first half of the
//     state update).  h_final is written once, f32.
//   Shared memory at chunk 128: 3 x 48 KB + 16 KB at N <= 64, 2 x 80 KB +
//   32 KB at N 128; one block per SM.
//   * A chunk of 256 is walked as two halves of 128 rows by the chunk-128
//     instance (`wg_rows`): the same two consumer warpgroups, the state
//     carried in the owner's registers from one half to the next.  The
//     chunked recurrence is exact for any chunk, so the halves' y and
//     h_final equal the 256-step chunk's in exact arithmetic (and the
//     cumsum restarts every 128 steps).  A true 256-row chunk would double
//     the quadratic products of a row (C B^T and W x grow with the chunk),
//     hold 4 consumer warpgroups at 120 registers a thread against the 128
//     one 64 x 256 f32 accumulator needs, and fit 2 ring stages at N 64, 1
//     at N 128.  So the training step's chunk of 256, which suits the
//     backward's recompute, runs on the tensor cores at the cost of 128.
//
// f32 and mixed types, and bf16 the rule above sends elsewhere
// (ssd_fwd_kernel): all arithmetic in f32 on the FP32 pipes, which alone
// cost about 0.5 ms at zamba2's shape.  The block keeps the chunk's B and x
// in shared memory as f32 and builds W for a strip of 32 query rows at a
// time (only the columns j < end of strip), turns it into 32 rows of y, and
// moves on; C is loaded one strip at a time; the state sits in shared
// memory.  N is padded to 16/32/64/128 with zeros; the P slice per block
// (64, 32 or 16) is the largest that fits (`pick_p_block`).  Any chunk from
// 1 to 256 is taken: rows beyond the chunk are zero-filled and masked.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ===========================================================================
// f32: FP32 pipes
// ===========================================================================

constexpr int kThreads = 256;
constexpr int kStrip = 32;               // query rows of W per pass

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* h_out;  // (Bz, H, P, N), contiguous
  int Bz, H, G, L, P, N, chunk;
  // strides in elements; the last dimension of x, B, C, y has stride 1
  long long x_sb, x_sh, x_sl;
  long long dt_sb, dt_sh, dt_sl;
  long long b_sb, b_sg, b_sl;
  long long c_sb, c_sg, c_sl;
  long long y_sb, y_sh, y_sl;
  int x_bf16, bc_bf16;
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Floats of shared memory for one block.
__host__ __device__ constexpr size_t smem_floats(int Qa, int NP, int PB) {
  return static_cast<size_t>(Qa) * (NP + 4)        // B of the chunk
         + static_cast<size_t>(Qa) * PB            // x of the chunk
         + static_cast<size_t>(kStrip) * (NP + 4)  // C of the strip
         + static_cast<size_t>(kStrip) * (Qa + 4)  // W of the strip
         + static_cast<size_t>(NP) * PB            // state, [n][p]
         + 4 * static_cast<size_t>(Qa)             // cum, dt, w_end, e_cum
         + 32;                                     // warp totals of the scan
}

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

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, const float4& x, float* acc) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}

// Copies `rows` rows of `cols` values (global row r0 + r, columns c0 + c,
// all four of a float4 valid or none) into shared memory as f32; rows at or
// beyond `n_rows` and columns at or beyond `n_cols` are zero-filled.
template <int WIDTH>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const void* src, long long base,
                                          long long row_stride, int rows,
                                          int n_rows, int c0, int n_cols,
                                          bool bf16, int tid) {
  constexpr int V4 = WIDTH / 4;
  for (int idx = tid; idx < rows * V4; idx += kThreads) {
    const int r = idx / V4;
    const int c = (idx % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && c0 + c < n_cols) {
      val = load4(src, base + static_cast<long long>(r) * row_stride + c0 + c,
                  bf16);
    }
    *reinterpret_cast<float4*>(dst + r * dst_stride + c) = val;
  }
}

template <int NP, int PB>
__global__ void __launch_bounds__(kThreads) ssd_fwd_kernel(const Params p) {
  constexpr int BS = NP + 4;               // row stride of B and C tiles
  constexpr int L4 = PB / 4;               // float4 lanes across a P slice
  constexpr int RG = kThreads / L4;        // row groups
  constexpr int YR = (kStrip + RG - 1) / RG;  // y rows per thread
  constexpr int SR = (NP + RG - 1) / RG;      // state rows per thread

  const int Q = p.chunk;
  const int Qa = round_up(Q, 64);
  const int WS = Qa + 4;                   // row stride of the W strip

  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;
  float* Xs = Bs + Qa * BS;
  float* Cs = Xs + Qa * PB;
  float* Ws = Cs + kStrip * BS;
  float* Hs = Ws + kStrip * WS;
  float* cum = Hs + NP * PB;
  float* dts = cum + Qa;
  float* wend = dts + Qa;
  float* ecum = wend + Qa;
  float* wsum = ecum + Qa;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const bool xbf = p.x_bf16 != 0;
  const bool bcbf = p.bc_bf16 != 0;
  const float A = p.A[h];
  const int n_chunks = p.L / Q;

  const long long x_base = b * p.x_sb + h * p.x_sh;
  const long long y_base = b * p.y_sb + h * p.y_sh;
  const long long dt_base = b * p.dt_sb + h * p.dt_sh;
  const long long b_base = b * p.b_sb + g * p.b_sg;
  const long long c_base = b * p.c_sb + g * p.c_sg;

  // y and the state: thread owns float4 column pc of the slice and rows
  // rg + RG * a
  const int pc = (tid % L4) * 4;
  const int rg = tid / L4;
  const bool p_ok = p0 + pc < p.P;
  // the W strip: a 16 x 16 grid, rows ty + 16 a, columns tx + 16 k
  const int ty = tid >> 4;
  const int tx = tid & 15;

  for (int e = tid; e < NP * PB; e += kThreads) Hs[e] = 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const long long t0 = static_cast<long long>(ci) * Q;
    __syncthreads();  // the previous chunk is done with every tile

    // ---- dt * A and its inclusive cumsum (one value per thread) ---------
    float d = 0.f;
    if (tid < Q) d = p.dt[dt_base + (t0 + tid) * p.dt_sl];
    float v = d * A;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;

    // ---- B and x of the chunk --------------------------------------------
    load_rows<NP>(Bs, BS, p.B, b_base + t0 * p.b_sl, p.b_sl, Qa, Q, 0, p.N,
                  bcbf, tid);
    load_rows<PB>(Xs, PB, p.x, x_base + t0 * p.x_sl, p.x_sl, Qa, Q, p0, p.P,
                  xbf, tid);
    __syncthreads();

    for (int w = 0; w < warp; ++w) v += wsum[w];
    if (tid < Qa) {
      cum[tid] = tid < Q ? v : 0.f;
      dts[tid] = d;
    }
    __syncthreads();
    if (tid < Qa) {
      const bool in = tid < Q;
      wend[tid] = in ? d * expf(cum[Q - 1] - v) : 0.f;
      ecum[tid] = in ? expf(v) : 0.f;
    }
    // (visible after the first barrier of the strip loop)

    // ---- y, one strip of 32 query rows at a time -------------------------
    for (int i0 = 0; i0 < Q; i0 += kStrip) {
      load_rows<NP>(Cs, BS, p.C, c_base + (t0 + i0) * p.c_sl, p.c_sl, kStrip,
                    Q - i0, 0, p.N, bcbf, tid);
      __syncthreads();

      // W[i, j] for i in the strip and j < jn (the others are 0)
      const int jn = min(i0 + kStrip, Q);
      for (int jb = 0; jb < jn; jb += 64) {
        float s[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[a][k] = 0.f;
#pragma unroll 4
        for (int n = 0; n < NP; n += 4) {
          const float4 c0 = *reinterpret_cast<const float4*>(Cs + ty * BS + n);
          const float4 c1 =
              *reinterpret_cast<const float4*>(Cs + (ty + 16) * BS + n);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 bv = *reinterpret_cast<const float4*>(
                Bs + (jb + tx + 16 * k) * BS + n);
            s[0][k] = dot4(c0, bv, s[0][k]);
            s[1][k] = dot4(c1, bv, s[1][k]);
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = jb + tx + 16 * k;
            // the exponent is formed only at or below the diagonal
            Ws[(ty + 16 * a) * WS + j] =
                (i < Q && j <= i) ? s[a][k] * expf(cum[i] - cum[j]) * dts[j]
                                  : 0.f;
          }
        }
      }
      __syncthreads();

      // y = W x + exp(cum) * (C h_prev^T), rows rg + RG a, columns pc..pc+3
      float acc[YR][4], inter[YR][4];
#pragma unroll
      for (int a = 0; a < YR; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = inter[a][c] = 0.f;
      const int jn4 = round_up(jn, 4);
      for (int j = 0; j < jn4; j += 4) {
        float4 wv[YR];
#pragma unroll
        for (int a = 0; a < YR; ++a) {
          const int r = rg + RG * a;
          wv[a] = r < kStrip
                      ? *reinterpret_cast<const float4*>(Ws + r * WS + j)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 xv =
              *reinterpret_cast<const float4*>(Xs + (j + cc) * PB + pc);
#pragma unroll
          for (int a = 0; a < YR; ++a) axpy4(component(wv[a], cc), xv, acc[a]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < NP; n += 4) {
        float4 cv[YR];
#pragma unroll
        for (int a = 0; a < YR; ++a) {
          const int r = rg + RG * a;
          cv[a] = r < kStrip
                      ? *reinterpret_cast<const float4*>(Cs + r * BS + n)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 hv =
              *reinterpret_cast<const float4*>(Hs + (n + cc) * PB + pc);
#pragma unroll
          for (int a = 0; a < YR; ++a)
            axpy4(component(cv[a], cc), hv, inter[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < YR; ++a) {
        const int r = rg + RG * a;
        const int i = i0 + r;
        if (r < kStrip && i < Q && p_ok) {
          const float e = ecum[i];
          store4(p.y, y_base + (t0 + i) * p.y_sl + p0 + pc,
                 make_float4(fmaf(e, inter[a][0], acc[a][0]),
                             fmaf(e, inter[a][1], acc[a][1]),
                             fmaf(e, inter[a][2], acc[a][2]),
                             fmaf(e, inter[a][3], acc[a][3])),
                 xbf);
        }
      }
      __syncthreads();  // the next strip overwrites C and W
    }

    // ---- the state: h = exp(cum_Q) h + (B * dt * exp(cum_Q - cum))^T x ----
    const float decay = expf(cum[Q - 1]);
    float hs[SR][4];
#pragma unroll
    for (int a = 0; a < SR; ++a) {
      const int n = rg + RG * a;
      const float4 hv = n < NP
                            ? *reinterpret_cast<const float4*>(Hs + n * PB + pc)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      hs[a][0] = hv.x * decay;
      hs[a][1] = hv.y * decay;
      hs[a][2] = hv.z * decay;
      hs[a][3] = hv.w * decay;
    }
    for (int j = 0; j < Q; ++j) {
      const float wj = wend[j];
      const float4 xv = *reinterpret_cast<const float4*>(Xs + j * PB + pc);
#pragma unroll
      for (int a = 0; a < SR; ++a) {
        const int n = rg + RG * a;
        if (n < NP) axpy4(Bs[j * BS + n] * wj, xv, hs[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < SR; ++a) {
      const int n = rg + RG * a;
      if (n < NP) {
        *reinterpret_cast<float4*>(Hs + n * PB + pc) =
            make_float4(hs[a][0], hs[a][1], hs[a][2], hs[a][3]);
      }
    }
  }
  __syncthreads();

  // ---- h_final (Bz, H, P, N) ---------------------------------------------
  float* hout = p.h_out + (static_cast<long long>(b) * p.H + h) *
                              static_cast<long long>(p.P) * p.N;
  for (int e = tid; e < PB * NP; e += kThreads) {
    const int pp = e / NP;
    const int n = e % NP;
    if (p0 + pp < p.P && n < p.N) {
      hout[static_cast<long long>(p0 + pp) * p.N + n] = Hs[n * PB + pp];
    }
  }
}

template <int NP, int PB>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * smem_floats(round_up(p.chunk, 64), NP, PB);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = ssd_fwd_kernel<NP, PB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  // two blocks of zamba2's tile (109 KB each) share an SM only if the L1 /
  // shared split gives shared memory all it can have
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.P + PB - 1) / PB, p.H, p.Bz);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_pb(const Params& p, int p_block, cudaStream_t stream) {
  switch (p_block) {
    case 16: return launch<NP, 16>(p, stream);
    case 32: return launch<NP, 32>(p, stream);
    case 64: return launch<NP, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// N padded to the widths the kernel is built for.
int padded_state(int N) {
  return N <= 16 ? 16 : (N <= 32 ? 32 : (N <= 64 ? 64 : 128));
}

// The P slice one block owns: the smallest of 16/32/64 that covers P (64 for
// larger P), halved until the block's tiles fit shared memory; 0 if none
// fits (never at chunk <= 256 and N <= 128: a slice of 16 then takes at most
// 214 KB).
int pick_p_block(int P, int N, int chunk) {
  int pb = P <= 16 ? 16 : (P <= 32 ? 32 : 64);
  while (sizeof(float) * smem_floats(round_up(chunk, 64), padded_state(N),
                                     pb) > kSmemLimit) {
    if (pb == 16) return 0;
    pb /= 2;
  }
  return pb;
}

bool shape_ok(int P, int N, int chunk) {
  return P > 0 && N > 0 && chunk > 0 && chunk <= 256 && N <= 128 &&
         N % 4 == 0 && P % 4 == 0 && pick_p_block(P, N, chunk) != 0;
}


// ===========================================================================
// bf16: wgmma tensor cores, TMA-fed chunk ring, the state on the chip
// ===========================================================================

constexpr int kPB = 64;              // P slice of a block: one 128-byte row
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRow = 128;            // bytes of a tile row = the swizzle span
// setmaxnreg at chunk 128: 128 x 40 + 256 x 232 = 384 x 168, the registers
// the block is launched with (asking for more hangs the consumers)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barriers: h is in shared memory (owner arrives, the other warpgroup
// waits); every reader of h is done (the other arrives, the owner waits);
// the owner's own warps have written h
constexpr int kBarHReady = 1;
constexpr int kBarHRead = 2;
constexpr int kBarOwner = 3;

template <int Q, int NP>
struct WgTile {
  static constexpr int kConsumers = Q / 64;       // warpgroups of 64 rows
  // + the producer: a warpgroup where setmaxnreg moves registers to the
  // consumers (two consumer warpgroups), else one warp
  static constexpr int kThreads =
      128 * kConsumers + (kConsumers == 2 ? 128 : 32);
  static constexpr int kXBytes = Q * kRow;        // x: Q rows x 64 columns
  static constexpr int kBCBytes = NP / 64 * Q * kRow;   // B or C: Q x NP
  static constexpr int kStageBytes = kXBytes + 2 * kBCBytes;
  static constexpr int kHBytes = NP / 64 * kPB * kRow;  // h hi or lo: 64 x NP
  static constexpr int kScalarBytes = 3 * Q * 4;  // cum, dt, w_end
  // 1024 bytes of slack to align the tiles to the swizzle atom
  static constexpr size_t smem(int stages) {
    return 1024 + stages * (kStageBytes + kScalarBytes) + 2 * kHBytes
           + 16 * stages;
  }
  static constexpr int kStages = smem(3) <= kSmemLimit ? 3 : 2;
  static constexpr size_t kSmem = smem(kStages);
  static constexpr int kHOffset = kStages * kStageBytes;
  static constexpr int kScalarOffset = kHOffset + 2 * kHBytes;
  static constexpr int kBarOffset = kScalarOffset + kStages * kScalarBytes;
  static_assert(kSmem <= kSmemLimit, "the bf16 tile must fit one block");
};

struct WgParams {
  const float* dt;
  const float* A;
  __nv_bfloat16* y;
  float* h_out;                      // (Bz, H, P, N), contiguous
  int H, G, L, P, N;
  long long dt_sb, dt_sh, dt_sl;     // elements
  long long y_sb, y_sh, y_sl;        // elements; y's last dimension stride 1
};

// The work of one consumer warpgroup over the whole walk.  W: columns of S
// it forms (those at or left of its diagonal tile); OWNER: it holds the
// state (the first warpgroup, which has half the S and W x work of the
// second).  The owner issues its products in overlapping pairs: S beside
// C h^T, and W x beside the state update.
template <int Q, int NP, int W, bool OWNER>
__device__ __forceinline__ void ssd_consumer(uint8_t* smem, const WgParams& p,
                                             int ct, int p0, int h, int b) {
  using T = WgTile<Q, NP>;
  constexpr int S = T::kStages;
  constexpr int KN = NP / 16;        // k-steps over the state width
  constexpr int KW = W / 16;         // k-steps of W x
  constexpr int KQ = Q / 16;         // k-steps of the state update
  constexpr int CONS = 128 * T::kConsumers;
  const int cw = ct >> 7;            // rows 64 cw .. 64 cw + 63 of a chunk
  const int wq = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int gr = lane >> 2, qc = lane & 3;
  const int r0 = cw * 64 + wq * 16 + gr;  // this thread's rows: r0, r0 + 8
  const int pr = wq * 16 + gr;            // its state rows: pr, pr + 8
  uint8_t* h_hi = smem + T::kHOffset;
  uint8_t* h_lo = h_hi + T::kHBytes;
  const float* scal = reinterpret_cast<const float*>(smem + T::kScalarOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* empty = full + S;
  const int n_chunks = p.L / Q;

  float hs[OWNER ? NP / 2 : 1];
  // h as the hi/lo B operand of the next C h^T, visible to the async proxy
  // and to the other warpgroup
  auto publish_h = [&](bool more) {
    fence_proxy_async();
    named_sync(kBarOwner, 128);
    if (T::kConsumers == 2 && more) named_arrive(kBarHReady, CONS);
  };
  if constexpr (OWNER) {
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) hs[i] = 0.f;
    for (int e = ct; e < 2 * T::kHBytes / 16; e += 128)
      reinterpret_cast<uint4*>(h_hi)[e] = make_uint4(0u, 0u, 0u, 0u);
    publish_h(true);
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % S;
    uint8_t* x_s = smem + s * T::kStageBytes;
    uint8_t* b_s = x_s + T::kXBytes;
    uint8_t* c_s = b_s + T::kBCBytes;
    const float* cum = scal + s * 3 * Q;
    const float* dts = cum + Q;
    const float* wend = dts + Q;
    const uint32_t a_rows = smem_u32(c_s) + cw * 64 * kRow;  // C, my rows
    float sc[W / 2];
    float y[32];
    // y = C h^T, both halves of h: one committed group
    auto issue_c_h = [&]() {
#pragma unroll
      for (int kk = 0; kk < 2 * KN; ++kk) {
        const int k = kk % KN;
        const uint32_t off = (k >> 2) * Q * kRow + (k & 3) * 32;
        const uint32_t hoff = (k >> 2) * kPB * kRow + (k & 3) * 32;
        wgmma_ss_n64<0>(y, smem_desc(a_rows + off),
                        smem_desc(smem_u32(kk < KN ? h_hi : h_lo) + hoff),
                        kk > 0);
      }
      wgmma_commit();
    };
    mbar_wait(full + s, (c / S) & 1);

    // ---- S = C B^T over this warpgroup's 64 rows and W columns -----------
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      const uint32_t off = (kk >> 2) * Q * kRow + (kk & 3) * 32;
      const uint64_t da = smem_desc(a_rows + off);
      const uint64_t db = smem_desc(smem_u32(b_s) + off);
      if constexpr (W == 64) wgmma_ss_n64<0>(sc, da, db, kk > 0);
      else wgmma_ss_n128<0>(sc, da, db, kk > 0);
    }
    wgmma_commit();
    if constexpr (OWNER) {
      issue_c_h();                   // its own h: published at the last chunk
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs<W / 2>(sc);

    // ---- W = S exp(cum_i - cum_j) dt_j (j <= i), as hi + lo A fragments --
    const float ci0 = cum[r0], ci1 = cum[r0 + 8];
    uint32_t whi[KW][4], wlo[KW][4];
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + (e >> 1) * 8;
        const int col = 8 * j + 2 * qc + (e & 1);
        // mask the exponent, not the product
        const float arg = col <= i ? (e >> 1 ? ci1 : ci0) - cum[col] : -1e30f;
        v[e] = sc[4 * j + e] * fast_exp2(arg * kLog2e) * dts[col];
      }
      split_pair(v[0], v[1], whi[j >> 1][(j & 1) * 2],
                 wlo[j >> 1][(j & 1) * 2]);
      split_pair(v[2], v[3], whi[j >> 1][(j & 1) * 2 + 1],
                 wlo[j >> 1][(j & 1) * 2 + 1]);
    }

    // ---- y = exp(cum_i) (C h^T) + W x --------------------------------------
    if constexpr (OWNER) {
      wgmma_wait<0>();
    } else {
      named_sync(kBarHReady, CONS);  // the owner has published h
      wgmma_fence();
      issue_c_h();
      wgmma_wait<0>();
    }
    fence_regs<32>(y);
    if constexpr (!OWNER) named_arrive(kBarHRead, CONS);  // done with h
    const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[4 * j] *= e0;
      y[4 * j + 1] *= e0;
      y[4 * j + 2] *= e1;
      y[4 * j + 3] *= e1;
    }
    fence_regs<32>(y);
    fence_regs<KW * 4>(&whi[0][0]);
    fence_regs<KW * 4>(&wlo[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const uint64_t dx = smem_desc(smem_u32(x_s) + kk * 16 * kRow);
      wgmma_rs<64>(y, whi[kk], dx);
      wgmma_rs<64>(y, wlo[kk], dx);
    }
    wgmma_commit();

    // ---- h = exp(cum_Q) h + (x w_end)^T B, beside W x ----------------------
    // A (p x j) = (x w_end)^T, read transposed from the x tile and split
    // into hi + lo: lanes 8m..8m+7 address rows j of matrix m (j + 8 (m / 2),
    // p + 8 (m % 2)).  In two halves of the chunk, each its own group, so
    // only half of A is held at a time beside W x.
    auto state_half = [&](int half) {
      if constexpr (OWNER) {
        constexpr int KH = KQ / 2;
        uint32_t ahi[KH][4], alo[KH][4];
        const int mat = lane >> 3, rr = lane & 7;
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int kk = half * KH + k;
          const int j = kk * 16 + (mat >> 1) * 8 + rr;
          const int chunk16 = wq * 2 + (mat & 1);     // 8 values of p
          uint32_t raw[4];
          ldmatrix_x4_trans(raw, smem_u32(x_s) + j * kRow
                                     + ((chunk16 ^ (j & 7)) << 4));
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int jj = kk * 16 + (m >> 1) * 8 + 2 * qc;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&raw[m]));
            split_pair(xv.x * wend[jj], xv.y * wend[jj + 1], ahi[k][m],
                       alo[k][m]);
          }
        }
        fence_regs<NP / 2>(hs);
        fence_regs<KH * 4>(&ahi[0][0]);
        fence_regs<KH * 4>(&alo[0][0]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          // B MN-major: 64-column chunks Q rows of 128 bytes apart
          const uint64_t db = smem_desc(
              smem_u32(b_s) + (half * KH + k) * 16 * kRow, Q * kRow);
          wgmma_rs<NP>(hs, ahi[k], db);
          wgmma_rs<NP>(hs, alo[k], db);
        }
        wgmma_commit();
      }
    };
    if constexpr (OWNER) {
      const float decay = expf(cum[Q - 1]);
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) hs[i] *= decay;
      state_half(0);
      wgmma_wait<1>();               // W x is done
    } else {
      wgmma_wait<0>();
    }
    fence_regs<32>(y);

    __nv_bfloat16* yrow = p.y + b * p.y_sb + h * p.y_sh
                          + static_cast<long long>(c * Q + r0) * p.y_sl + p0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * qc;
      if (p0 + col < p.P) {
        *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
            __floats2bfloat162_rn(y[4 * j], y[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * p.y_sl + col) =
            __floats2bfloat162_rn(y[4 * j + 2], y[4 * j + 3]);
      }
    }

    if constexpr (OWNER) {
      state_half(1);
      wgmma_wait<0>();               // the state update is done
      fence_regs<NP / 2>(hs);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);   // this warp is done with stage s

    if constexpr (OWNER) {
      named_sync(kBarHRead, CONS);   // every warpgroup has read h
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = pr + 8 * half;
          const uint32_t off = (j >> 3) * kPB * kRow + row * kRow
                               + ((((j & 7) ^ (row & 7))) << 4) + 4 * qc;
          uint32_t hi, lo;
          split_pair(hs[4 * j + 2 * half], hs[4 * j + 2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(h_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(h_lo + off) = lo;
        }
      }
      publish_h(c + 1 < n_chunks);
    }
  }

  // ---- h_final (Bz, H, P, N), f32 ---------------------------------------
  if constexpr (OWNER) {
    float* hout = p.h_out + (static_cast<long long>(b) * p.H + h)
                                * static_cast<long long>(p.P) * p.N;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int n = 8 * j + 2 * qc;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = p0 + pr + 8 * half;
        if (row < p.P && n < p.N)
          *reinterpret_cast<float2*>(hout + static_cast<long long>(row) * p.N
                                     + n) =
              make_float2(hs[4 * j + 2 * half], hs[4 * j + 2 * half + 1]);
      }
    }
  }
}

template <int Q, int NP>
__global__ void __launch_bounds__(WgTile<Q, NP>::kThreads, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c, const WgParams p) {
  using T = WgTile<Q, NP>;
  constexpr int S = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* scal = reinterpret_cast<float*>(smem + T::kScalarOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* empty = full + S;

  const int p0 = blockIdx.x * kPB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int n_chunks = p.L / Q;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1 + 32);           // the copies, the scan's lanes
      mbar_init(empty + s, 4 * T::kConsumers);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128 * T::kConsumers) {
    // ---- consumer warpgroups of 64 chunk rows ----------------------------
    if constexpr (T::kConsumers == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(kConsumerRegs));
    if constexpr (T::kConsumers == 1) {
      ssd_consumer<Q, NP, 64, true>(smem, p, tid, p0, h, b);
    } else {
      if (tid < 128) ssd_consumer<Q, NP, 64, true>(smem, p, tid, p0, h, b);
      else ssd_consumer<Q, NP, 128, false>(smem, p, tid, p0, h, b);
    }
  } else {
    // ---- the producer: lane 0 of its first warp issues the copies, that
    // warp scans dt; cum = cumsum(dt A) of a chunk, Q / 32 steps a lane
    if constexpr (T::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(kProducerRegs));
    if (tid >= 128 * T::kConsumers + 32) return;
    constexpr int V = Q / 32;
    const int lane = tid & 31;
    const float A = p.A[h];
    const float* dtp = p.dt + b * p.dt_sb + h * p.dt_sh;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % S;
      if (c >= S) mbar_wait(empty + s, ((c / S) & 1) ^ 1);
      if (lane == 0) {
        uint8_t* st = smem + s * T::kStageBytes;
        mbar_expect_tx(full + s, T::kStageBytes);
        tma_load(st, &tm_x, full + s, p0, c * Q, h, b);
#pragma unroll
        for (int k = 0; k < NP / 64; ++k) {
          tma_load(st + T::kXBytes + k * Q * kRow, &tm_b, full + s, 64 * k,
                   c * Q, g, b);
          tma_load(st + T::kXBytes + T::kBCBytes + k * Q * kRow, &tm_c,
                   full + s, 64 * k, c * Q, g, b);
        }
      }
      float d[V], cv[V];
      float run = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        d[v] = dtp[static_cast<long long>(c * Q + lane * V + v) * p.dt_sl];
        run += d[v] * A;
        cv[v] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += u;
      }
      const float before = tot - run;
#pragma unroll
      for (int v = 0; v < V; ++v) cv[v] += before;
      const float last = __shfl_sync(0xffffffffu, cv[V - 1], 31);
      float* cum = scal + s * 3 * Q;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = lane * V + v;
        cum[j] = cv[v];
        cum[Q + j] = d[v];
        cum[2 * Q + j] = d[v] * expf(last - cv[v]);
      }
      mbar_arrive(full + s);
    }
  }
}

template <int Q, int NP>
cudaError_t launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tb,
                         const CUtensorMap& tc, const WgParams& p, int Bz,
                         cudaStream_t stream) {
  using T = WgTile<Q, NP>;
  auto kern = ssd_wgmma_kernel<Q, NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.P + kPB - 1) / kPB, p.H, Bz);
  kern<<<grid, T::kThreads, T::kSmem, stream>>>(tx, tb, tc, p);
  return cudaGetLastError();
}

bool wg_shape_ok(int P, int N, int chunk) {
  return (chunk == 64 || chunk == 128 || chunk == 256) && P > 0 && P <= 128
         && P % 16 == 0 && N > 0 && N <= 128 && N % 16 == 0;
}

// The chunk rows of the instance that walks `chunk`: 256 in halves of 128.
int wg_rows(int chunk) { return chunk == 256 ? 128 : chunk; }

int wg_state(int N) { return N <= 64 ? 64 : 128; }

void wg_tile(int N, int chunk, int* stages, long long* smem) {
  const bool q128 = wg_rows(chunk) == 128, n64 = wg_state(N) == 64;
  *stages = q128 ? (n64 ? WgTile<128, 64>::kStages : WgTile<128, 128>::kStages)
                 : (n64 ? WgTile<64, 64>::kStages : WgTile<64, 128>::kStages);
  *smem = static_cast<long long>(
      q128 ? (n64 ? WgTile<128, 64>::kSmem : WgTile<128, 128>::kSmem)
           : (n64 ? WgTile<64, 64>::kSmem : WgTile<64, 128>::kSmem));
}

}  // namespace

// The tile of `variant` (0: ssd_fwd_kernel, 1: ssd_wgmma_kernel) for
// (P, N, chunk): the P slice one block owns, the stages of the chunk ring (1:
// no ring) and the bytes of shared memory of that block.  Returns
// cudaErrorInvalidValue for a shape the variant does not take.
extern "C" int ssd_scan_tile(int P, int N, int chunk, int variant,
                             int* p_block, int* stages,
                             long long* smem_bytes) {
  if (variant == 1) {
    if (!wg_shape_ok(P, N, chunk))
      return static_cast<int>(cudaErrorInvalidValue);
    *p_block = kPB;
    wg_tile(N, chunk, stages, smem_bytes);
    return 0;
  }
  if (variant != 0 || !shape_ok(P, N, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  *p_block = pick_p_block(P, N, chunk);
  *stages = 1;
  *smem_bytes = static_cast<long long>(
      sizeof(float) *
      smem_floats(round_up(chunk, 64), padded_state(N), *p_block));
  return 0;
}

// Launches `variant` (0: ssd_fwd_kernel, 1: ssd_wgmma_kernel, chosen by the
// caller) on `stream`, allocates nothing, does not synchronise.  Returns the
// CUDA error code of the launch (0 = success).  Strides in elements; the
// last dimension of x, B, C and y has stride 1; dt and A f32, dt strided, A
// contiguous; h_out contiguous f32 (Bz, H, P, N).
//   0: chunk in [1, 256] dividing L; N at most 128 and P any size, both
//      multiples of 4; every row of x, B, C and y (pointer and strides)
//      16-byte aligned for f32, 8-byte for bf16.
//   1: x, B, C and y bf16; chunk 64, 128 or 256 dividing L (256 walked in
//      halves of 128); P and N multiples of 16 up to 128; bases of x, B
//      and C 16-byte aligned and their strides (of dimensions of extent
//      > 1) multiples of 8 elements, else cudaErrorMisalignedAddress; y's
//      strides even.
extern "C" int ssd_scan_forward(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* h_out, int Bz, int H, int G, int L, int P,
    int N, int chunk, long long x_sb, long long x_sh, long long x_sl,
    long long dt_sb, long long dt_sh, long long dt_sl, long long b_sb,
    long long b_sg, long long b_sl, long long c_sb, long long c_sg,
    long long c_sl, long long y_sb, long long y_sh, long long y_sl,
    int x_bf16, int bc_bf16, int variant, void* stream) {
  if (Bz <= 0 || H <= 0 || G <= 0 || L <= 0 || chunk <= 0 ||
      L % chunk != 0 || H % G != 0 || H > 65535 || Bz > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (!x_bf16 || !bc_bf16 || !wg_shape_ok(P, N, chunk))
      return static_cast<int>(cudaErrorInvalidValue);
    const int rows = wg_rows(chunk);
    CUtensorMap tx, tb, tc;
    cudaError_t err =
        encode_map(&tx, x, Bz, H, L, P, x_sb, x_sh, x_sl, rows);
    if (err == cudaSuccess)
      err = encode_map(&tb, B, Bz, G, L, N, b_sb, b_sg, b_sl, rows);
    if (err == cudaSuccess)
      err = encode_map(&tc, C, Bz, G, L, N, c_sb, c_sg, c_sl, rows);
    if (err != cudaSuccess) return static_cast<int>(err);
    WgParams p;
    p.dt = static_cast<const float*>(dt);
    p.A = static_cast<const float*>(A);
    p.y = static_cast<__nv_bfloat16*>(y);
    p.h_out = static_cast<float*>(h_out);
    p.H = H; p.G = G; p.L = L; p.P = P; p.N = N;
    p.dt_sb = dt_sb; p.dt_sh = dt_sh; p.dt_sl = dt_sl;
    p.y_sb = y_sb; p.y_sh = y_sh; p.y_sl = y_sl;
    if (rows == 128)
      err = wg_state(N) == 64 ? launch_wgmma<128, 64>(tx, tb, tc, p, Bz, s)
                              : launch_wgmma<128, 128>(tx, tb, tc, p, Bz, s);
    else
      err = wg_state(N) == 64 ? launch_wgmma<64, 64>(tx, tb, tc, p, Bz, s)
                              : launch_wgmma<64, 128>(tx, tb, tc, p, Bz, s);
    return static_cast<int>(err);
  }
  if (variant != 0 || !shape_ok(P, N, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A); p.B = B; p.C = C;
  p.y = y; p.h_out = static_cast<float*>(h_out);
  p.Bz = Bz; p.H = H; p.G = G; p.L = L; p.P = P; p.N = N; p.chunk = chunk;
  p.x_sb = x_sb; p.x_sh = x_sh; p.x_sl = x_sl;
  p.dt_sb = dt_sb; p.dt_sh = dt_sh; p.dt_sl = dt_sl;
  p.b_sb = b_sb; p.b_sg = b_sg; p.b_sl = b_sl;
  p.c_sb = c_sb; p.c_sg = c_sg; p.c_sl = c_sl;
  p.y_sb = y_sb; p.y_sh = y_sh; p.y_sl = y_sl;
  p.x_bf16 = x_bf16; p.bc_bf16 = bc_bf16;
  const int p_block = pick_p_block(P, N, chunk);
  cudaError_t err;
  switch (padded_state(N)) {
    case 16: err = launch_pb<16>(p, p_block, s); break;
    case 32: err = launch_pb<32>(p, p_block, s); break;
    case 64: err = launch_pb<64>(p, p_block, s); break;
    default: err = launch_pb<128>(p, p_block, s); break;
  }
  return static_cast<int>(err);
}
