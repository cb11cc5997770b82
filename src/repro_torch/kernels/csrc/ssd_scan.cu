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
// with the (P, N) state carried from chunk to chunk.  f32 or bf16 x and B/C
// (independently), dt and A in f32, all arithmetic in f32; y in x's type,
// h_final (Bz,H,P,N) in f32.  The exponent exp(cum_i - cum_j) is evaluated
// only where j <= i: above the diagonal it would overflow.
//
// What differs from the TPU kernel.  There the chunks are the innermost,
// sequential grid dimension and the state sits in VMEM scratch between grid
// steps.  Hopper has no ordered grid dimension: here one thread block owns a
// (b, h, slice of P) tile and walks the chunks itself, with the state in
// shared memory for the whole walk, so the state never goes back to device
// memory between chunks.  Columns p of y and rows p of the state are
// independent, so P may be split across blocks; each block then recomputes
// the cumsum and C B^T, which are cheap next to the P-sized products.
//
// Shared memory, not registers, is what limits the tile.  At chunk 128 and
// N = 128 the chunk's B (Q x N), C (Q x N) and the Q x Q weight matrix in f32
// would need 192 KB before x and the state, and chunk 256 needs 256 KB for
// the weights alone.  So the Q x Q work is strip-mined: the block keeps the
// chunk's B and x, and builds W for a strip of 32 query rows at a time (only
// the columns j < end of strip, those at or below the diagonal), turns it
// into 32 rows of y, and moves on; C is loaded one strip at a time.  N is
// padded to 16/32/64/128 with zeros; the P slice per block (64, 32 or 16) is
// the largest that fits (`pick_p_block` below; `ssd_scan_tile` reports it).
// Any chunk from 1 to 256 is taken: rows beyond the chunk are zero-filled
// and masked.
//
// What bounds it on this card.  Per (b, h, chunk) the function moves Q(P + 2N)
// inputs and QP outputs and does 2(Q^2 N + Q^2 P + 2QPN) operations (counted
// as the reference's schedule_props counts them): at zamba2's shape the
// bytes (x and y dominate) set the bound, about 0.05 ms.  The reference keeps
// every product in f32 and f32 inputs hold a 5e-4 tolerance, so this first
// version runs all products as fused multiply-adds on register tiles on the
// FP32 pipes (67 TFLOP/s), which alone cost about 0.6 ms at that shape;
// moving the three products onto mma.sync/wgmma is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 32;               // query rows of W per pass
constexpr size_t kSmemLimit = 232448;    // bytes one block may use on sm_90

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

}  // namespace

// The tile ssd_scan_forward launches for (P, N, chunk): the P slice one block
// owns and the bytes of shared memory that block uses.  Returns
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssd_scan_tile(int P, int N, int chunk, int* p_block,
                             long long* smem_bytes) {
  if (!shape_ok(P, N, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  *p_block = pick_p_block(P, N, chunk);
  *smem_bytes = static_cast<long long>(
      sizeof(float) *
      smem_floats(round_up(chunk, 64), padded_state(N), *p_block));
  return 0;
}

// Launches on `stream`, allocates nothing, does not synchronise.  Returns the
// CUDA error code of the launch (0 = success).  chunk in [1, 256] dividing L;
// N at most 128 and P any size, both multiples of 4; every row of x, B, C and
// y (pointer and strides) 16-byte aligned for f32, 8-byte for bf16; dt and A
// f32, dt strided, A contiguous; h_out contiguous f32 (Bz, H, P, N).  The
// tile is the one ssd_scan_tile reports.
extern "C" int ssd_scan_forward(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* h_out, int Bz, int H, int G, int L, int P,
    int N, int chunk, long long x_sb, long long x_sh, long long x_sl,
    long long dt_sb, long long dt_sh, long long dt_sl, long long b_sb,
    long long b_sg, long long b_sl, long long c_sb, long long c_sg,
    long long c_sl, long long y_sb, long long y_sh, long long y_sl,
    int x_bf16, int bc_bf16, void* stream) {
  if (Bz <= 0 || H <= 0 || G <= 0 || L <= 0 || !shape_ok(P, N, chunk) ||
      L % chunk != 0 || H % G != 0 || H > 65535 || Bz > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
