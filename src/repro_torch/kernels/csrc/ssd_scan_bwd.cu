// The backward of the Mamba2 SSD scan (csrc/ssd_scan.cu's function) for
// NVIDIA Hopper, sm_90a: dx, ddt, dA, dB and dC from x, dt, A, B, C and dy.
//
// The forward, per (b, h) and chunk of rows (cum = cumsum(dt A) in the chunk,
// cend its last value):
//     W     = (C B^T) * exp(cum_i - cum_j) * dt_j      for j <= i, else 0
//     y     = W x + exp(cum) * (C h^T)
//     h_new = exp(cend) h + (x * w)^T B,   w_j = dt_j exp(cend - cum_j)
// The chunked recurrence is exact for any chunk, so the backward walks steps
// of its own, kT = 64 rows, whatever chunk the forward ran.  Four kernels,
// each one launch, whatever the number of steps:
//
//   1. ssd_bwd_states_kernel, a block per (step, head, batch x P slice of 64):
//      the step's own contributions to the state and to its gradient,
//          s_c = x^T (B * w)             (P x N)
//          u_c = dy^T (C * exp(cum))     (P x N)
//      and decay_c = exp(cend), into f32 workspaces.
//   2. ssd_bwd_scan_kernel, a thread per (b, h, p, n) and direction: the
//      short pass over the steps, in place: h at the start of every step
//      (h_0 = 0, h_{c+1} = decay_c h_c + s_c), and dh at the end of every
//      step (dh_{last} = 0, dh_{c-1} = decay_c dh_c + u_c).
//   3. ssd_bwd_grad_kernel, a block per (step, head, batch): rebuilds cum,
//      C B^T, the masked decay, W, dW = dy x^T and dS = dW * decay * dt_j on
//      chip (none of these T x T tiles leaves shared memory) and writes
//          dx = W^T dy + w * (B dh^T)
//          dC = dS B + exp(cum) * (dy h)        (this head's share)
//          dB = dS^T C + w * (x dh)             (this head's share)
//          ddt, through the reverse cumsum of the gradient of cum in the step
//          a partial of dA for the step.
//   4. ssd_bwd_reduce_kernel: dB and dC summed over the heads of a group, dA
//      over batch and steps, each in a fixed order (no atomics: two calls
//      give the same bits), each rounded once to its input's type.
//
// Precision is the plain path's, an f32 recompute of the chunked version
// under autograd (models/ssm.py).  Every product runs on the tensor cores as
// TF32 mma.sync (m16n8k8) with f32 accumulators: x, B, C and dy are bf16, so
// exact in TF32; each f32 operand (W, dS, h, dh, B w, C e^cum) enters as
// hi = tf32(v) and lo = tf32(v - hi), both products summed (about 21
// significant bits), so no intermediate is rounded to fewer bits than the
// pair holds.  The operands come from shared memory, in f32; a warp owns 16
// rows and 32 or 64 columns of a 64-row product.  x, B, C and dy are bf16
// with the last dimension contiguous and rows 8-byte aligned (4 elements a
// load); P and N multiples of 16 up to 128 (padded to 64 or 128 with zeros);
// L a multiple of kT.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;                 // rows of a step
constexpr int kThreads = 256;          // eight warps
constexpr size_t kSmemLimit = 232448;  // bytes one block may use on sm_90

struct BwdParams {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const __nv_bfloat16* dy;
  __nv_bfloat16* dx;
  float* ddt;       // (Bz, H, L), contiguous
  float* dA;        // (H,)
  __nv_bfloat16* dB;  // (Bz, G, L, N), contiguous
  __nv_bfloat16* dC;
  float* states;    // (Bz, H, nc, P, N): s_c, then h at the start of step c
  float* dstates;   // (Bz, H, nc, P, N): u_c, then dh at the end of step c
  float* decay;     // (Bz, H, nc)
  float* dB_part;   // (Bz, H, L, N): each head's share of dB
  float* dC_part;
  float* dA_part;   // (Bz, H, nc)
  int Bz, H, G, L, P, N;
  // strides in elements; the last dimension of x, B, C, dy, dx has stride 1
  long long x_sb, x_sh, x_sl;
  long long dt_sb, dt_sh, dt_sl;
  long long b_sb, b_sg, b_sl;
  long long c_sb, c_sg, c_sl;
  long long dy_sb, dy_sh, dy_sl;
  long long dx_sb, dx_sh, dx_sl;
};

__device__ __forceinline__ float4 bf16x4(const uint2& u) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float a,
                                             float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// kT rows of W columns of a bf16 matrix with row stride rs (from column c0;
// columns at or past n_cols read as 0): fetch() issues every load of the
// thread before any is waited on, store() writes the rows to shared memory
// as f32 with row stride ld, row r times scale[r] where scale is given.
template <int W>
struct Rows {
  static constexpr int V = W / 4;                   // 4 elements a load
  static constexpr int kIter = kT * V / kThreads;
  uint2 raw[kIter];

  __device__ __forceinline__ void fetch(const __nv_bfloat16* src,
                                        long long rs, int c0, int n_cols,
                                        int tid) {
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / V, c = (idx % V) * 4;
      raw[it] = c0 + c < n_cols
                    ? *reinterpret_cast<const uint2*>(src + r * rs + c0 + c)
                    : make_uint2(0u, 0u);
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld,
                                        const float* scale, int tid) const {
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / V, c = (idx % V) * 4;
      float4 v = bf16x4(raw[it]);
      if (scale != nullptr) {
        const float s = scale[r];
        v.x *= s; v.y *= s; v.z *= s; v.w *= s;
      }
      *reinterpret_cast<float4*>(dst + r * ld + c) = v;
    }
  }
};

// 64 rows (from row r0) of a step's h and dh, (P, N) f32 row-major, N padded
// to NP with zeros, rows past P zero: fetched as Rows are, stored with row
// stride ld; store() also adds the rows' sum of dh * h to dot.
template <int NP>
struct StateRows {
  static constexpr int V = NP / 4;
  static constexpr int kIter = 64 * V / kThreads;
  float4 dv[kIter], hv[kIter];

  __device__ __forceinline__ void fetch(const float* dh, const float* h,
                                        int r0, int P, int N, int tid) {
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
      const int idx = tid + it * kThreads;
      const int r = r0 + idx / V, n = (idx % V) * 4;
      dv[it] = hv[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < P && n < N) {
        const long long at = static_cast<long long>(r) * N + n;
        dv[it] = *reinterpret_cast<const float4*>(dh + at);
        hv[it] = *reinterpret_cast<const float4*>(h + at);
      }
    }
  }

  __device__ __forceinline__ void store(float* t_dh, float* t_h, int ld,
                                        float& dot, int tid) const {
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / V, n = (idx % V) * 4;
      *reinterpret_cast<float4*>(t_dh + r * ld + n) = dv[it];
      *reinterpret_cast<float4*>(t_h + r * ld + n) = hv[it];
      dot = dot4(dv[it], hv[it], dot);
    }
  }
};

// TF32 operands: tf32(v) rounded to nearest (ties away), and the hi + lo pair
// of an f32 value.  A bf16 value is exact in TF32 and enters as it is.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a b for a 16 x 8 A (row-major fragment) and an 8 x 8 B (column-major).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// Which operand of a product is an f32 value, entered as a hi + lo pair.
enum Split { kExact = 0, kSplitA = 1, kSplitB = 2 };

// What a thread owns of a 64-row product of NQ 64-column blocks: warp w takes
// rows rb .. rb + 15 (rb = 16 (w % 4)) and columns cb .. cb + 32 NQ - 1
// (cb = 32 NQ (w / 4)); its acc[t][e] is row rb + gr + 8 (e / 2), column
// cb + 8 t + 2 qc + e % 2 (gr = lane / 4, qc = lane % 4): mma's layout.
template <int NQ>
struct Own {
  int rb, cb, gr, qc;
  __device__ __forceinline__ explicit Own(int tid)
      : rb(((tid >> 5) & 3) * 16), cb((tid >> 7) * 32 * NQ),
        gr((tid & 31) >> 2), qc(tid & 3) {}
  __device__ __forceinline__ int row(int e) const {
    return rb + gr + 8 * (e >> 1);
  }
  __device__ __forceinline__ int col(int t, int e) const {
    return cb + 8 * t + 2 * qc + (e & 1);
  }
};

// acc += A B over k in [k0, k1) (multiples of 8) for the rows and columns
// `Own<NQ>` gives the thread.  A(m, k) is A[m lda + k] (AK) or A[k lda + m];
// B(k, n) is B[n ldb + k] (BK) or B[k ldb + n].
template <bool AK, bool BK, Split SPLIT, int NQ>
__device__ __forceinline__ void warp_mm(float (&acc)[4 * NQ][4],
                                        const float* A, int lda,
                                        const float* Bm, int ldb, int k0,
                                        int k1, const Own<NQ>& o) {
  const int r0 = o.rb + o.gr;
  for (int k = k0; k < k1; k += 8) {
    const int ka = k + o.qc;
    float av[4];
    if (AK) {
      av[0] = A[r0 * lda + ka];
      av[1] = A[(r0 + 8) * lda + ka];
      av[2] = A[r0 * lda + ka + 4];
      av[3] = A[(r0 + 8) * lda + ka + 4];
    } else {
      av[0] = A[ka * lda + r0];
      av[1] = A[ka * lda + r0 + 8];
      av[2] = A[(ka + 4) * lda + r0];
      av[3] = A[(ka + 4) * lda + r0 + 8];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (SPLIT == kSplitA) split_tf32(av[i], ah[i], al[i]);
      else ah[i] = __float_as_uint(av[i]);
    }
#pragma unroll
    for (int t = 0; t < 4 * NQ; ++t) {
      const int n = o.cb + 8 * t + o.gr;
      const float b0 = BK ? Bm[n * ldb + ka] : Bm[ka * ldb + n];
      const float b1 = BK ? Bm[n * ldb + ka + 4] : Bm[(ka + 4) * ldb + n];
      if (SPLIT == kSplitB) {
        uint32_t h0, l0, h1, l1;
        split_tf32(b0, h0, l0);
        split_tf32(b1, h1, l1);
        mma_tf32(acc[t], ah, h0, h1);
        mma_tf32(acc[t], ah, l0, l1);
      } else {
        mma_tf32(acc[t], ah, __float_as_uint(b0), __float_as_uint(b1));
        if (SPLIT == kSplitA)
          mma_tf32(acc[t], al, __float_as_uint(b0), __float_as_uint(b1));
      }
    }
  }
}

template <int NQ>
__device__ __forceinline__ void zero(float (&acc)[4 * NQ][4]) {
#pragma unroll
  for (int t = 0; t < 4 * NQ; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
}

// The sum over the 4 lanes of a quad (qc), and over the 8 rows of a warp's
// lanes (gr), each in a fixed order.
__device__ __forceinline__ float sum_quad(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float sum_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The scalars of step `c` of (b, h): dt, cum = cumsum(dt A), exp(cum),
// w = dt exp(cend - cum) and exp(cend - cum); the caller syncs after.
struct StepScalars {
  float* dts;
  float* cum;
  float* ecum;
  float* w;
  float* wx;
};

__device__ __forceinline__ void step_scalars(const BwdParams& p,
                                             const StepScalars& s, int b,
                                             int h, long long t0, float A,
                                             int tid) {
  // cumsum(dt A) over the step's 64 rows: a scan in each of two warps, the
  // first warp's total added to the second's
  const int lane = tid & 31;
  float d = 0.f, v = 0.f;
  if (tid < kT) {
    d = p.dt[b * p.dt_sb + h * p.dt_sh + (t0 + tid) * p.dt_sl];
    v = d * A;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) s.wx[tid >> 5] = v;
  }
  __syncthreads();
  if (tid < kT) {
    if (tid >= 32) v += s.wx[0];
    s.dts[tid] = d;
    s.cum[tid] = v;
  }
  __syncthreads();
  if (tid < kT) {
    const float e = expf(s.cum[kT - 1] - v);
    s.ecum[tid] = expf(v);
    s.wx[tid] = e;
    s.w[tid] = d * e;
  }
}

// ===========================================================================
// 1. the steps' own contributions to the state and to its gradient
// ===========================================================================

constexpr int kXS = 64 + 8;   // row stride of the states kernel's x, dy

template <int NP>
struct StatesTile {
  static constexpr int NL = NP + 8;   // row stride of B w and C e^cum
  static constexpr int kFloats = 2 * kT * kXS + 2 * kT * NL + 5 * kT;
  static constexpr size_t kSmem = sizeof(float) * kFloats;
  static_assert(kSmem <= kSmemLimit, "the states tile must fit one block");
};

template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(const BwdParams p) {
  constexpr int NQ = NP / 64;
  constexpr int NL = StatesTile<NP>::NL;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [kT][kXS]: x of the P slice
  float* ys = xs + kT * kXS;      // [kT][kXS]: dy of the P slice
  float* bw = ys + kT * kXS;      // [kT][NL]: B * w
  float* ce = bw + kT * NL;       // [kT][NL]: C * exp(cum)
  StepScalars sc;
  sc.dts = ce + kT * NL;
  sc.cum = sc.dts + kT;
  sc.ecum = sc.cum + kT;
  sc.w = sc.ecum + kT;
  sc.wx = sc.w + kT;

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int slices = (p.P + 63) / 64;
  const int b = blockIdx.z / slices;
  const int p0 = (blockIdx.z % slices) * 64;
  const int g = h / (p.H / p.G);
  const int nc = p.L / kT;
  const long long t0 = static_cast<long long>(c) * kT;

  Rows<64> rx, ry;
  Rows<NP> rb, rc;
  rx.fetch(p.x + b * p.x_sb + h * p.x_sh + t0 * p.x_sl, p.x_sl, p0, p.P,
           tid);
  ry.fetch(p.dy + b * p.dy_sb + h * p.dy_sh + t0 * p.dy_sl, p.dy_sl, p0,
           p.P, tid);
  rb.fetch(p.B + b * p.b_sb + g * p.b_sg + t0 * p.b_sl, p.b_sl, 0, p.N, tid);
  rc.fetch(p.C + b * p.c_sb + g * p.c_sg + t0 * p.c_sl, p.c_sl, 0, p.N, tid);
  step_scalars(p, sc, b, h, t0, p.A[h], tid);
  __syncthreads();
  rx.store(xs, kXS, nullptr, tid);
  ry.store(ys, kXS, nullptr, tid);
  rb.store(bw, NL, sc.w, tid);
  rc.store(ce, NL, sc.ecum, tid);
  __syncthreads();

  // s[p][n] = sum_j x[j][p] (B w)[j][n], u[p][n] = sum_i dy[i][p] (C e)[i][n]
  const Own<NQ> o(tid);
  float s[4 * NQ][4], u[4 * NQ][4];
  zero<NQ>(s);
  zero<NQ>(u);
  warp_mm<false, false, kSplitB, NQ>(s, xs, kXS, bw, NL, 0, kT, o);
  warp_mm<false, false, kSplitB, NQ>(u, ys, kXS, ce, NL, 0, kT, o);

  const long long base =
      ((static_cast<long long>(b) * p.H + h) * nc + c) *
      static_cast<long long>(p.P) * p.N;
#pragma unroll
  for (int t = 0; t < 4 * NQ; ++t) {
    const int n = o.col(t, 0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pp = p0 + o.row(2 * half);
      if (pp < p.P && n < p.N) {
        const long long at = base + static_cast<long long>(pp) * p.N + n;
        *reinterpret_cast<float2*>(p.states + at) =
            make_float2(s[t][2 * half], s[t][2 * half + 1]);
        *reinterpret_cast<float2*>(p.dstates + at) =
            make_float2(u[t][2 * half], u[t][2 * half + 1]);
      }
    }
  }
  if (tid == 0 && p0 == 0)
    p.decay[(static_cast<long long>(b) * p.H + h) * nc + c] =
        expf(sc.cum[kT - 1]);
}

// ===========================================================================
// 2. the pass over the steps: h at every step's start, dh at its end
// ===========================================================================

constexpr int kScanAhead = 16;  // steps whose loads are in flight at once

// blockIdx.y 0: the states, forward; 1: their gradients, backward.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_scan_kernel(const BwdParams p) {
  const long long PN = static_cast<long long>(p.P) * p.N;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= static_cast<long long>(p.Bz) * p.H * PN) return;
  const long long bh = e / PN;
  const long long i = e % PN;
  const int nc = p.L / kT;
  const bool back = blockIdx.y == 1;
  float* st = (back ? p.dstates : p.states) + bh * nc * PN + i;
  const float* dec = p.decay + bh * nc;

  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kScanAhead) {
    float v[kScanAhead];
#pragma unroll
    for (int k = 0; k < kScanAhead; ++k) {
      const int c = back ? nc - 1 - (c0 + k) : c0 + k;
      if (c0 + k < nc) v[k] = st[c * PN];
    }
#pragma unroll
    for (int k = 0; k < kScanAhead; ++k) {
      const int c = back ? nc - 1 - (c0 + k) : c0 + k;
      if (c0 + k < nc) {
        st[c * PN] = run;
        run = fmaf(dec[c], run, v[k]);
      }
    }
  }
}

// ===========================================================================
// 3. the gradients of a step
// ===========================================================================

template <int PP, int NP>
struct GradTile {
  static constexpr int XL = PP + 4;    // row strides of the step's tiles
  static constexpr int BL = NP + 4;
  static constexpr int WL = kT + 4;    // of W and dS
  static constexpr int NL = NP + 8;    // of a tile of h or dh rows
  static constexpr int DTL = PP + 8;   // of a tile of dh^T
  static constexpr int kR1 = 2 * kT * XL + 2 * kT * BL;   // x, dy, B, C
  static constexpr int kR2a = 2 * kT * WL;                // W, dS
  static constexpr int kR2b = 2 * 64 * NL;                // dh, h tiles
  static constexpr int kR2c = 64 * DTL;                   // a dh^T tile
  static constexpr int kR2 = kR2a > kR2b ? (kR2a > kR2c ? kR2a : kR2c)
                                         : (kR2b > kR2c ? kR2b : kR2c);
  // dts, cum, ecum, w, wx, rowG, colH; four totals; the partials of rowG,
  // dw, yint over the two column halves, of colH over the four row blocks;
  // the dot partials
  static constexpr int kScalars = 7 * kT + 4 + 3 * 2 * kT + 4 * kT + 8;
  static constexpr size_t kSmem = sizeof(float) * (kR1 + kR2 + kScalars);
  static_assert(kSmem <= kSmemLimit, "the gradient tile must fit one block");
  // two blocks an SM where shared memory allows (228 KB, 1 KB a block)
  static constexpr int kMinBlocks = kSmem + 1024 <= 233472 / 2 ? 2 : 1;
};

template <int PP, int NP>
__global__ void __launch_bounds__(kThreads, GradTile<PP, NP>::kMinBlocks)
ssd_bwd_grad_kernel(const BwdParams p) {
  using T = GradTile<PP, NP>;
  constexpr int NQP = PP / 64, NQN = NP / 64;
  constexpr int XL = T::XL, BL = T::BL, WL = T::WL, NL = T::NL,
                DTL = T::DTL;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [kT][XL]
  float* ys = xs + kT * XL;         // [kT][XL]  dy
  float* bs = ys + kT * XL;         // [kT][BL]
  float* cs = bs + kT * BL;         // [kT][BL]
  float* r2 = cs + kT * BL;
  float* ws = r2;                   // [kT][WL]  W
  float* dss = ws + kT * WL;        // [kT][WL]  dS
  float* t_a = r2;                  // [64][NL] dh rows, or [64][DTL] dh^T
  float* t_b = r2 + 64 * NL;        // [64][NL] h rows
  StepScalars sc;
  sc.dts = r2 + T::kR2;
  sc.cum = sc.dts + kT;
  sc.ecum = sc.cum + kT;
  sc.w = sc.ecum + kT;
  sc.wx = sc.w + kT;
  float* rowG = sc.wx + kT;
  float* colH = rowG + kT;
  float* dcum = colH + kT;          // [4]: the warps' totals
  float* rowpart = dcum + 4;          // [2][kT]
  float* dwpart = rowpart + 2 * kT;   // [2][kT]
  float* yipart = dwpart + 2 * kT;    // [2][kT]
  float* colpart = yipart + 2 * kT;   // [4][kT]
  float* dotpart = colpart + 4 * kT;  // [8]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int nc = p.L / kT;
  const long long t0 = static_cast<long long>(c) * kT;
  const float A = p.A[h];

  {
    Rows<PP> rx, ry;
    Rows<NP> rb, rc;
    rx.fetch(p.x + b * p.x_sb + h * p.x_sh + t0 * p.x_sl, p.x_sl, 0, p.P,
             tid);
    ry.fetch(p.dy + b * p.dy_sb + h * p.dy_sh + t0 * p.dy_sl, p.dy_sl, 0,
             p.P, tid);
    rb.fetch(p.B + b * p.b_sb + g * p.b_sg + t0 * p.b_sl, p.b_sl, 0, p.N,
             tid);
    rc.fetch(p.C + b * p.c_sb + g * p.c_sg + t0 * p.c_sl, p.c_sl, 0, p.N,
             tid);
    step_scalars(p, sc, b, h, t0, A, tid);
    rx.store(xs, XL, nullptr, tid);
    ry.store(ys, XL, nullptr, tid);
    rb.store(bs, BL, nullptr, tid);
    rc.store(cs, BL, nullptr, tid);
  }
  __syncthreads();

  // ---- S = C B^T and dW = dy x^T; W, dS and the cum terms of W ----------
  const Own<1> o1(tid);
  const int half = warp >> 2;       // the column half of a 64-column product
  {
    float sacc[4][4], wacc[4][4];
    zero<1>(sacc);
    zero<1>(wacc);
    warp_mm<true, true, kExact, 1>(sacc, cs, BL, bs, BL, 0, NP, o1);
    warp_mm<true, true, kExact, 1>(wacc, ys, XL, xs, XL, 0, PP, o1);
    float rg[2] = {0.f, 0.f}, ch[4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      ch[t][0] = ch[t][1] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = o1.row(e), j = o1.col(t, e);
        float wv = 0.f, dsv = 0.f;
        if (j <= i) {
          // the exponent is formed only at or below the diagonal
          const float dec = expf(sc.cum[i] - sc.cum[j]);
          const float dj = sc.dts[j];
          wv = sacc[t][e] * dec * dj;
          dsv = wacc[t][e] * dec * dj;
          const float hv = wacc[t][e] * sacc[t][e] * dec;  // dW S decay
          rg[e >> 1] = fmaf(hv, dj, rg[e >> 1]);
          ch[t][e & 1] += hv;
        }
        ws[i * WL + j] = wv;
        dss[i * WL + j] = dsv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = sum_quad(rg[r]);
      if (o1.qc == 0) rowpart[half * kT + o1.rb + o1.gr + 8 * r] = v;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = sum_rows(ch[t][e]);
        if (o1.gr == 0) colpart[(warp & 3) * kT + o1.col(t, e)] = v;
      }
  }
  __syncthreads();
  if (tid < kT) {
    rowG[tid] = rowpart[tid] + rowpart[kT + tid];
    colH[tid] = (colpart[tid] + colpart[kT + tid]) +
                (colpart[2 * kT + tid] + colpart[3 * kT + tid]);
  }

  // ---- the products with W and dS (zero above the diagonal) ------------
  // the first 64 rows of h and dh load meanwhile
  const long long sbase =
      ((static_cast<long long>(b) * p.H + h) * nc + c) *
      static_cast<long long>(p.P) * p.N;
  const float* hsrc = p.states + sbase;
  const float* dhsrc = p.dstates + sbase;
  StateRows<NP> st;
  st.fetch(dhsrc, hsrc, 0, p.P, p.N, tid);
  const Own<NQP> op(tid);
  const Own<NQN> on(tid);
  float dxa[4 * NQP][4], dca[4 * NQN][4], dba[4 * NQN][4];
  zero<NQP>(dxa);
  zero<NQN>(dca);
  zero<NQN>(dba);
  // dx[j] = sum over i >= j of W[i][j] dy[i]
  warp_mm<false, false, kSplitA, NQP>(dxa, ws, WL, ys, XL, op.rb, kT, op);
  // dC[i] = sum over j <= i of dS[i][j] B[j]
  warp_mm<true, false, kSplitA, NQN>(dca, dss, WL, bs, BL, 0, on.rb + 16,
                                     on);
  // dB[j] = sum over i >= j of dS[i][j] C[i]
  warp_mm<false, false, kSplitA, NQN>(dba, dss, WL, cs, BL, on.rb, kT, on);
  __syncthreads();   // W and dS are done with: their space takes h and dh

  // ---- the terms of the state, in tiles of 64 rows of h and dh ----------
  float dwp[2] = {0.f, 0.f}, yip[2] = {0.f, 0.f};
  float dotp = 0.f;
#pragma unroll 1
  for (int pt = 0; pt < NQP; ++pt) {
    if (pt > 0) st.fetch(dhsrc, hsrc, pt * 64, p.P, p.N, tid);
    st.store(t_a, t_b, NL, dotp, tid);
    __syncthreads();
    float tmp[4 * NQN][4];
    // (x dh)[j][n]: dB += w_j (x dh), dw_j = sum_n (x dh)[j][n] B[j][n]
    zero<NQN>(tmp);
    warp_mm<true, false, kSplitB, NQN>(tmp, xs + pt * 64, XL, t_a, NL, 0,
                                       64, on);
#pragma unroll
    for (int t = 0; t < 4 * NQN; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = on.row(e), n = on.col(t, e);
        dba[t][e] = fmaf(sc.w[j], tmp[t][e], dba[t][e]);
        dwp[e >> 1] = fmaf(tmp[t][e], bs[j * BL + n], dwp[e >> 1]);
      }
    // (dy h)[i][n]: dC += exp(cum_i) (dy h), and the cum term of y's
    // inter-chunk part, exp(cum_i) sum_n (dy h)[i][n] C[i][n]
    zero<NQN>(tmp);
    warp_mm<true, false, kSplitB, NQN>(tmp, ys + pt * 64, XL, t_b, NL, 0,
                                       64, on);
#pragma unroll
    for (int t = 0; t < 4 * NQN; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = on.row(e), n = on.col(t, e);
        const float v = sc.ecum[i] * tmp[t][e];
        dca[t][e] += v;
        yip[e >> 1] = fmaf(v, cs[i * BL + n], yip[e >> 1]);
      }
    __syncthreads();
  }
#pragma unroll 1
  for (int nt = 0; nt < NQN; ++nt) {
    // a tile of dh^T: rows n in [64 nt, 64 nt + 64), columns p
    {
      constexpr int kIter = 64 * PP / kThreads;
      float v[kIter];
#pragma unroll
      for (int it = 0; it < kIter; ++it) {
        const int idx = tid + it * kThreads;
        const int pp = idx / 64, n = nt * 64 + idx % 64;
        v[it] = pp < p.P && n < p.N
                    ? dhsrc[static_cast<long long>(pp) * p.N + n] : 0.f;
      }
#pragma unroll
      for (int it = 0; it < kIter; ++it) {
        const int idx = tid + it * kThreads;
        t_a[(idx % 64) * DTL + idx / 64] = v[it];
      }
    }
    __syncthreads();
    // (B dh^T)[j][p]: dx += w_j (B dh^T)
    float tmp[4 * NQP][4];
    zero<NQP>(tmp);
    warp_mm<true, false, kSplitB, NQP>(tmp, bs + nt * 64, BL, t_a, DTL, 0,
                                       64, op);
#pragma unroll
    for (int t = 0; t < 4 * NQP; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dxa[t][e] = fmaf(sc.w[op.row(e)], tmp[t][e], dxa[t][e]);
    __syncthreads();
  }
  // dw and yint over the quad, then the two column halves; the dot over
  // the block
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float dw = sum_quad(dwp[r]);
    const float yi = sum_quad(yip[r]);
    if (on.qc == 0) {
      const int row = on.rb + on.gr + 8 * r;
      dwpart[half * kT + row] = dw;
      yipart[half * kT + row] = yi;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    dotp += __shfl_xor_sync(0xffffffffu, dotp, o);
  if (lane == 0) dotpart[warp] = dotp;
  __syncthreads();

  // ---- the gradient of cum, its reverse cumsum, ddt and dA --------------
  // rows t < 64 in warps 0 and 1: the gradient of cum at t from the terms
  // of W, y and the state; its reverse cumsum (a suffix scan in each warp,
  // the second warp's total added to the first's), plus the terms of cum's
  // last value, which every t before it carries, gives the gradient of
  // dt A at t
  float dw = 0.f, v = 0.f, wdw = 0.f;
  if (tid < kT) {
    dw = dwpart[tid] + dwpart[kT + tid];
    const float yi = yipart[tid] + yipart[kT + tid];
    v = rowG[tid] - sc.dts[tid] * colH[tid] + yi - sc.w[tid] * dw;
    wdw = sc.w[tid] * dw;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, v, off);
      if (lane + off < 32) v += u;
      wdw += __shfl_xor_sync(0xffffffffu, wdw, off);
    }
    if (lane == 0) {
      dcum[warp] = v;          // the warp's total
      dcum[2 + warp] = wdw;
    }
  }
  __syncthreads();
  if (tid < kT) {
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) dot += dotpart[k];
    const float da = v + (warp == 0 ? dcum[1] : 0.f) + (dcum[2] + dcum[3])
                     + expf(sc.cum[kT - 1]) * dot;
    p.ddt[(static_cast<long long>(b) * p.H + h) * p.L + t0 + tid] =
        fmaf(da, A, colH[tid]) + dw * sc.wx[tid];
    float part = da * sc.dts[tid];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) dwpart[warp] = part;   // dwpart is read: reuse it
  }
  __syncthreads();
  if (tid == 0)
    p.dA_part[(static_cast<long long>(b) * p.H + h) * nc + c] =
        dwpart[0] + dwpart[1];

  // ---- dx, and this head's shares of dB and dC --------------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long t = t0 + op.row(2 * r);
    __nv_bfloat16* dxrow = p.dx + b * p.dx_sb + h * p.dx_sh + t * p.dx_sl;
#pragma unroll
    for (int q = 0; q < 4 * NQP; ++q) {
      const int pp = op.col(q, 0);
      if (pp < p.P)
        *reinterpret_cast<__nv_bfloat162*>(dxrow + pp) =
            __floats2bfloat162_rn(dxa[q][2 * r], dxa[q][2 * r + 1]);
    }
    const long long at =
        ((static_cast<long long>(b) * p.H + h) * p.L + t0 + on.row(2 * r)) *
        p.N;
#pragma unroll
    for (int q = 0; q < 4 * NQN; ++q) {
      const int n = on.col(q, 0);
      if (n < p.N) {
        *reinterpret_cast<float2*>(p.dB_part + at + n) =
            make_float2(dba[q][2 * r], dba[q][2 * r + 1]);
        *reinterpret_cast<float2*>(p.dC_part + at + n) =
            make_float2(dca[q][2 * r], dca[q][2 * r + 1]);
      }
    }
  }
}

// ===========================================================================
// 4. dB and dC over the heads of a group, dA over batch and steps
// ===========================================================================

__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const BwdParams p) {
  const int rep = p.H / p.G;
  const int nc = p.L / kT;
  if (blockIdx.x == gridDim.x - 1) {
    // the last column of blocks: dA, in the first block of it
    if (blockIdx.y != 0 || blockIdx.z != 0) return;
    for (int h = threadIdx.x; h < p.H; h += kThreads) {
      float v = 0.f;
      for (int b = 0; b < p.Bz; ++b)
        for (int c = 0; c < nc; ++c)
          v += p.dA_part[(static_cast<long long>(b) * p.H + h) * nc + c];
      p.dA[h] = v;
    }
    return;
  }
  const long long LN = static_cast<long long>(p.L) * p.N;
  const long long e =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (e >= LN) return;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
  for (int k = 0; k < rep; ++k) {
    const long long o =
        (static_cast<long long>(b) * p.H + g * rep + k) * LN + e;
    const float4 vb = *reinterpret_cast<const float4*>(p.dB_part + o);
    const float4 vc = *reinterpret_cast<const float4*>(p.dC_part + o);
    sb.x += vb.x; sb.y += vb.y; sb.z += vb.z; sb.w += vb.w;
    sc.x += vc.x; sc.y += vc.y; sc.z += vc.z; sc.w += vc.w;
  }
  const long long out = (static_cast<long long>(b) * p.G + g) * LN + e;
  store_bf16x4(p.dB + out, sb.x, sb.y, sb.z, sb.w);
  store_bf16x4(p.dC + out, sc.x, sc.y, sc.z, sc.w);
}

int padded(int v) { return v <= 64 ? 64 : 128; }

bool shape_ok(int Bz, int H, int G, int L, int P, int N) {
  return Bz > 0 && H > 0 && G > 0 && H % G == 0 && L > 0 && L % kT == 0 &&
         P > 0 && P <= 128 && P % 16 == 0 && N > 0 && N <= 128 &&
         N % 16 == 0 && H <= 65535 && Bz * ((P + 63) / 64) <= 65535 &&
         Bz <= 65535;
}

template <int NP>
cudaError_t launch_states(const BwdParams& p, cudaStream_t s) {
  using T = StatesTile<NP>;
  auto kern = ssd_bwd_states_kernel<NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.L / kT, p.H, p.Bz * ((p.P + 63) / 64));
  kern<<<grid, kThreads, T::kSmem, s>>>(p);
  return cudaGetLastError();
}

template <int PP, int NP>
cudaError_t launch_grad(const BwdParams& p, cudaStream_t s) {
  using T = GradTile<PP, NP>;
  auto kern = ssd_bwd_grad_kernel<PP, NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.L / kT, p.H, p.Bz);
  kern<<<grid, kThreads, T::kSmem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches the four kernels of the backward on `stream`, in order; allocates
// nothing and does not synchronise.  Returns the CUDA error code of the
// first launch that fails (0 = success).  x, B, C, dy and dx bf16, the last
// dimension contiguous and every row 8-byte aligned (strides in elements,
// multiples of 4); dt f32 strided; A f32 contiguous; ddt (Bz, H, L), dA (H,)
// f32 and dB, dC (Bz, G, L, N) bf16, contiguous.  The workspaces, all f32
// and contiguous: states and dstates (Bz, H, L / 64, P, N), decay and
// dA_part (Bz, H, L / 64), dB_part and dC_part (Bz, H, L, N).  P and N
// multiples of 16 up to 128, L a multiple of 64.
extern "C" int ssd_scan_backward(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* states, void* dstates, void* decay, void* dB_part,
    void* dC_part, void* dA_part, int Bz, int H, int G, int L, int P, int N,
    long long x_sb, long long x_sh, long long x_sl, long long dt_sb,
    long long dt_sh, long long dt_sl, long long b_sb, long long b_sg,
    long long b_sl, long long c_sb, long long c_sg, long long c_sl,
    long long dy_sb, long long dy_sh, long long dy_sl, long long dx_sb,
    long long dx_sh, long long dx_sl, void* stream) {
  if (!shape_ok(Bz, H, G, L, P, N))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const __nv_bfloat16*>(B);
  p.C = static_cast<const __nv_bfloat16*>(C);
  p.dy = static_cast<const __nv_bfloat16*>(dy);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dB = static_cast<__nv_bfloat16*>(dB);
  p.dC = static_cast<__nv_bfloat16*>(dC);
  p.states = static_cast<float*>(states);
  p.dstates = static_cast<float*>(dstates);
  p.decay = static_cast<float*>(decay);
  p.dB_part = static_cast<float*>(dB_part);
  p.dC_part = static_cast<float*>(dC_part);
  p.dA_part = static_cast<float*>(dA_part);
  p.Bz = Bz; p.H = H; p.G = G; p.L = L; p.P = P; p.N = N;
  p.x_sb = x_sb; p.x_sh = x_sh; p.x_sl = x_sl;
  p.dt_sb = dt_sb; p.dt_sh = dt_sh; p.dt_sl = dt_sl;
  p.b_sb = b_sb; p.b_sg = b_sg; p.b_sl = b_sl;
  p.c_sb = c_sb; p.c_sg = c_sg; p.c_sl = c_sl;
  p.dy_sb = dy_sb; p.dy_sh = dy_sh; p.dy_sl = dy_sl;
  p.dx_sb = dx_sb; p.dx_sh = dx_sh; p.dx_sl = dx_sl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pp = padded(P), np = padded(N);

  cudaError_t err = np == 64 ? launch_states<64>(p, s)
                             : launch_states<128>(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long elems = static_cast<long long>(Bz) * H * P * N;
  const dim3 scan_grid(
      static_cast<unsigned>((elems + kThreads - 1) / kThreads), 2);
  ssd_bwd_scan_kernel<<<scan_grid, kThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (pp == 64)
    err = np == 64 ? launch_grad<64, 64>(p, s) : launch_grad<64, 128>(p, s);
  else
    err = np == 64 ? launch_grad<128, 64>(p, s) : launch_grad<128, 128>(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long quads = static_cast<long long>(L) * N / 4;
  const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads) + 1,
                  G, Bz);
  ssd_bwd_reduce_kernel<<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
