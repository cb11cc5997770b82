// Tiled matrix product C = A B for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `_kernel` / `matmul` of the JAX package
// (src/repro/kernels/matmul.py).  Same function: A (M, K) @ B (K, N), f32 or
// bf16 inputs (both the same type), every product and sum in f32, C in the
// inputs' type.  A and B are row-major with any leading stride; C is written
// contiguous.
//
// What differs from the TPU kernel.  There the k axis is the innermost,
// "arbitrary" grid dimension and the (bm x bn) f32 sum waits in VMEM scratch
// from one grid step to the next.  Hopper has no ordered grid dimension: one
// thread block owns one tile of C and walks K itself, the A and B tiles of
// the coming k steps in flight into a ring of shared-memory stages while the
// current one is multiplied, its sums in registers for the whole walk.
//
// What bounds it on this card.  f32 inputs must give IEEE f32 products (the
// reference's f32 tolerance, atol 1e-3 / rtol 1e-5, rules out TF32), so the
// f32 bound is 2 M N K operations on the FP32 pipes at 67 TFLOP/s; bf16 runs
// on the tensor cores, 989 TFLOP/s.  The bytes (each input read once, C
// written once) come far below either at the shapes the calibration uses.
//
// Three kernels.  `pick_tile` below is the one place that chooses among them
// (and `matmul_tile` reports its choice); every request is served by one of
// them, and any M, N, K >= 1 is taken (ragged edges are masked inside; the
// reference asserts divisibility):
//   * paper16 (mm16_kernel): the paper's own tiled kernel, which the
//     measurement class `mm_tiled` and the held-out `skinny_mm` declare
//     (core/mkernels.py tiled_mm_props): a 16 x 16 group of 256 threads, one
//     output per thread, 16-deep k steps, A and B re-fetched once per step,
//     both operands of every multiply-add read from shared memory, one
//     barrier per step.  That schedule is kept; what it is fed by changed.
//     The tiles move by cp.async into a ring of 4 stages (steps k + 1, k + 2
//     in flight while k is multiplied), A m-major and B transposed (k
//     contiguous) so that a thread reads its A row and B column 16 bytes
//     (four k) at a time; B's transposed rows are padded to 20 values so the
//     eight 16-byte reads of a quarter warp fall in distinct banks.  The
//     sums over k stay in order, one fmaf after another.  Still two shared
//     reads per FMA: shared memory and L2 (2 KB of tiles per 8192
//     operations) bound it, well below the FP32 pipes.
//   * fma128 (mm128_kernel): f32 (and bf16 that TMA cannot read) on the
//     FP32 pipes, warp-tiled: a 128 x 128 tile, 256 threads each owning an
//     8 x 8 register tile in four 4 x 4 quadrants (rows ty*4 + {0..3} and
//     64 + ty*4 + {0..3}, the same for columns), a warp a 4 x 8 patch of the
//     thread grid so that each 16-byte shared read of a warp is 64 or 128
//     contiguous bytes (no bank conflict).  B moves as it is by 16-byte
//     cp.async; A is stored transposed (k-major, padded rows of 132): read
//     16 bytes a load into registers before a step's products and stored
//     after them, with k steps of 32 through a 3-stage ring, or, where A's
//     layout allows no 16-byte load, by 4-byte cp.async with k steps of 16
//     through 4 stages (the register path measured faster on the H100
//     where both apply).  C is written 16 bytes (f32) or 8 bytes (bf16) at
//     a time where the row allows.
//   * wgmma (mm_wgmma_kernel): bf16 on the tensor cores.  A 128 x 256
//     tile, k steps of 64; A and B come through a 4-stage TMA ring (2-D
//     tensor maps with the caller's leading strides, 128-byte swizzle, zeros
//     out of bounds; 48 KB a stage) signalled by mbarriers, fed by one
//     thread of a producer warpgroup; two consumer warpgroups of 64 rows
//     each run two wgmma.mma_async m64n128k16 bf16 -> f32 products per 16
//     k (one per 128-column half), A K-major, B (K, N) row-major read
//     MN-major through the transpose bit (64-column boxes stepped by the
//     descriptor's leading offset); setmaxnreg hands the producer's
//     registers to the consumers; the epilogue rounds to bf16.  One group
//     of products stays in flight while the next stage's products are
//     issued; a stage is released once its products are done.  Against a
//     128 x 128 tile (measured slower on the H100), the 256 columns move a
//     quarter fewer bytes from L2 per product and halve the blocks, each of
//     which fills the ring and writes its epilogue with nothing overlapping
//     them (one block per SM).
//
// The rule (pick_tile): a request whose block, clipped to M and N, lies
// nearer 16 than 128 on a log scale gets paper16 (bf16 too, staged as bf16
// and widened when read); any other request gets wgmma if the inputs are
// bf16 and TMA can read them (both base addresses 16-byte aligned, both
// leading strides multiples of 8 elements), else fma128.  The same function
// chooses, once per launch, how paper16 and fma128 read each input: 16
// bytes at a time where its base and leading stride allow, else one
// element at a time (a 4-byte cp.async for f32; a load and a store for
// bf16, which no asynchronous copy can place 2 bytes at a time).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;            // paper16, fma128

enum Variant : int { kPaper16 = 0, kFma128 = 1, kWgmma = 2 };

struct Params {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  long long lda, ldb, ldc;  // leading strides in elements
};

// ---------------------------------------------------------------------------
// copies and conversions
// ---------------------------------------------------------------------------

// 16 bytes into shared memory, of which the first `src_bytes` are read from
// `src` and the rest are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Returns once at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One element of a tile, zero where `ok` is false (`src` is then any valid
// address and is not read).
__device__ __forceinline__ void stage_elem(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void stage_elem(bf16* dst, const bf16* src,
                                           bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

// Four consecutive values of a shared tile as f32: one 16-byte read (f32),
// one 8-byte read widened (bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}

__device__ __forceinline__ void store1(float* c, float v) { *c = v; }
__device__ __forceinline__ void store1(bf16* c, float v) {
  *c = __float2bfloat16(v);
}
__device__ __forceinline__ void store4(float* c, float4 v) {
  *reinterpret_cast<float4*>(c) = v;
}
__device__ __forceinline__ void store4(bf16* c, float4 v) {
  *reinterpret_cast<uint2*>(c) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// Bytes of the copy of `per` elements starting `left` elements before the
// end of a row (`left` <= 0: past it), zero when the row itself is outside.
template <typename T>
__device__ __forceinline__ int copy_bytes(int per, int left, bool row_ok) {
  return row_ok ? max(0, min(per, left)) * static_cast<int>(sizeof(T)) : 0;
}

// ---------------------------------------------------------------------------
// paper16: the paper's 16 x 16 x 16 tile, one output per thread
// ---------------------------------------------------------------------------

constexpr int kStages16 = 4;
constexpr int kBtStride = 20;    // B's transposed rows: 16 k + 4 of padding

template <typename T>
struct Paper16 {
  static constexpr int kAStage = 16 * 16;           // A[m][k]
  static constexpr int kBStage = 16 * kBtStride;    // B^T[n][k]
  static constexpr size_t kSmem =
      sizeof(T) * kStages16 * (kAStage + kBStage);
};

// The A tile of a k step (rows m0.., columns k0..), m-major, zeros outside
// A.  VA: 16-byte copies, else one element per thread.
template <typename T, bool VA>
__device__ __forceinline__ void stage_a16(T* As, const Params& p, int m0,
                                          int k0, int tid) {
  const T* a = static_cast<const T*>(p.a);
  if constexpr (VA) {
    constexpr int kPer = 16 / sizeof(T);     // elements per copy
    constexpr int kRow = 16 / kPer;          // copies per row
    if (tid < 16 * kRow) {
      const int r = tid / kRow;
      const int k = (tid % kRow) * kPer;
      const int bytes = copy_bytes<T>(kPer, p.K - (k0 + k), m0 + r < p.M);
      cp_async16(As + r * 16 + k,
                 bytes ? a + static_cast<long long>(m0 + r) * p.lda + k0 + k
                       : a,
                 bytes);
    }
  } else {
    const int r = tid / 16, k = tid % 16;
    const bool ok = m0 + r < p.M && k0 + k < p.K;
    stage_elem(As + r * 16 + k,
               ok ? a + static_cast<long long>(m0 + r) * p.lda + k0 + k : a,
               ok);
  }
}

// The B tile of a k step (rows k0.., columns n0..), transposed: one element
// per thread, consecutive threads on consecutive columns of a B row.
template <typename T>
__device__ __forceinline__ void stage_bt16(T* Bt, const Params& p, int n0,
                                           int k0, int tid) {
  const T* b = static_cast<const T*>(p.b);
  const int k = tid / 16, n = tid % 16;
  const bool ok = k0 + k < p.K && n0 + n < p.N;
  stage_elem(Bt + n * kBtStride + k,
             ok ? b + static_cast<long long>(k0 + k) * p.ldb + n0 + n : b,
             ok);
}

template <typename T, bool VA>
__global__ void __launch_bounds__(kThreads) mm16_kernel(const Params p) {
  using S = Paper16<T>;
  __shared__ __align__(16) T As[kStages16 * S::kAStage];
  __shared__ __align__(16) T Bt[kStages16 * S::kBStage];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * 16;
  const int m0 = blockIdx.y * 16;
  const int n_k = (p.K + 15) / 16;

  // the tiles of k step kt into their stage; one group per step, empty past
  // the last, so that the count of groups in flight stays uniform
  auto stage = [&](int kt) {
    if (kt < n_k) {
      const int s = kt % kStages16;
      stage_a16<T, VA>(As + s * S::kAStage, p, m0, kt * 16, tid);
      stage_bt16<T>(Bt + s * S::kBStage, p, n0, kt * 16, tid);
    }
    cp_async_commit();
  };

  for (int kt = 0; kt < kStages16 - 1; ++kt) stage(kt);
  float acc = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages16 - 2>();  // this thread's copies of step kt are in
    // one barrier per k step: every thread's copies of step kt are in, and
    // nobody reads step kt - 1's stage any more, which is refilled now
    __syncthreads();
    stage(kt + kStages16 - 1);
    const int s = kt % kStages16;
    const T* a = As + s * S::kAStage + ty * 16;
    const T* b = Bt + s * S::kBStage + tx * kBtStride;
#pragma unroll
    for (int k = 0; k < 16; k += 4) {
      const float4 av = load4(a + k);
      const float4 bv = load4(b + k);
      acc = fmaf(av.x, bv.x, acc);
      acc = fmaf(av.y, bv.y, acc);
      acc = fmaf(av.z, bv.z, acc);
      acc = fmaf(av.w, bv.w, acc);
    }
  }
  const int r = m0 + ty;
  const int c = n0 + tx;
  if (r < p.M && c < p.N)
    store1(static_cast<T*>(p.c) + static_cast<long long>(r) * p.ldc + c, acc);
}

// ---------------------------------------------------------------------------
// fma128: 128 x 128 tile on the FP32 pipes, 8 x 8 outputs per thread
// ---------------------------------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
// k step and stages of fma128: A through registers (16-byte loads) takes k
// steps of 32 over 3 stages; A by 4-byte copies keeps 16 over 4, which
// fits its copies' addresses in 128 registers without a spill
constexpr int kBKReg = 32;
constexpr int kStagesReg = 3;
constexpr int kBKCopy = 16;
constexpr int kStagesCopy = 4;
constexpr int kAtStride = kBM + 4;   // A^T rows [k][m], padded

template <typename T, int BK, int STAGES>
struct Fma128 {
  static constexpr int kAStage = BK * kAtStride;
  static constexpr int kBStage = BK * kBN;
  static constexpr size_t kSmem = sizeof(T) * STAGES * (kAStage + kBStage);
};

// A of a k step (rows m0.., columns k0..) stored k-major, one element per
// copy (a transposing copy moves no more), zeros outside A; consecutive
// threads on consecutive k of a row.
template <typename T, int BK>
__device__ __forceinline__ void stage_at128(T* At, const Params& p, int m0,
                                            int k0, int tid) {
  const T* a = static_cast<const T*>(p.a);
  const int k = tid % BK;
#pragma unroll
  for (int i = 0; i < kBM * BK / kThreads; ++i) {
    const int r = tid / BK + i * (kThreads / BK);
    const bool ok = m0 + r < p.M && k0 + k < p.K;
    stage_elem(At + k * kAtStride + r,
               ok ? a + static_cast<long long>(m0 + r) * p.lda + k0 + k : a,
               ok);
  }
}

// The i-th value of 16 bytes read as T.
template <typename T>
__device__ __forceinline__ T as_elem(const uint4& v, int i);
template <>
__device__ __forceinline__ float as_elem<float>(const uint4& v, int i) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return __uint_as_float(w[i]);
}
template <>
__device__ __forceinline__ bf16 as_elem<bf16>(const uint4& v, int i) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(w[i / 2] >> (16 * (i % 2))));
}
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(bf16 x) {
  return __bfloat16_as_ushort(x);
}

// A of a k step through registers, 16 bytes a load: `load` brings the
// values of step k0 from device memory (zeros outside A), `store` writes
// them k-major into a stage.  Loaded before a step's products and stored
// after them, so the loads' latency hides behind the products.
template <typename T, int BK>
struct ARegs {
  static constexpr int kPer = 16 / sizeof(T);          // values per load
  static constexpr int kRow = BK / kPer;               // loads per row
  static constexpr int kLoads = kBM * kRow / kThreads;  // per thread
  uint4 v[kLoads];

  __device__ __forceinline__ void load(const Params& p, int m0, int k0,
                                       int tid) {
    const T* a = static_cast<const T*>(p.a);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / kRow;
      const int k = (e % kRow) * kPer;
      const int left = m0 + r < p.M ? p.K - (k0 + k) : 0;
      const T* src = a + static_cast<long long>(m0 + r) * p.lda + k0 + k;
      if (left >= kPer) {
        v[j] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          if (q < left)
            w[q * sizeof(T) / 4] |= bits(src[q])
                                    << (8 * ((q * sizeof(T)) % 4));
        v[j] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  __device__ __forceinline__ void store(T* At, int tid) const {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / kRow;
      const int k = (e % kRow) * kPer;
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        At[(k + q) * kAtStride + r] = as_elem<T>(v[j], q);
    }
  }
};

// B of a k step (rows k0.., columns n0..) as it is; VB: 16-byte copies,
// else one element at a time.
template <typename T, int BK, bool VB>
__device__ __forceinline__ void stage_b128(T* Bs, const Params& p, int n0,
                                           int k0, int tid) {
  const T* b = static_cast<const T*>(p.b);
  if constexpr (VB) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kRow = kBN / kPer;          // copies per row
#pragma unroll
    for (int i = 0; i < BK * kRow / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kRow;
      const int n = (e % kRow) * kPer;
      const int bytes = copy_bytes<T>(kPer, p.N - (n0 + n), k0 + k < p.K);
      cp_async16(Bs + k * kBN + n,
                 bytes ? b + static_cast<long long>(k0 + k) * p.ldb + n0 + n
                       : b,
                 bytes);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kBN;
      const int n = e % kBN;
      const bool ok = k0 + k < p.K && n0 + n < p.N;
      stage_elem(Bs + k * kBN + n,
                 ok ? b + static_cast<long long>(k0 + k) * p.ldb + n0 + n : b,
                 ok);
    }
  }
}

// Two blocks per SM (128 registers a thread) on the 16-byte path; the
// element path, for layouts no 16-byte copy can read, keeps its copies'
// addresses in registers that would spill at 128 and runs one block per SM.
// VA: A through registers 16 bytes at a time (ARegs), else by 4-byte
// asynchronous copies.
template <typename T, int BK, int STAGES, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads, VB ? 2 : 1)
mm128_kernel(const Params p) {
  using S = Fma128<T, BK, STAGES>;
  extern __shared__ __align__(16) unsigned char smem128[];
  T* At = reinterpret_cast<T*>(smem128);
  T* Bs = At + STAGES * S::kAStage;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the 16 x 16 thread grid, a warp a 4 x 8 patch of it
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int n_k = (p.K + BK - 1) / BK;

  ARegs<T, BK> areg;
  auto stage = [&](int kt, bool prologue) {
    if (kt < n_k) {
      const int s = kt % STAGES;
      if constexpr (VA) {
        areg.load(p, m0, kt * BK, tid);
        if (prologue) areg.store(At + s * S::kAStage, tid);
      } else {
        stage_at128<T, BK>(At + s * S::kAStage, p, m0, kt * BK, tid);
      }
      stage_b128<T, BK, VB>(Bs + s * S::kBStage, p, n0, kt * BK, tid);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < STAGES - 1; ++kt) stage(kt, true);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    stage(next, false);
    const int s = kt % STAGES;
    const T* a = At + s * S::kAStage + ty * 4;
    const T* b = Bs + s * S::kBStage + tx * 4;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = load4(a + k * kAtStride);
      const float4 a1 = load4(a + k * kAtStride + 64);
      const float4 b0 = load4(b + k * kBN);
      const float4 b1 = load4(b + k * kBN + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the stage refilled at this step was freed by this step's barrier and
    // is read STAGES - 1 barriers later
    if constexpr (VA) {
      if (next < n_k) areg.store(At + (next % STAGES) * S::kAStage, tid);
    }
  }

  T* C = static_cast<T*>(p.c);
  const bool vec = p.ldc % 4 == 0;  // rows of C 16 (f32) / 8 (bf16) aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * 64 + tx * 4;
      T* out = C + static_cast<long long>(r) * p.ldc + c;
      const float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                   acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (vec && c + 3 < p.N) {
        store4(out, v);
      } else {
        if (c < p.N) store1(out, v.x);
        if (c + 1 < p.N) store1(out + 1, v.y);
        if (c + 2 < p.N) store1(out + 2, v.z);
        if (c + 3 < p.N) store1(out + 3, v.w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;
constexpr int kWgBK = 64;                    // 64 bf16 = one 128-byte row
constexpr int kWgStages = 4;
constexpr int kWgThreads = 384;              // producer + 2 consumers
constexpr int kWgProducerRegs = 40;
constexpr int kWgConsumerRegs = 232;
constexpr int kWgABytes = kWgBM * kWgBK * 2;     // 128 rows of 128 bytes
constexpr int kWgBChunk = kWgBK * 64 * 2;        // one box: 64 k x 64 n
constexpr int kWgNH = 2;                         // 128-column halves launched

// The tile's columns: NH products of 128 columns per 16-deep k step.
template <int NH>
struct WgTile {
  static constexpr int kBN = 128 * NH;
  static constexpr int kBBytes = 2 * NH * kWgBChunk;
  static constexpr int kStageBytes = kWgABytes + kBBytes;
  static constexpr int kBarOffset = kWgStages * kStageBytes;
  // 1024 bytes of slack to align the stages to the swizzle atom
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * 2 * kWgStages;
  static_assert(kSmem <= kSmemLimit, "the wgmma tile must fit one block");
};

struct WgParams {
  bf16* c;
  int M, N;
  long long ldc;
  int n_k;
};

template <int NH>
__global__ void __launch_bounds__(kWgThreads, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b, const WgParams p) {
  using W = WgTile<NH>;
  extern __shared__ uint8_t smem_wg[];
  uint8_t* smem = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::kBarOffset);
  uint64_t* empty = full + kWgStages;

  const int n0 = blockIdx.x * W::kBN;
  const int m0 = blockIdx.y * kWgBM;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every copy -----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kWgProducerRegs));
    if (tid == 0) {
      for (int kt = 0; kt < p.n_k; ++kt) {
        const int s = kt % kWgStages;
        if (kt >= kWgStages)
          mbar_wait(empty + s, ((kt / kWgStages) & 1) ^ 1);
        uint8_t* st = smem + s * W::kStageBytes;
        mbar_expect_tx(full + s, W::kStageBytes);
        tma_load_2d(st, &tm_a, full + s, kt * kWgBK, m0);
#pragma unroll
        for (int c = 0; c < 2 * NH; ++c)   // 64-column boxes of B
          tma_load_2d(st + kWgABytes + c * kWgBChunk, &tm_b, full + s,
                      n0 + 64 * c, kt * kWgBK);
      }
    }
  } else {
    // ---- two consumer warpgroups of 64 rows each --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kWgConsumerRegs));
    const int ct = tid - 128;
    const int cw = ct >> 7;
    const int lane = ct & 31;
    float acc[NH][64];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

    for (int kt = 0; kt < p.n_k; ++kt) {
      const int s = kt % kWgStages;
      mbar_wait(full + s, (kt / kWgStages) & 1);
      const uint32_t a_s = smem_u32(smem + s * W::kStageBytes)
                           + cw * 64 * 128;            // this warpgroup's rows
      const uint32_t b_s = smem_u32(smem + s * W::kStageBytes + kWgABytes);
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_regs<64>(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // A: 16 k = 32 bytes along the swizzled row; B: 16 k rows of 128
        // bytes, each next 64 columns kWgBChunk further (LBO)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_ss_n128<1>(acc[h], smem_desc(a_s + kk * 32),
                           smem_desc(b_s + 2 * h * kWgBChunk + kk * 16 * 128,
                                     kWgBChunk),
                           1);
      }
      wgmma_commit();
      wgmma_wait<1>();               // the products of step kt - 1 are done
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_regs<64>(acc[h]);
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (kt - 1) % kWgStages);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs<64>(acc[h]);

    // ---- C = acc rounded to bf16 -------------------------------------------
    const int r0 = m0 + cw * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
    const int cq = n0 + 2 * (lane & 3);
    const bool pairs = p.ldc % 2 == 0;   // 4-byte aligned pairs
#pragma unroll
    for (int e = 0; e < 2; ++e) {        // rows r0 and r0 + 8
      const int r = r0 + 8 * e;
      if (r >= p.M) continue;
      bf16* row = p.c + static_cast<long long>(r) * p.ldc;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = cq + 128 * h + 8 * j;
          const float lo = acc[h][4 * j + 2 * e];
          const float hi = acc[h][4 * j + 2 * e + 1];
          if (pairs && col + 1 < p.N) {
            *reinterpret_cast<__nv_bfloat162*>(row + col) =
                __floats2bfloat162_rn(lo, hi);
          } else {
            if (col < p.N) row[col] = __float2bfloat16(lo);
            if (col + 1 < p.N) row[col + 1] = __float2bfloat16(hi);
          }
        }
    }
  }
}

// The 2-D map (inner, outer) of a row-major bf16 matrix with leading stride
// `ld` elements: boxes of `box_inner` x `box_outer`, 128-byte swizzle, zeros
// out of bounds.
cudaError_t encode_2d(CUtensorMap* map, const void* base, int inner,
                      int outer, long long ld, int box_inner, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                        static_cast<cuuint64_t>(outer)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                       static_cast<cuuint32_t>(box_outer)};
  cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the choice and the launches
// ---------------------------------------------------------------------------

struct Tile {
  int bm, bn, bk, stages, variant;
  bool va, vb;  // A, B read by 16-byte copies (else one element at a time)
};

// The one place that chooses the kernel, its tile and its copies (see the
// note at the top): the requested block, clipped to M and N as the
// reference clips it, goes to the built edge (16 or 128) nearest to
// sqrt(block_m * block_n) on a log scale (the smaller on a tie); the large
// edge is wgmma for bf16 that TMA can read, else fma128.  A matrix is
// read 16 bytes at a time where its base is 16-byte aligned and its rows
// are multiples of 16 bytes.
Tile pick_tile(int M, int N, int block_m, int block_n, int is_bf16,
               unsigned long long a_addr, unsigned long long b_addr,
               long long lda, long long ldb) {
  const long long elem = is_bf16 ? 2 : 4;
  const bool va = a_addr % 16 == 0 && lda * elem % 16 == 0;
  const bool vb = b_addr % 16 == 0 && ldb * elem % 16 == 0;
  const double bm = block_m < M ? block_m : M;
  const double bn = block_n < N ? block_n : N;
  const double want = bm * bn;  // compared with edge^2 on a log scale
  const double r16 = 16.0 * 16.0 / want;
  const double r128 = 128.0 * 128.0 / want;
  const double d16 = r16 >= 1.0 ? r16 : 1.0 / r16;
  const double d128 = r128 >= 1.0 ? r128 : 1.0 / r128;
  if (d16 <= d128) return {16, 16, 16, kStages16, kPaper16, va, false};
  // TMA's rule for bf16: 16-byte-aligned bases, leading strides that are
  // multiples of 8 elements
  if (is_bf16 && va && vb)
    return {kWgBM, WgTile<kWgNH>::kBN, kWgBK, kWgStages, kWgmma, true,
            true};
  if (va) return {kBM, kBN, kBKReg, kStagesReg, kFma128, true, vb};
  return {kBM, kBN, kBKCopy, kStagesCopy, kFma128, false, vb};
}

template <typename T, bool VA>
cudaError_t launch16(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + 15) / 16, (p.M + 15) / 16);
  mm16_kernel<T, VA><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BK, int STAGES, bool VA, bool VB>
cudaError_t launch128(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = Fma128<T, BK, STAGES>::kSmem;
  static_assert(bytes <= kSmemLimit, "the fma128 tile must fit one block");
  auto kern = mm128_kernel<T, BK, STAGES, VA, VB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int NH>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  using W = WgTile<NH>;
  CUtensorMap ta, tb;
  cudaError_t err = encode_2d(&ta, p.a, p.K, p.M, p.lda, kWgBK, kWgBM);
  if (err == cudaSuccess)
    err = encode_2d(&tb, p.b, p.N, p.K, p.ldb, 64, kWgBK);
  if (err != cudaSuccess) return err;
  WgParams w;
  w.c = static_cast<bf16*>(p.c);
  w.M = p.M; w.N = p.N; w.ldc = p.ldc;
  w.n_k = (p.K + kWgBK - 1) / kWgBK;
  auto kern = mm_wgmma_kernel<NH>;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(W::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + W::kBN - 1) / W::kBN, (p.M + kWgBM - 1) / kWgBM);
  kern<<<grid, kWgThreads, W::kSmem, stream>>>(ta, tb, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, const Tile& t, cudaStream_t stream) {
  if (t.variant == kPaper16) {
    return t.va ? launch16<T, true>(p, stream) : launch16<T, false>(p, stream);
  }
  if (t.va) {
    return t.vb ? launch128<T, kBKReg, kStagesReg, true, true>(p, stream)
                : launch128<T, kBKReg, kStagesReg, true, false>(p, stream);
  }
  return t.vb ? launch128<T, kBKCopy, kStagesCopy, false, true>(p, stream)
              : launch128<T, kBKCopy, kStagesCopy, false, false>(p, stream);
}

}  // namespace

// The kernel and tile this request launches: (BM, BN, BK), the stages of
// its ring, its variant (0 paper16, 1 fma128, 2 wgmma) and the bytes of
// shared memory of one block.  a_addr, b_addr: the base addresses of A and B
// (only their alignment matters); lda, ldb: leading strides in elements.
// Returns 0, or a CUDA error code for a shape it does not take.
extern "C" int matmul_tile(int M, int N, int K, int block_m, int block_n,
                           int block_k, int is_bf16, unsigned long long a_addr,
                           unsigned long long b_addr, long long lda,
                           long long ldb, int* bm, int* bn, int* bk,
                           int* stages, int* variant, long long* smem) {
  if (M <= 0 || N <= 0 || K <= 0 || block_m <= 0 || block_n <= 0 ||
      block_k <= 0 || lda < K || ldb < N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tile t = pick_tile(M, N, block_m, block_n, is_bf16, a_addr, b_addr,
                           lda, ldb);
  *bm = t.bm;
  *bn = t.bn;
  *bk = t.bk;
  *stages = t.stages;
  *variant = t.variant;
  size_t bytes;
  switch (t.variant) {
    case kPaper16:
      bytes = is_bf16 ? Paper16<bf16>::kSmem : Paper16<float>::kSmem;
      break;
    case kFma128:
      bytes = t.va ? (is_bf16 ? Fma128<bf16, kBKReg, kStagesReg>::kSmem
                              : Fma128<float, kBKReg, kStagesReg>::kSmem)
                   : (is_bf16 ? Fma128<bf16, kBKCopy, kStagesCopy>::kSmem
                              : Fma128<float, kBKCopy, kStagesCopy>::kSmem);
      break;
    default:
      bytes = WgTile<kWgNH>::kSmem;
  }
  *smem = static_cast<long long>(bytes);
  return 0;
}

// Launches on `stream`, allocates nothing, does not synchronise.  Returns the
// CUDA error code of the launch (0 = success).  A, B, C row-major with
// leading strides lda >= K, ldb >= N, ldc >= N (elements); f32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1) for all three.  The kernel and tile are the ones
// matmul_tile reports for the same arguments.
extern "C" int matmul_forward(const void* a, const void* b, void* c, int M,
                              int N, int K, long long lda, long long ldb,
                              long long ldc, int block_m, int block_n,
                              int block_k, int is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || lda < K || ldb < N || ldc < N ||
      block_m <= 0 || block_n <= 0 || block_k <= 0 ||
      (M + 15) / 16 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.a = a; p.b = b; p.c = c;
  p.M = M; p.N = N; p.K = K;
  p.lda = lda; p.ldb = ldb; p.ldc = ldc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tile t = pick_tile(M, N, block_m, block_n, is_bf16,
                           reinterpret_cast<uintptr_t>(a),
                           reinterpret_cast<uintptr_t>(b), lda, ldb);
  if (t.variant == kWgmma)
    return static_cast<int>(launch_wgmma<kWgNH>(p, s));
  return static_cast<int>(is_bf16 ? launch<bf16>(p, t, s)
                                  : launch<float>(p, t, s));
}
