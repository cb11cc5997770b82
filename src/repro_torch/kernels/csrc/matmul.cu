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
// thread block owns one (BM x BN) tile of C and walks K itself in BK steps,
// staging the A and B tiles in shared memory and keeping its sums in
// registers for the whole walk.  The block is a 16 x 16 grid of threads and
// each thread owns a TM x TN register tile of C, rows ty + 16 i and columns
// tx + 16 j, so that a warp reads 16 consecutive floats of a B row (no bank
// conflict) and two values of an A column (a broadcast).  The stage is double
// buffered: the tile of step k + 1 is loaded while step k is multiplied, so
// each k step takes exactly one barrier.
//
// Three tiles are built (`pick_tile` below is the one place that chooses;
// `matmul_tile` reports its choice):
//   * 16 x 16 x 16, one output per thread, 256 threads: the paper's own
//     tiled kernel, which the measurement class `mm_tiled` and the held-out
//     `skinny_mm` declare (16 x 16 groups, one barrier per k step);
//   * 128 x 128 x 32, an 8 x 8 register tile per thread, near the reference's
//     128^3 default.  A k step of 128 would need 128 KB of f32 tiles (256 KB
//     double buffered); at 32 the two stages take 64.3 KB of dynamic shared
//     memory, so more than one block fits an SM;
//   * 64 x 64 x 16, a 4 x 4 register tile, between the two.
// Any other request is served by the nearest built tile.  Ragged edges are
// masked: any M, N, K >= 1 is taken (the reference asserts divisibility).
//
// What bounds it on this card.  f32 inputs must give IEEE f32 products (the
// reference's f32 tolerance, atol 1e-3 / rtol 1e-5, rules out TF32), so the
// bound is 2 M N K operations on the FP32 pipes at 67 TFLOP/s; the bytes
// (each input read once, C written once) come far below that at the shapes
// the calibration uses.  The 16^3 tile cannot come near it: every FMA reads
// both operands from shared memory, which caps it at about 8 TFLOP/s over
// 132 SMs.  The 128 tile reads 16 shared values per 64 FMAs.  bf16 inputs are
// widened to f32 on their way into shared memory; mma.sync/wgmma tensor-core
// paths are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads

struct Params {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  long long lda, ldb, ldc;  // leading strides in elements
  int bf16;
};

__device__ __forceinline__ float load_elem(const void* base, long long off,
                                           bool bf16) {
  if (bf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[off]);
  }
  return static_cast<const float*>(base)[off];
}

// Bytes of shared memory one block of tile (BM, BN, BK) uses: two stages of
// A (stored k-major, [BK][BM + 1]) and B ([BK][BN]).
__host__ __device__ constexpr size_t smem_bytes(int BM, int BN, int BK) {
  return 2 * sizeof(float) *
         (static_cast<size_t>(BK) * (BM + 1) + static_cast<size_t>(BK) * BN);
}

// Stage the A tile (rows m0.., columns k0..) and the B tile (rows k0..,
// columns n0..) as f32; out-of-range elements are zero.
template <int BM, int BN, int BK>
__device__ __forceinline__ void load_stage(float* As, float* Bs,
                                           const Params& p, int m0, int n0,
                                           int k0, bool bf16, int tid) {
  // A: consecutive threads walk consecutive k of one row (coalesced reads),
  // stored transposed so that the product reads a column of A as a row.
#pragma unroll
  for (int e = tid; e < BM * BK; e += kThreads) {
    const int r = e / BK;
    const int k = e % BK;
    float v = 0.f;
    if (m0 + r < p.M && k0 + k < p.K) {
      v = load_elem(p.a, static_cast<long long>(m0 + r) * p.lda + k0 + k,
                    bf16);
    }
    As[k * (BM + 1) + r] = v;
  }
#pragma unroll
  for (int e = tid; e < BK * BN; e += kThreads) {
    const int k = e / BN;
    const int c = e % BN;
    float v = 0.f;
    if (k0 + k < p.K && n0 + c < p.N) {
      v = load_elem(p.b, static_cast<long long>(k0 + k) * p.ldb + n0 + c,
                    bf16);
    }
    Bs[k * BN + c] = v;
  }
}

template <int TM, int TN, int BK>
__global__ void __launch_bounds__(kThreads) mm_kernel(const Params p) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  constexpr int A_STAGE = BK * (BM + 1);
  constexpr int B_STAGE = BK * BN;

  extern __shared__ float smem[];
  float* As = smem;                 // [2][BK][BM + 1]
  float* Bs = smem + 2 * A_STAGE;   // [2][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const bool bf16 = p.bf16 != 0;
  const int n_k = (p.K + BK - 1) / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_stage<BM, BN, BK>(As, Bs, p, m0, n0, 0, bf16, tid);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) {
      // the other stage was last read in step kt - 1, which ended with a
      // barrier, so it may be overwritten now
      load_stage<BM, BN, BK>(As + (cur ^ 1) * A_STAGE,
                             Bs + (cur ^ 1) * B_STAGE, p, m0, n0,
                             (kt + 1) * BK, bf16, tid);
    }
    const float* a = As + cur * A_STAGE;
    const float* b = Bs + cur * B_STAGE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a[k * (BM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < n_k) __syncthreads();  // one barrier per k step
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= p.N) continue;
      const long long off = static_cast<long long>(r) * p.ldc + c;
      if (bf16) {
        static_cast<__nv_bfloat16*>(p.c)[off] = __float2bfloat16(acc[i][j]);
      } else {
        static_cast<float*>(p.c)[off] = acc[i][j];
      }
    }
  }
}

template <int TM, int TN, int BK>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  constexpr size_t bytes = smem_bytes(BM, BN, BK);
  auto kern = mm_kernel<TM, TN, BK>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

struct Tile {
  int bm, bn, bk;
};

// The built tile nearest to the request: each requested block is first
// clipped to its dimension (as the reference clips it), then the tile edge
// nearest to sqrt(block_m * block_n) on a log scale is taken (the smaller on
// a tie).  A request of 16 x 16 x 16 is served exactly.
Tile pick_tile(int M, int N, int block_m, int block_n) {
  const double bm = block_m < M ? block_m : M;
  const double bn = block_n < N ? block_n : N;
  const double want = bm * bn;  // compared with edge^2 on a log scale
  const int edges[3] = {16, 64, 128};
  int best = edges[0];
  for (int e : edges) {
    // |log(e^2 / want)| < |log(best^2 / want)|
    const double r_e = e * static_cast<double>(e) / want;
    const double r_b = best * static_cast<double>(best) / want;
    const double d_e = r_e >= 1.0 ? r_e : 1.0 / r_e;
    const double d_b = r_b >= 1.0 ? r_b : 1.0 / r_b;
    if (d_e < d_b) best = e;
  }
  if (best == 16) return {16, 16, 16};
  if (best == 64) return {64, 64, 16};
  return {128, 128, 32};
}

}  // namespace

// The tile the kernel launches for this request: (BM, BN, BK) and the bytes
// of shared memory of one block.  Returns 0, or a CUDA error code for a shape
// it does not take.
extern "C" int matmul_tile(int M, int N, int K, int block_m, int block_n,
                           int block_k, int* bm, int* bn, int* bk,
                           long long* smem) {
  if (M <= 0 || N <= 0 || K <= 0 || block_m <= 0 || block_n <= 0 ||
      block_k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tile t = pick_tile(M, N, block_m, block_n);
  *bm = t.bm;
  *bn = t.bn;
  *bk = t.bk;
  *smem = static_cast<long long>(smem_bytes(t.bm, t.bn, t.bk));
  return 0;
}

// Launches on `stream`, allocates nothing, does not synchronise.  Returns the
// CUDA error code of the launch (0 = success).  A, B, C row-major with
// leading strides lda >= K, ldb >= N, ldc >= N (elements); f32 (bf16 = 0) or
// bf16 (bf16 = 1) for all three.  The tile is the one matmul_tile reports.
extern "C" int matmul_forward(const void* a, const void* b, void* c, int M,
                              int N, int K, long long lda, long long ldb,
                              long long ldc, int block_m, int block_n,
                              int block_k, int bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || lda < K || ldb < N || ldc < N ||
      block_m <= 0 || block_n <= 0 || block_k <= 0 ||
      (M + 15) / 16 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.a = a; p.b = b; p.c = c;
  p.M = M; p.N = N; p.K = K;
  p.lda = lda; p.ldb = ldb; p.ldc = ldc;
  p.bf16 = bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_tile(M, N, block_m, block_n).bm) {
    case 16: return static_cast<int>(launch<1, 1, 16>(p, s));
    case 64: return static_cast<int>(launch<4, 4, 16>(p, s));
    default: return static_cast<int>(launch<8, 8, 32>(p, s));
  }
}
