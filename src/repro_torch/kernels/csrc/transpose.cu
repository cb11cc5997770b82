// Tiled transpose Y = X^T for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel `_kernel` / `transpose` of the JAX package
// (src/repro/kernels/transpose.py): X (M, N) row-major with any leading
// stride -> Y (N, M) contiguous, element for element (a copy of bits, so the
// result is exact).  4-byte (f32) and 2-byte (bf16) elements.
//
// The point of the tile is the paper's: a transpose read or written straight
// from device memory touches one element per row, so one of its two
// directions is uncoalesced.  Here one thread block owns a T x T tile: its
// threads read the tile's rows from X, write them into shared memory, meet at
// one barrier, and write the tile's columns as rows of Y, so both directions
// of device memory are stride 1.  That is what the measurement class
// `transpose` declares (`tiled_transpose_props`): one group and one barrier
// per 16 x 16 tile, each element once through local memory.
//
// What bounds it on this card: bytes.  It moves 2 M N elements and computes
// nothing, so its bound is 2 M N x element size over 3.35 TB/s.  At the 16
// tile the first design (`scalar`, below) ran 256 threads of one 4-byte
// element each: 8 resident blocks an SM, 8 KB of loads in flight, well short
// of what keeps HBM busy.  The variants, chosen before the launch by the
// caller (`pick_variant` in transpose.py) and validated here:
//
//   0 `scalar`  transpose_kernel<T, TILE, TX, TY>: one element a thread, a
//               tile padded by one element per row.  Tiles 16 (256 threads),
//               32 and 64 (`pick_tile`: the largest built tile not above the
//               request).  Any layout, any M, N >= 1.
//   1 `vec16`   transpose_vec_kernel: the 16 tile with one 16-byte access a
//               thread each way (VecMap below: 64 threads for f32, 32 for
//               bf16), so 32 blocks an SM keep 32 KB of loads in flight.
//               Needs 16-byte-aligned bases, and a leading stride, M and N
//               that are multiples of one access (4 f32 or 8 bf16 elements):
//               a ragged edge then masks whole accesses.  The grid's x walks
//               X's columns, as scalar's does.
//
// The TPU kernel's default block of 256 is a VMEM tile: 256 x 257 x 4 bytes
// would be 263 KB of shared memory, over the 232,448 bytes a block may use;
// it gets the 64 tile.  The grid's y dimension counts tiles of X's rows and
// is capped at 65535.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;   // the tile of vec16, the paper's group size

template <typename T, int TILE, int TX, int TY>
__global__ void __launch_bounds__(TX * TY)
    transpose_kernel(const T* __restrict__ x, T* __restrict__ y, int M, int N,
                     long long ldx, long long ldy) {
  __shared__ T tile[TILE][TILE + 1];
  const int c0 = blockIdx.x * TILE;  // column of X = row of Y
  const int r0 = blockIdx.y * TILE;  // row of X = column of Y
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
#pragma unroll
  for (int r = ty; r < TILE; r += TY) {
#pragma unroll
    for (int c = tx; c < TILE; c += TX) {
      if (r0 + r < M && c0 + c < N) {
        tile[r][c] = x[static_cast<long long>(r0 + r) * ldx + c0 + c];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < TILE; r += TY) {
#pragma unroll
    for (int c = tx; c < TILE; c += TX) {
      if (c0 + r < N && r0 + c < M) {
        y[static_cast<long long>(c0 + r) * ldy + r0 + c] = tile[c][r];
      }
    }
  }
}

template <int BYTES> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };

// The map of threads to elements of vec16, in one place.  A 16 x 16 tile is
// 16 rows of C = 16 / V accesses of V elements (VB bytes); one thread moves
// one access each way:
//   load:  thread t reads access (t / C, t % C) of X's tile: row t / C,
//          columns V (t % C) ... V (t % C) + V - 1, one ld.global of VB bytes,
//          and stores it whole into shared memory at slot(t / C, t % C);
//   store: thread t gathers row j = t / C of Y's tile (column j of X's),
//          elements V (t % C) + k, k < V, from shared memory, one element
//          each (X's row V (t % C) + k, column j), and writes them as one
//          st.global of VB bytes.
// Shared memory holds the tile as 16 C access slots; a 128-byte line (the
// 32 banks) holds NC = 128 / VB of them.  slot() XORs an access's place in
// its line with 2 (a / V), the number of the V-row group of its row:
//   - the load's stores: a phase of the warp (128 / VB threads) writes one
//     whole line, which the XOR only permutes, so 0 conflicts;
//   - the store's gathers (4- or 2-byte loads, the whole warp at once): at a
//     fixed k the threads of one access column t % C read rows of distinct
//     V-row groups, which the XOR spreads over distinct slots of the line,
//     so every 4-byte word lands in its own bank: 0 conflicts.
// Unswizzled, the gathers of f32 would meet 4 to a bank.  The CPU tests
// emulate this map (tests/test_torch_kernels.py) and count both.
template <typename T, int V>
struct VecMap {
  static constexpr int C = kTile / V;                  // accesses a row
  static constexpr int THREADS = kTile * C;
  static constexpr int VB = V * static_cast<int>(sizeof(T));
  static constexpr int NC = 128 / VB;                  // slots a line
  using Vec = typename VecOf<VB>::type;
  static_assert(2 * (C - 1) < NC, "the XOR must stay inside a line");

  __device__ __forceinline__ static int slot(int a, int c) {
    const int f = a * C + c;
    return (f & ~(NC - 1)) | ((f & (NC - 1)) ^ (2 * (a / V)));
  }
};

// Elements of one vec16 access (16 bytes), by type: f32 4, bf16 8.
template <typename T> struct VecWidth;
template <> struct VecWidth<unsigned int> { static constexpr int V = 4; };
template <> struct VecWidth<unsigned short> { static constexpr int V = 8; };

template <typename T, int V>
__global__ void __launch_bounds__(VecMap<T, V>::THREADS)
    transpose_vec_kernel(const T* __restrict__ x, T* __restrict__ y, int M,
                         int N, long long ldx, long long ldy) {
  using Map = VecMap<T, V>;
  using Vec = typename Map::Vec;
  __shared__ __align__(16) T tile[kTile * kTile];
  const int c0 = blockIdx.x * kTile;      // column of X = row of Y
  const int r0 = blockIdx.y * kTile;      // row of X = column of Y
  const int row = threadIdx.x / Map::C;   // X's tile row, then Y's
  const int acc = threadIdx.x % Map::C;   // the access within that row
  if (r0 + row < M && c0 + acc * V < N) {
    reinterpret_cast<Vec*>(tile)[Map::slot(row, acc)] =
        *reinterpret_cast<const Vec*>(
            x + static_cast<long long>(r0 + row) * ldx + c0 + acc * V);
  }
  __syncthreads();
  if (c0 + row < N && r0 + acc * V < M) {
    Vec out;
    T* e = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int a = acc * V + k;  // X's tile row of element k
      e[k] = tile[Map::slot(a, row / V) * V + row % V];
    }
    *reinterpret_cast<Vec*>(
        y + static_cast<long long>(c0 + row) * ldy + r0 + acc * V) = out;
  }
}

__global__ void empty_kernel() {}

// The largest built tile edge not above the request (16 at least).
int pick_tile(int block) {
  return block >= 64 ? 64 : (block >= 32 ? 32 : 16);
}

// The launch shape of `variant` for (M, N): grid, block, and the kernel's
// shared bytes.  Returns false for a variant, type or request it does not
// take (the layout is checked by vec_layout_ok).
template <typename T>
bool launch_shape(int variant, int block, int M, int N, dim3* grid,
                  dim3* threads, long long* smem) {
  const int tile = pick_tile(block);
  if (variant == 0) {
    *grid = dim3((N + tile - 1) / tile, (M + tile - 1) / tile);
    *threads = tile == 16 ? dim3(16, 16) : dim3(32, 8);
    *smem = static_cast<long long>(tile) * (tile + 1) * sizeof(T);
    return (M + tile - 1) / tile <= 65535;
  }
  if (variant != 1 || tile != kTile) return false;
  *grid = dim3((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  *threads = dim3(VecMap<T, VecWidth<T>::V>::THREADS);
  *smem = static_cast<long long>(kTile) * kTile * sizeof(T);
  return grid->y <= 65535;
}

// vec16's accesses: the bases 16-byte aligned, the leading strides, M and N
// multiples of one access.
template <typename T>
bool vec_layout_ok(const void* x, const void* y, int M, int N, long long ldx,
                   long long ldy) {
  constexpr int v = VecWidth<T>::V;
  const uintptr_t vb = static_cast<uintptr_t>(v) * sizeof(T);
  return reinterpret_cast<uintptr_t>(x) % vb == 0 &&
         reinterpret_cast<uintptr_t>(y) % vb == 0 && ldx % v == 0 &&
         ldy % v == 0 && M % v == 0 && N % v == 0;
}

template <typename T>
cudaError_t launch(int variant, int block, const void* x, void* y, int M,
                   int N, long long ldx, long long ldy, cudaStream_t s) {
  dim3 grid, threads;
  long long smem;
  if (!launch_shape<T>(variant, block, M, N, &grid, &threads, &smem) ||
      (variant != 0 && !vec_layout_ok<T>(x, y, M, N, ldx, ldy))) {
    return cudaErrorInvalidValue;
  }
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (variant == 1) {
    transpose_vec_kernel<T, VecWidth<T>::V><<<grid, threads, 0, s>>>(
        xt, yt, M, N, ldx, ldy);
  } else if (pick_tile(block) == 16) {
    transpose_kernel<T, 16, 16, 16><<<grid, threads, 0, s>>>(xt, yt, M, N,
                                                             ldx, ldy);
  } else if (pick_tile(block) == 32) {
    transpose_kernel<T, 32, 32, 8><<<grid, threads, 0, s>>>(xt, yt, M, N,
                                                            ldx, ldy);
  } else {
    transpose_kernel<T, 64, 32, 8><<<grid, threads, 0, s>>>(xt, yt, M, N,
                                                            ldx, ldy);
  }
  return cudaGetLastError();
}

template <typename T>
int tile_of(int variant, int block, int* tile, int* nthreads,
            long long* smem) {
  dim3 grid, threads;
  if (!launch_shape<T>(variant, block, kTile, kTile, &grid, &threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *tile = pick_tile(block);
  *nthreads = static_cast<int>(threads.x * threads.y);
  return 0;
}

}  // namespace

// The tile edge `variant` launches for a requested block, its threads a
// block and its bytes of shared memory a block.  Returns 0, or a CUDA error
// code for a variant, element size or block it does not take.
extern "C" int transpose_tile(int block, int elem_bytes, int variant,
                              int* tile, int* threads, long long* smem) {
  if (block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes == 4) {
    return tile_of<unsigned int>(variant, block, tile, threads, smem);
  }
  if (elem_bytes == 2) {
    return tile_of<unsigned short>(variant, block, tile, threads, smem);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches `variant` (chosen by the caller) on `stream`, allocates nothing,
// does not synchronise.  Returns the CUDA error code of the launch (0 =
// success); cudaErrorInvalidValue for a variant the layout does not allow,
// never another variant in its place.  X (M, N) with leading stride ldx >= N,
// Y (N, M) with leading stride ldy >= M, both in elements of `elem_bytes`
// bytes (4 or 2).
extern "C" int transpose_forward(const void* x, void* y, int M, int N,
                                 long long ldx, long long ldy, int block,
                                 int elem_bytes, int variant, void* stream) {
  if (M <= 0 || N <= 0 || ldx < N || ldy < M || block <= 0 ||
      (M + 15) / 16 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    return static_cast<int>(
        launch<unsigned int>(variant, block, x, y, M, N, ldx, ldy, s));
  }
  if (elem_bytes == 2) {
    return static_cast<int>(
        launch<unsigned short>(variant, block, x, y, M, N, ldx, ldy, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// An empty kernel over the grid and block shape `variant` launches for
// (M, N): the floor that dispatching one block per tile sets, measured
// beside the kernel.  Returns the CUDA error code of the launch.
extern "C" int transpose_empty(int M, int N, int block, int elem_bytes,
                               int variant, void* stream) {
  dim3 grid, threads;
  long long smem;
  const bool ok =
      M > 0 && N > 0 &&
      (elem_bytes == 4
           ? launch_shape<unsigned int>(variant, block, M, N, &grid, &threads,
                                        &smem)
           : elem_bytes == 2 && launch_shape<unsigned short>(
                                    variant, block, M, N, &grid, &threads,
                                    &smem));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
