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
// threads read the tile's rows from X (consecutive threads on consecutive
// columns), write them into shared memory, meet at one barrier, and write the
// tile's columns as rows of Y (consecutive threads on consecutive columns of
// Y again), so both directions of device memory are stride 1.  The shared
// tile is padded by one element per row, so that the column walk of the second
// half hits 32 different banks instead of one.
//
// The TPU kernel's default block of 256 is a VMEM tile: 256 x 257 x 4 bytes
// would be 263 KB of shared memory, over the 232,448 bytes a block may use.
// The tiles built here are 16, 32 and 64 (`pick_tile` below is the one place
// that chooses; `transpose_tile` reports its choice): a request of 16 is
// served exactly, with 256 threads, one element each and one barrier per
// 16 x 16 tile, as the measurement class `transpose` declares; a larger
// request gets the largest built tile not above it, so 256 gets 64.  Ragged
// edges are masked: any M, N >= 1 is taken.
//
// What bounds it on this card: bytes.  It moves 2 M N elements and computes
// nothing, so its bound is 2 M N x element size over 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

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

template <typename T, int TILE, int TX, int TY>
cudaError_t launch(const void* x, void* y, int M, int N, long long ldx,
                   long long ldy, cudaStream_t stream) {
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  const dim3 block(TX, TY);
  transpose_kernel<T, TILE, TX, TY><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), M, N, ldx, ldy);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int tile, const void* x, void* y, int M, int N,
                        long long ldx, long long ldy, cudaStream_t stream) {
  switch (tile) {
    case 16: return launch<T, 16, 16, 16>(x, y, M, N, ldx, ldy, stream);
    case 32: return launch<T, 32, 32, 8>(x, y, M, N, ldx, ldy, stream);
    default: return launch<T, 64, 32, 8>(x, y, M, N, ldx, ldy, stream);
  }
}

// The largest built tile edge not above the request (16 at least).
int pick_tile(int block) {
  return block >= 64 ? 64 : (block >= 32 ? 32 : 16);
}

}  // namespace

// The tile edge the kernel launches for a requested block, and the bytes of
// shared memory of one block.  Returns 0, or a CUDA error code for an element
// size or block it does not take.
extern "C" int transpose_tile(int block, int elem_bytes, int* tile,
                              long long* smem) {
  if (block <= 0 || (elem_bytes != 4 && elem_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *tile = pick_tile(block);
  *smem = static_cast<long long>(*tile) * (*tile + 1) * elem_bytes;
  return 0;
}

// Launches on `stream`, allocates nothing, does not synchronise.  Returns the
// CUDA error code of the launch (0 = success).  X (M, N) with leading stride
// ldx >= N, Y (N, M) with leading stride ldy >= M, both in elements of
// `elem_bytes` bytes (4 or 2).  The tile is the one transpose_tile reports.
extern "C" int transpose_forward(const void* x, void* y, int M, int N,
                                 long long ldx, long long ldy, int block,
                                 int elem_bytes, void* stream) {
  if (M <= 0 || N <= 0 || ldx < N || ldy < M || block <= 0 ||
      (M + 15) / 16 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = pick_tile(block);
  if (elem_bytes == 4) {
    return static_cast<int>(
        launch_tile<unsigned int>(tile, x, y, M, N, ldx, ldy, s));
  }
  if (elem_bytes == 2) {
    return static_cast<int>(
        launch_tile<unsigned short>(tile, x, y, M, N, ldx, ldy, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
