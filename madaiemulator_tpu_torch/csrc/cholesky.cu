// Kernel K2: batched lower Cholesky factorization for Hopper.
//
// Replaces the TPU kernel madaiemulator_tpu/ops/pallas/cholesky.py
// (pallas_cholesky; body _chol_kernel, helpers _unblocked_chol_block and
// _tri_inv_block): the lower factor L of each SPD matrix A[b] in a batch,
// with zeros above the diagonal.
//
// What bounds it on this card: at the serve path's sizes (n <= 1024, a batch
// of r ~ 4 components) it is latency-bound, not flop- or byte-bound. The
// factorization is a chain of n / 32 dependent panel steps, each of which
// offers little parallelism, so the card is mostly idle. A 1024^2 f32 matrix
// is 4 MiB, far over the 227 KB of shared memory a block may use, so the TPU
// kernel's "whole matrix on chip" design does not carry over.
//
// Design: right-looking blocked factorization over 32-wide panels, working
// in global memory (the batch's matrices sit in the 50 MB L2 at these
// sizes). Per panel, three launches on one stream, the batch in a grid axis:
//   1. chol_diag_kernel: one CTA per matrix loads the 32x32 diagonal block
//      into shared memory, factors it column by column (rank-1 updates) and
//      writes it back;
//   2. chol_trsm_kernel: the panel below, L21 = A21 L11^-T, one row per
//      thread by forward substitution against L11 held in shared memory;
//   3. chol_syrk_kernel: the trailing update A22 -= L21 L21^T on the lower
//      triangle only, one CTA per 32x32 tile, fp32 FMA (no tensor cores).
// A pivot that is not positive (or is NaN) becomes NaN, and NaN then fills
// the rest of the factor, so a non-SPD input gives NaN entries, never finite
// garbage and never a hang: the callers' finiteness check (chol_ok) and the
// jitter ladder work as in the JAX package. n needs no padding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNB = 32;          // panel width
constexpr int kTrsmRows = 128;   // rows per TRSM block (one per thread)
constexpr int kDiagThreads = 128;
constexpr int kST = 32;          // SYRK tile
constexpr int kSY = 8;           // SYRK thread rows

__global__ void copy_lower_kernel(const float* __restrict__ A,
                                  float* __restrict__ L, size_t total,
                                  int n) {
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) +
                    threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t within = idx % (static_cast<size_t>(n) * n);
    const int i = static_cast<int>(within / n);
    const int j = static_cast<int>(within % n);
    L[idx] = (j <= i) ? A[idx] : 0.0f;
  }
}

__global__ void __launch_bounds__(kDiagThreads)
chol_diag_kernel(float* __restrict__ L, int n, int k0) {
  __shared__ float D[kNB][kNB + 1];
  float* A = L + static_cast<size_t>(blockIdx.x) * n * n;
  const int jb = min(kNB, n - k0);
  for (int idx = threadIdx.x; idx < jb * jb; idx += blockDim.x) {
    const int i = idx / jb;
    const int j = idx % jb;
    D[i][j] = A[static_cast<size_t>(k0 + i) * n + k0 + j];
  }
  __syncthreads();
  for (int j = 0; j < jb; ++j) {
    if (threadIdx.x == 0) {
      const float p = D[j][j];
      D[j][j] = (p > 0.0f) ? sqrtf(p) : nanf("");
    }
    __syncthreads();
    const float piv = D[j][j];
    for (int i = j + 1 + threadIdx.x; i < jb; i += blockDim.x) {
      D[i][j] = D[i][j] / piv;
    }
    __syncthreads();
    const int w = jb - j - 1;
    for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
      const int i = j + 1 + idx / w;
      const int l = j + 1 + idx % w;
      if (l <= i) D[i][l] -= D[i][j] * D[l][j];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < jb * jb; idx += blockDim.x) {
    const int i = idx / jb;
    const int j = idx % jb;
    if (j <= i) A[static_cast<size_t>(k0 + i) * n + k0 + j] = D[i][j];
  }
}

__global__ void __launch_bounds__(kTrsmRows)
chol_trsm_kernel(float* __restrict__ L, int n, int k0) {
  __shared__ float D[kNB][kNB + 1];
  float* A = L + static_cast<size_t>(blockIdx.y) * n * n;
  const int jb = min(kNB, n - k0);
  for (int idx = threadIdx.x; idx < jb * jb; idx += blockDim.x) {
    const int i = idx / jb;
    const int j = idx % jb;
    D[i][j] = A[static_cast<size_t>(k0 + i) * n + k0 + j];
  }
  __syncthreads();
  const int row = k0 + jb + blockIdx.x * kTrsmRows + threadIdx.x;
  if (row >= n) return;
  float* arow = A + static_cast<size_t>(row) * n + k0;
  float x[kNB];
#pragma unroll
  for (int j = 0; j < kNB; ++j) x[j] = (j < jb) ? arow[j] : 0.0f;
  // forward substitution: x L11^T = a
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    if (j < jb) {
      float s = x[j];
#pragma unroll
      for (int l = 0; l < j; ++l) s -= x[l] * D[j][l];
      x[j] = s / D[j][j];
    }
  }
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    if (j < jb) arow[j] = x[j];
  }
}

__global__ void __launch_bounds__(kST * kSY)
chol_syrk_kernel(float* __restrict__ L, int n, int k0, int jb) {
  const int bi = blockIdx.y;  // tile row
  const int bj = blockIdx.x;  // tile column
  if (bj > bi) return;        // lower triangle only
  __shared__ float Rrow[kST][kNB + 1];
  __shared__ float Rcol[kST][kNB + 1];
  float* A = L + static_cast<size_t>(blockIdx.z) * n * n;
  const int t0 = k0 + jb;
  const int row0 = t0 + bi * kST;
  const int col0 = t0 + bj * kST;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  for (int idx = ty * kST + tx; idx < kST * jb; idx += kST * kSY) {
    const int r = idx / jb;
    const int c = idx % jb;
    Rrow[r][c] = (row0 + r < n)
                     ? A[static_cast<size_t>(row0 + r) * n + k0 + c] : 0.0f;
    Rcol[r][c] = (col0 + r < n)
                     ? A[static_cast<size_t>(col0 + r) * n + k0 + c] : 0.0f;
  }
  __syncthreads();
  const int col = col0 + tx;
#pragma unroll
  for (int i = 0; i < kST / kSY; ++i) {
    const int rl = ty + i * kSY;
    const int row = row0 + rl;
    if (row >= n || col >= n || col > row) continue;
    float acc = 0.0f;
    for (int c = 0; c < jb; ++c) acc += Rrow[rl][c] * Rcol[tx][c];
    A[static_cast<size_t>(row) * n + col] -= acc;
  }
}

}  // namespace

// A and L: (B, n, n) contiguous float32 device arrays, A symmetric positive
// definite (only its lower triangle is read). Writes the lower factor into L
// (zeros above the diagonal). Launches on `stream`, does not synchronise,
// and returns the first cudaGetLastError() that is not cudaSuccess.
extern "C" int madai_cholesky(const float* A, float* L, int B, int n,
                              void* stream) {
  if (B <= 0 || n <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(B) * n * n;
  const size_t want_blocks = (total + 255) / 256;
  const int copy_blocks =
      static_cast<int>(want_blocks < 4096 ? want_blocks : 4096);
  copy_lower_kernel<<<copy_blocks, 256, 0, s>>>(A, L, total, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k0 = 0; k0 < n; k0 += kNB) {
    const int jb = (n - k0 < kNB) ? n - k0 : kNB;
    const int m = n - k0 - jb;  // rows below the panel
    chol_diag_kernel<<<B, kDiagThreads, 0, s>>>(L, n, k0);
    if (m > 0) {
      const dim3 tgrid((m + kTrsmRows - 1) / kTrsmRows, B);
      chol_trsm_kernel<<<tgrid, kTrsmRows, 0, s>>>(L, n, k0);
      const int tiles = (m + kST - 1) / kST;
      const dim3 sgrid(tiles, tiles, B);
      chol_syrk_kernel<<<sgrid, dim3(kST, kSY), 0, s>>>(L, n, k0, jb);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
