// Kernel K3: fused panel factorization (L, L^-1) for Hopper.
//
// Replaces the TPU kernel madaiemulator_tpu/ops/pallas/cholesky.py
// (pallas_panel_factor; body _panel_factor_kernel): for each SPD diagonal
// panel A[b] of a batch, the lower Cholesky factor L and its inverse L^-1,
// both with zeros above the diagonal, in one call. The left-looking large-N
// factorization (ops/linalg.left_cholesky, diag="pallas") takes both from it:
// L for the diagonal block and L^-1 as the operand of the panel TRSM, which
// then becomes one GEMM.
//
// What bounds it on this card: for a (b, b) panel the factor costs b^3 / 3
// flops and the inverse another b^3 / 3, all in full FP32 FFMA (no tensor
// cores, no TF32: the TPU kernel pins Precision.HIGHEST on every dot), so
// 2 b^3 / 3 flops against 67 TFLOP/s: 1.3 us at b = 512 and 10.7 us at
// b = 1024 per panel. The bytes (the lower triangle of A in, L and L^-1 out:
// 3 MiB at b = 512) bound it a little less. At a batch of 1-2 panels the
// real limit is the dependency chain, as in kernel K2: the card is mostly
// idle.
//
// Design: three (b, b) f32 buffers are 3 MiB at b = 512 and 12 MiB at
// b = 1024, far over the 227 KB of shared memory a block may use, so the
// TPU kernel's "everything in VMEM" design does not carry over. The kernel
// works in global memory, which stays L2-resident (50 MB) at these sizes;
// only 32x32 tiles are staged in shared memory. The batch is a grid axis.
//   Stage 1, the factor: kernel K2's device code (csrc/cholesky.cu,
//     madai_cholesky): right-looking over 32-wide panels. Only the lower
//     triangle of A is read; a pivot that is not > 0 becomes NaN and NaN
//     fills the rest of the factor.
//   Stage 2, the inverse, in 32x32 tiles (b / 32 = nb tiles a side):
//     * inv_diag_kernel: one CTA per diagonal tile loads L[i,i] into shared
//       memory and inverts it by forward substitution, one thread per
//       column of the inverse with the column in registers; the same CTA
//       writes zeros over the tiles right of the diagonal in its tile row;
//     * inv_offdiag_kernel, once per tile diagonal s = 1 .. nb - 1: one CTA
//       per tile (i, j), i = j + s, computes
//           inv[i,j] = -inv[i,i] * sum_{k=j}^{i-1} L[i,k] inv[k,j]
//       (the recurrence of cholesky.py:159-175) with its own tiled FP32
//       products: every inv[k,j] it reads lies on an earlier tile
//       diagonal, so the tiles of one diagonal are independent.
//   NaN in L becomes NaN in L^-1 (0 * NaN is NaN), so a failed member has
//   NaN in both outputs and the other members are untouched.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

// Kernel K2's entry point (csrc/cholesky.cu), linked into the same library.
extern "C" int madai_cholesky(const float* A, float* L, int B, int n,
                              void* stream);

namespace {

constexpr int kT = 32;   // tile side of the inverse
constexpr int kTY = 8;   // rows of threads in inv_offdiag_kernel
constexpr int kRows = kT / kTY;

__global__ void __launch_bounds__(kT)
inv_diag_kernel(const float* __restrict__ L, float* __restrict__ Inv, int b) {
  __shared__ float D[kT][kT + 1];
  const size_t base = static_cast<size_t>(blockIdx.y) * b * b;
  const int r0 = blockIdx.x * kT;
  const int j = threadIdx.x;  // column of the inverse this thread owns
  for (int i = 0; i < kT; ++i) {
    D[i][j] = L[base + static_cast<size_t>(r0 + i) * b + r0 + j];
  }
  __syncthreads();
  // x = column j of D^-1: x[i] = (delta_ij - sum_{k<i} D[i][k] x[k]) / D[i][i]
  // for i >= j; x[k] = 0 for k < j, so the sum may start at k = 0.
  float x[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    float s = (i == j) ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < i; ++k) s -= D[i][k] * x[k];
    x[i] = (i < j) ? 0.0f : s / D[i][i];
  }
  float* out = Inv + base;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    out[static_cast<size_t>(r0 + i) * b + r0 + j] = x[i];
  }
  for (int c = r0 + kT; c < b; c += kT) {  // tiles above the diagonal
    for (int i = 0; i < kT; ++i) {
      out[static_cast<size_t>(r0 + i) * b + c + j] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kT * kTY)
inv_offdiag_kernel(const float* __restrict__ L, float* __restrict__ Inv,
                   int b, int s) {
  __shared__ float Ls[kT][kT + 1];
  __shared__ float Xs[kT][kT + 1];
  const size_t base = static_cast<size_t>(blockIdx.y) * b * b;
  const float* Lm = L + base;
  float* X = Inv + base;
  const int j = blockIdx.x;  // tile column
  const int i = j + s;       // tile row
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  // acc = sum_{k=j}^{i-1} L[i,k] inv[k,j]
  for (int k = j; k < i; ++k) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + r * kTY;
      Ls[row][tx] = Lm[static_cast<size_t>(i * kT + row) * b + k * kT + tx];
      Xs[row][tx] = X[static_cast<size_t>(k * kT + row) * b + j * kT + tx];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty + r * kTY;
#pragma unroll 8
      for (int c = 0; c < kT; ++c) acc[r] += Ls[row][c] * Xs[c][tx];
    }
    __syncthreads();
  }
  // inv[i,j] = -inv[i,i] acc
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ty + r * kTY;
    Ls[row][tx] = acc[r];
    Xs[row][tx] = X[static_cast<size_t>(i * kT + row) * b + i * kT + tx];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = ty + r * kTY;
    float o = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kT; ++c) o += Xs[row][c] * Ls[c][tx];
    X[static_cast<size_t>(i * kT + row) * b + j * kT + tx] = -o;
  }
}

}  // namespace

// A, L and Linv: (B, b, b) contiguous float32 device arrays, b a multiple of
// 32; A symmetric positive definite (only its lower triangle is read). Writes
// the lower factor into L and its inverse into Linv (zeros above the
// diagonal in both). Launches on `stream`, does not synchronise, and returns
// the first cudaGetLastError() that is not cudaSuccess.
extern "C" int madai_panel_factor(const float* A, float* L, float* Linv,
                                  int B, int b, void* stream) {
  if (B <= 0 || b <= 0 || b % kT != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = madai_cholesky(A, L, B, b, stream);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = b / kT;
  inv_diag_kernel<<<dim3(nb, B), kT, 0, st>>>(L, Linv, b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int s = 1; s < nb; ++s) {
    inv_offdiag_kernel<<<dim3(nb - s, B), dim3(kT, kTY), 0, st>>>(
        L, Linv, b, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
