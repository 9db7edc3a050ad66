// Kernel K2: batched lower Cholesky factorization for Hopper.
//
// Replaces the TPU kernel madaiemulator_tpu/ops/pallas/cholesky.py
// (pallas_cholesky; body _chol_kernel, helpers _unblocked_chol_block and
// _tri_inv_block): the lower factor L of each SPD matrix A[b] in a batch,
// with zeros above the diagonal.
//
// What bounds it on this card: at the serve path's sizes (n <= 1024, a batch
// of r ~ 4 components) neither flops (n^3 / 3 per matrix: 2.7 us at
// (4, 512, 512) against 67 TFLOP/s of FP32 FFMA) nor bytes. The
// factorization is a chain of n / 32 dependent panel steps with little work
// in each, so what it costs is the latency of one step times the number of
// steps. A 1024^2 f32 matrix is 4 MiB, far over the 227 KB of shared memory
// a CTA may use, so the TPU kernel's "whole matrix on chip" design does not
// carry over as it is.
//
// Design: ONE launch per call. The grid is B thread-block clusters, one
// cluster of C CTAs per matrix (C from the shape alone, csrc/chol_cluster.cuh
// cluster_size_rule: one CTA per 32 rows up to 16, fewer when the batch
// would need a second wave of clusters). The panel chain runs inside the
// kernel, right-looking over 32-wide panels, with cluster.sync() where a
// launch boundary would stand: the diagonal block factored redundantly by
// one warp of every CTA (lane = row, the row in registers, the pivot column
// broadcast through shared memory), the panel below solved by all warps of
// the cluster, the trailing update in 64x64 register-tiled FP32 tiles dealt
// round-robin over the cluster, the next tile's operands in flight while
// one computes. The matrix stays in L2-resident global memory; tril(A) is
// copied into L at first touch. A pivot that is not positive (or is NaN)
// becomes NaN, and NaN then fills the rest of the factor, so a non-SPD input
// gives NaN entries, never finite garbage and never a hang: the callers'
// finiteness check (chol_ok) and the jitter ladder work as in the JAX
// package. n needs no padding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include "chol_cluster.cuh"

namespace {

__global__ void __launch_bounds__(madai::kThreads, 1)
chol_cluster_kernel(const float* A, float* L, int n) {
  namespace cg = cooperative_groups;
  __shared__ madai::Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t off = static_cast<size_t>(blockIdx.x / C) * n * n;
  madai::factor_in_cluster<true>(cluster, sm, A + off, L + off, n, rank, C);
}

}  // namespace

// CTAs per matrix that madai_cholesky and madai_panel_factor choose for a
// batch of B matrices of side n.
extern "C" int madai_cluster_size(int B, int n) {
  return madai::cluster_size_rule(B, n);
}

// How many clusters of C CTAs of kernel K2 the card holds at once (0: such
// a cluster cannot be scheduled); negative on a CUDA error.
extern "C" int madai_cholesky_max_active_clusters(int C) {
  return madai::max_active_clusters(chol_cluster_kernel, C);
}

// A and L: (B, n, n) contiguous float32 device arrays, A symmetric positive
// definite (only its lower triangle is read). Writes the lower factor into L
// (zeros above the diagonal). One kernel launch on `stream`; does not
// synchronise, and returns the launch's cudaError_t (0 on success).
extern "C" int madai_cholesky(const float* A, float* L, int B, int n,
                              void* stream) {
  if (B <= 0 || n <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return madai::launch_clusters(chol_cluster_kernel, B,
                                madai::cluster_size_rule(B, n),
                                static_cast<cudaStream_t>(stream), A, L, n);
}
