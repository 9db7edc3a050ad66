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
// b = 1024 per panel; the bytes (the lower triangle of A in, L and L^-1 out)
// bound it a little less. At a batch of 1-2 panels the real limit is the
// chain of dependent steps: its cost is the latency of one step times the
// number of steps, so the design keeps both small.
//
// Design: ONE launch per call, factor and inverse in the same kernel with no
// launch between (the TPU kernel's point). The grid is B thread-block
// clusters, one cluster of C CTAs per panel (csrc/chol_cluster.cuh
// cluster_size_rule), cluster.sync() between dependent stages. Three (b, b)
// f32 buffers are 3-12 MiB, far over the 227 KB of shared memory a CTA may
// use, so the kernel works in L2-resident global memory and stages tiles in
// shared memory.
//   Stage 1, the factor: kernel K2's device code (factor_in_cluster;
//     each diagonal block is written to L only after the barrier that
//     follows every CTA's load of it).
//   Stage 2, the inverse, by recursive doubling:
//     * level 0: the 32x32 diagonal tiles of L, dealt over the cluster's
//       warps, inverted by forward substitution (lane = column of the
//       inverse, the column in registers); the strict upper tiles of L^-1
//       are zeroed;
//     * level s = 32, 64, ...: neighbouring inverted blocks of side s are
//       merged, inv21 = -invC (B invA) with B = L[C rows, A columns]: two
//       product stages in 64x64 register-tiled FP32 tiles dealt round-robin
//       over the cluster, each reading only the lower-triangular part of
//       its triangular operand. That is log2(b / 32) levels (two barriers
//       each) against the b / 32 - 1 dependent steps of a tile-diagonal
//       wavefront. T = B invA is kept in a block of L's upper triangle,
//       which nothing reads, and L's strict upper tiles are zeroed
//       at the end. b / 32 need not be a power of two: a last block without
//       a neighbour waits for the next level.
//   NaN in L becomes NaN in L^-1 (0 * NaN is NaN), so a failed member has
//   NaN in both outputs and the other members are untouched. The barrier
//   that orders each cross-CTA store and load of both stages is in the
//   table at the top of chol_cluster.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include "chol_cluster.cuh"

namespace {

using madai::kNB;
using madai::kPad;
using madai::kTile;
using madai::kWarps;

// One warp: Linv[tile t, tile t] = inverse of the diagonal tile t of L,
// zeros above the tile's diagonal. lane = column j of the inverse:
// x[k] = (delta_kj - sum_{i<k} D[k][i] x[i]) (1 / D[k][k]), the right-hand side
// in registers, rolled and shifting by one per row; row k of the inverse
// goes straight to global memory (lane = column: coalesced).
__device__ __forceinline__ void invert_diag_tile(float* stage, const float* L,
                                                 float* Linv, size_t b, int t,
                                                 int lane) {
  const size_t at = (static_cast<size_t>(t) * kNB) * b + t * kNB;
  float s[kNB];
#pragma unroll  // all 32 loads in flight at once
  for (int r = 0; r < kNB; ++r) s[r] = __ldcg(L + at + r * b + lane);
#pragma unroll
  for (int r = 0; r < kNB; ++r) stage[r * kPad + lane] = s[r];
  __syncwarp();
  const float rd = 1.0f / stage[lane * kPad + lane];
#pragma unroll
  for (int k = 0; k < kNB; ++k) s[k] = (k == lane) ? 1.0f : 0.0f;
#pragma unroll 1
  for (int k = 0; k < kNB; ++k) {
    const float xk = s[0] * __shfl_sync(0xffffffffu, rd, k);
    Linv[at + k * b + lane] = (lane <= k) ? xk : 0.0f;
    // s[l - 1] = rhs[k + l] - D[k + l][k] x[k]; rows past 31 wrap to rows
    // above k, where D[.][k] is zero
#pragma unroll
    for (int l = 1; l < kNB; ++l) {
      s[l - 1] = fmaf(-stage[((k + l) & 31) * kPad + k], xk, s[l]);
    }
    s[kNB - 1] = 0.0f;
  }
  __syncwarp();
}

// Zero the 32x32 tiles strictly above the diagonal of M, rows dealt over the
// cluster's warps.
__device__ __forceinline__ void zero_upper_tiles(float* M, size_t b, int rank,
                                                 int C, int warp, int lane) {
  const int bb = static_cast<int>(b);
  for (int r = rank * kWarps + warp; r < bb; r += C * kWarps) {
    for (int c = (r / kNB + 1) * kNB + lane; c < bb; c += kNB) {
      M[r * b + c] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(madai::kThreads, 1)
panel_factor_cluster_kernel(const float* A, float* L, float* Linv, int b_) {
  namespace cg = cooperative_groups;
  __shared__ madai::Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = static_cast<size_t>(b_);
  const size_t off = static_cast<size_t>(blockIdx.x / C) * b * b;
  A += off;
  L += off;
  Linv += off;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15;

  // stage 1: the factor; ends on a cluster.sync()
  madai::factor_in_cluster<false>(cluster, sm, A, L, b_, rank, C);

  // stage 2, level 0
  {
    float* stage = sm.buf + warp * kNB * kPad;
    const int nb = b_ / kNB;
    for (int t = rank * kWarps + warp; t < nb; t += C * kWarps) {
      invert_diag_tile(stage, L, Linv, b, t, lane);
    }
    zero_upper_tiles(Linv, b, rank, C, warp, lane);
  }
  cluster.sync();

  // stage 2, levels s = 32, 64, ...: merge blocks [r0, r0 + s) (A) and
  // [r0 + s, r0 + s + sc) (C), r0 a multiple of 2 s
  for (int s = kNB; s < b_; s *= 2) {
    const int pairs = (b_ + 2 * s - 1) / (2 * s);
    const int ts = (s + kTile - 1) / kTile;  // tiles a side
    const int njobs = pairs * ts * ts;
    // T = B invA into L's upper triangle: T[i][j] at L[r0 + i][r0 + sc + j]
    // (rows of the A block, columns from the end of those rows' diagonal
    // tiles on: inside the matrix also when the C block is short); invA is
    // lower triangular, so column tile j0 needs k >= j0 only
    for (int job = rank; job < njobs; job += C) {
      const int r0 = (job / (ts * ts)) * 2 * s;
      const int i0 = ((job / ts) % ts) * kTile, j0 = (job % ts) * kTile;
      const int sc = min(s, b_ - r0 - s);  // side of the C block (<= 0: none)
      if (i0 >= sc) continue;
      float acc[4][4];
      madai::product_tile(acc, sm, L + (r0 + s + i0) * b + r0 + j0,
                          Linv + (r0 + j0) * b + r0 + j0, b, sc - i0, s - j0,
                          (s - j0) / kNB);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + 4 * tx + q;
          if (i < sc && j < s) L[(r0 + i) * b + r0 + sc + j] = acc[r][q];
        }
      }
    }
    cluster.sync();
    // inv21 = -invC T: invC is lower triangular, so row tile i0 needs
    // k < i0 + 64 only
    for (int job = rank; job < njobs; job += C) {
      const int r0 = (job / (ts * ts)) * 2 * s;
      const int i0 = ((job / ts) % ts) * kTile, j0 = (job % ts) * kTile;
      const int sc = min(s, b_ - r0 - s);
      if (i0 >= sc) continue;
      float acc[4][4];
      madai::product_tile(acc, sm, Linv + (r0 + s + i0) * b + r0 + s,
                          L + static_cast<size_t>(r0) * b + r0 + sc + j0, b,
                          sc - i0, s - j0, min(sc, i0 + kTile) / kNB);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + 4 * tx + q;
          if (i < sc && j < s) Linv[(r0 + s + i) * b + r0 + j] = -acc[r][q];
        }
      }
    }
    cluster.sync();
  }
  zero_upper_tiles(L, b, rank, C, warp, lane);
}

}  // namespace

// A, L and Linv: (B, b, b) contiguous float32 device arrays, b a multiple of
// 32; A symmetric positive definite (only its lower triangle is read). Writes
// the lower factor into L and its inverse into Linv (zeros above the
// diagonal in both). One kernel launch on `stream`; does not synchronise,
// and returns the launch's cudaError_t (0 on success).
extern "C" int madai_panel_factor(const float* A, float* L, float* Linv,
                                  int B, int b, void* stream) {
  if (B <= 0 || b <= 0 || b % kNB != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return madai::launch_clusters(panel_factor_cluster_kernel, B,
                                madai::cluster_size_rule(B, b),
                                static_cast<cudaStream_t>(stream), A, L, Linv,
                                b);
}
