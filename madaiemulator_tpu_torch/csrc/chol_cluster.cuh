// Device code shared by kernel K2 (csrc/cholesky.cu) and kernel K3
// (csrc/panel_factor.cu): the blocked Cholesky factorization of ONE matrix by
// ONE thread-block cluster, inside one kernel launch, and the 64x64
// register-tiled FP32 products both kernels are built from.
//
// A cluster of C CTAs (C from cluster_size_rule) owns one matrix of the
// batch. The matrix stays in global memory (L2-resident: a 1024^2 f32 matrix
// is 4 MiB, far over the 227 KB of shared memory a CTA may use); shared
// memory holds the 32x32 diagonal block and the tiles in flight. Where the
// first port had a launch boundary between dependent steps, this code has
// cluster.sync(): a hardware barrier over co-scheduled SMs whose
// release/acquire makes one CTA's global writes visible to the others.
//
// Rules every function here keeps:
//  * a CTA with no rows or tiles left still reaches every cluster.sync();
//  * data written by another CTA of the cluster is read with __ldcg (L2),
//    never through the non-coherent path (__ldg / const __restrict__);
//  * every product is full-FP32 FFMA (no tensor cores, no TF32): the TPU
//    kernels pin Precision.HIGHEST on every dot;
//  * no CTA stores to an address that another CTA of the cluster may still
//    load, or load from one that another may still store to, without a
//    cluster.sync() between (write-after-read as well as read-after-write).
//
// Every pair of accesses by two CTAs of a cluster to the same global
// addresses in K2 and K3, in order, with the barrier between ("->"). Stage
// 1 is factor_in_cluster at panel k0, S1 its barrier after the panel solve
// and S2 the one after the trailing update; stage 2 is K3's inverse
// (panel_factor.cu).
//  * diagonal block of k0: the trailing update of k0 - 32 stores it -> (S2
//    of k0 - 32) every CTA loads it -> (S1 of k0) the top ranks store its
//    factor -> (S2 of k0, the kernel's end) K3's level 0 and the caller
//    load it. At the last panel rank 0 alone loads and stores it;
//  * panel rows of k0: the trailing update of k0 - 32 stores them -> (S2
//    of k0 - 32) the warp of their chunk loads and stores them -> (S1 of
//    k0) every CTA's trailing update loads them as L21;
//  * a trailing tile: its CTA loads and stores it -> (S2 of k0) every CTA
//    at panel k0 + 32;
//  * K3's Linv diagonal tiles: one warp a tile stores them -> (the barrier
//    after level 0) level 32's products load them;
//  * K3's T, in L's upper triangle off the diagonal tiles: level s's first
//    product stores it -> (the barrier between them) its second loads it
//    -> (the barrier ending level s) level 2s's first stores over it;
//  * K3's Linv below the diagonal, level s: the second product stores it
//    -> (the barrier ending level s) level 2s's products load it;
//  * L's upper tiles in K3: the last level's second product loads T ->
//    (the barrier ending that level) zero_upper_tiles stores zeros.
// K2's ZERO_UPPER stores (right of the diagonal block) and K3's T scratch
// never meet a diagonal block or a load of the lower triangle.
// tools/cluster_skew.py holds the outputs of a build in which every CTA but
// rank 0 waits before each diagonal-block load (MADAI_CLUSTER_SKEW_NS)
// bitwise equal to the production build's; a barrier moved without this
// list in view shows there.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace madai {

namespace cg = cooperative_groups;

constexpr int kNB = 32;        // panel width and tile side of the inverse
// Row pitch of a 32-wide tile in shared memory: a multiple of 4, so that a
// thread reads its row as float4, and 4 mod 32, so that neither 32 lanes
// writing one row nor 8 lanes reading float4s of 8 rows collide on a bank.
constexpr int kPad = kNB + 4;
constexpr int kThreads = 256;  // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // output tile side of the products
constexpr int kMaxCluster = 16;

// Shared memory of one CTA (about 41 KB, static). `buf` is, by phase, one
// 32x32 staging tile per warp (panel solve, diagonal-tile inverse) or the two
// operand tiles of a product.
struct alignas(16) Smem {
  // The diagonal block: row-major A11 as loaded, then the TRANSPOSED factor,
  // Dt[j][i] = L11[i][j] (zeros for i < j), so that column j of L11 is one
  // contiguous row that every lane reads as broadcast float4s.
  float Dt[kNB][kPad];
  float rD[kNB];  // reciprocals of the factor's diagonal
  float buf[kWarps * kNB * kPad];
};

// Clusters of c CTAs (256 threads, one CTA per SM) that an H100 SXM holds at
// once: what cudaOccupancyMaxActiveClusters reports for these kernels (132
// SMs in GPCs of 16 or 18, a cluster never spans two GPCs).
inline int clusters_at_once(int c) {
  return c >= 16 ? 7 : c == 8 ? 15 : c == 4 ? 30 : c == 2 ? 66 : 132;
}

// CTAs per matrix, from the batch and the matrix side alone: one CTA per 32
// rows up to 16, halved while the batch would need a second wave of clusters
// (two waves cost twice the chain; narrower clusters only lose parallelism
// in the trailing update).
inline int cluster_size_rule(int B, int n) {
  int c = 1;
  while (c < kMaxCluster && c * kNB < n) c *= 2;
  while (c > 1 && B > clusters_at_once(c)) c /= 2;
  return c;
}

// Launch `kernel` with B clusters of C CTAs on `stream`; returns the launch's
// cudaError_t (a refused cluster launch is an error, never a fallback).
template <typename... Params, typename... Args>
inline int launch_clusters(void (*kernel)(Params...), int B, int C,
                           cudaStream_t stream, Args... args) {
  if (C > 8) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of C CTAs of `kernel` the card holds at once (0: such a
// cluster cannot be scheduled at all); negative on a CUDA error.
template <typename... Params>
inline int max_active_clusters(void (*kernel)(Params...), int C) {
  if (C > 8) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
      return -1;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Global memory in 16-byte pieces. Every tile is moved as float4s, four
// times fewer requests than by single floats: the requests in flight, not
// the bytes, bound how much of the next tile can be fetched behind the
// current one. `vec` says that the address is 16-byte aligned (the matrix
// side is a multiple of 4); otherwise the four floats go one by one.

// p[0 .. 3], elements at or past `valid` read as zero (nothing past `valid`
// is touched unless vec, and then only if valid == 4).
__device__ __forceinline__ float4 ldcg4(const float* p, bool vec, int valid) {
  if (vec && valid >= 4) return __ldcg(reinterpret_cast<const float4*>(p));
  float4 v;
  v.x = (valid > 0) ? __ldcg(p) : 0.0f;
  v.y = (valid > 1) ? __ldcg(p + 1) : 0.0f;
  v.z = (valid > 2) ? __ldcg(p + 2) : 0.0f;
  v.w = (valid > 3) ? __ldcg(p + 3) : 0.0f;
  return v;
}

// p[0 .. count) = v's first `count` elements.
__device__ __forceinline__ void st4(float* p, float4 v, bool vec, int count) {
  if (vec && count >= 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (count > 0) p[0] = v.x;
  if (count > 1) p[1] = v.y;
  if (count > 2) p[2] = v.z;
  if (count > 3) p[3] = v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// 64x64 product tiles: 256 threads, thread (ty, tx) of a 16x16 layout owns
// rows ty + 16 r (r < 4) and columns 4 tx + q (q < 4) of the tile. Operands
// are read from shared memory as float4s, eight FMAs to a read, without bank
// conflicts, so the FMA pipe and not the shared-memory pipe bounds a tile.

__device__ __forceinline__ void zero_acc(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  }
}

// Where the float4 (row, columns 4 c4 .. 4 c4 + 3) of a [64][32] operand read
// by rows 4 tx + q stands in shared memory: pitch 32, the chunk index XORed
// with bits 2-4 of the row, so that the eight rows 4 tx + q of a quarter warp
// fall on eight different bank groups.
__device__ __forceinline__ int swizzled(int row, int c4) {
  return row * kNB + 4 * (c4 ^ ((row >> 2) & 7));
}

// acc += Ps Qt^T over a depth of 32: Ps is [64][kPad] row-major, Qt is
// [64][32] `swizzled`; acc[r][q] is row ty + 16 r, column 4 tx + q.
__device__ __forceinline__ void fma_tile_nt(float (&acc)[4][4],
                                            const float* Ps, const float* Qt,
                                            int ty, int tx) {
#pragma unroll
  for (int c4 = 0; c4 < kNB / 4; ++c4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(Ps + (ty + 16 * r) * kPad + 4 * c4);
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = ld4(Qt + swizzled(4 * tx + q, c4));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = acc[r][q];
        v = fmaf(a[r].x, b[q].x, v);
        v = fmaf(a[r].y, b[q].y, v);
        v = fmaf(a[r].z, b[q].z, v);
        acc[r][q] = fmaf(a[r].w, b[q].w, v);
      }
    }
  }
}

// acc += Ps Qs over a depth of 32: Ps is [64][kPad], Qs is [32][kTile];
// acc[r][q] is row ty + 16 r, column 4 tx + q.
__device__ __forceinline__ void fma_tile_nn(float (&acc)[4][4],
                                            const float* Ps, const float* Qs,
                                            int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < kNB; c += 4) {
    float4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(Ps + (ty + 16 * r) * kPad + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 b = ld4(Qs + (c + e) * kTile + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ar = e == 0 ? a[r].x : e == 1 ? a[r].y
                       : e == 2 ? a[r].z : a[r].w;
        acc[r][0] = fmaf(ar, b.x, acc[r][0]);
        acc[r][1] = fmaf(ar, b.y, acc[r][1]);
        acc[r][2] = fmaf(ar, b.z, acc[r][2]);
        acc[r][3] = fmaf(ar, b.w, acc[r][3]);
      }
    }
  }
}

// 64 rows x 32 columns of a row-major matrix into registers: thread t takes
// the float4 at columns 4 (t % 8) of rows t / 8 and t / 8 + 32. `p` points at
// (row 0, column 0) of the block; rows at or past `rows` read as zero.
__device__ __forceinline__ void fetch_rows(float4 (&reg)[2], const float* p,
                                           size_t ld, int rows, bool vec,
                                           int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (tid >> 3) + 32 * h;
    reg[h] = ldcg4(p + r * ld + 4 * (tid & 7), vec, r < rows ? 4 : 0);
  }
}

// ... into a [64][kPad] row-major tile.
__device__ __forceinline__ void stash_rows(float* S, const float4 (&reg)[2],
                                           int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<float4*>(S + ((tid >> 3) + 32 * h) * kPad +
                               4 * (tid & 7)) = reg[h];
  }
}

// ... into a [64][32] `swizzled` tile.
__device__ __forceinline__ void stash_rows_swizzled(float* S,
                                                    const float4 (&reg)[2],
                                                    int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<float4*>(S + swizzled((tid >> 3) + 32 * h, tid & 7)) =
        reg[h];
  }
}

// acc = P Q for one 64x64 output tile, depth 32 * nsteps, of a matrix whose
// side `ld` is a multiple of 4. P points at (tile row 0, k = 0), row-major
// with pitch ld, rows at or past `rows` read as zero; Q points at (k = 0,
// tile column 0), columns at or past `cols` read as zero. acc[r][q] is row
// ty + 16 r, column 4 tx + q of the tile (ty = thread / 16, tx = thread %
// 16). The next step's operands are in flight while this one computes.
// Every thread of the CTA must call it (it synchronises the CTA).
__device__ __forceinline__ void product_tile(float (&acc)[4][4], Smem& sm,
                                             const float* P, const float* Q,
                                             size_t ld, int rows, int cols,
                                             int nsteps) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  float* Ps = sm.buf;
  float* Qs = sm.buf + kTile * kPad;
  float4 rp[2], rq[2];
  auto fetch = [&](int st) {
    fetch_rows(rp, P + st * kNB, ld, rows, true, tid);
    const float* q = Q + static_cast<size_t>(st) * kNB * ld;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k row ty + 16 h, columns 4 tx ..
      rq[h] = ldcg4(q + (ty + 16 * h) * ld + 4 * tx, true, cols - 4 * tx);
    }
  };
  zero_acc(acc);
  fetch(0);
  for (int st = 0; st < nsteps; ++st) {
    stash_rows(Ps, rp, tid);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(Qs + (ty + 16 * h) * kTile + 4 * tx) = rq[h];
    }
    __syncthreads();
    if (st + 1 < nsteps) fetch(st + 1);
    fma_tile_nn(acc, Ps, Qs, ty, tx);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The factorization.

// 1 / p for p > 0, NaN otherwise (p <= 0 or NaN): the approximate reciprocal
// and one Newton step. It sits on the chain of dependent columns, where the
// IEEE division's longer instruction sequence was measured to cost a third
// of the whole diagonal factor; its error, within an ulp or two of the
// division's, only scales an elimination multiplier.
__device__ __forceinline__ float rcp_pivot(float p) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(p));
  r = fmaf(r, fmaf(-p, r, 1.0f), r);
  return (p > 0.0f) ? r : nanf("");
}

// Warp 0: factor the jb x jb block held row-major in sm.Dt, lane = row, the
// row in registers; leaves the TRANSPOSED factor in sm.Dt. The cost is the
// chain of 32 dependent columns, so each link is kept short:
//  * the square root and the scaling of the columns are off the chain:
//    column j is eliminated unscaled, a[l] -= a[j] (1 / p_j) a_l[j], which
//    leaves p_j on the diagonal, and all columns are scaled by 1 / sqrt(p_j)
//    at the end;
//  * the pivot and the two entries that the next two columns wait for come
//    by shuffle, and only columns j + 1 and j + 2 are updated on the chain;
//  * the rest of the update of column j goes through shared memory (column
//    j is written to row j of sm.Dt and read back as broadcast float4s) one
//    iteration later, so that its latency lies beside the chain.
// A pivot that is not > 0 (or is NaN) becomes NaN, and NaN then fills the
// rest of the block. Leaves zeros above the diagonal and in rows / columns
// at or past jb, and sm.rD[j] = 1 / L11[j][j] (0 at or past jb).
__device__ __forceinline__ void factor_diag_warp(Smem& sm, int lane, int jb) {
  constexpr unsigned kAll = 0xffffffffu;
  float a[kNB];
#pragma unroll
  for (int q = 0; q < kNB / 4; ++q) {
    const float4 v = ld4(&sm.Dt[lane][4 * q]);
    a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z, a[4 * q + 3] = v.w;
  }
  __syncwarp();
  float t_prev = 0.0f;           // column j - 1's multiplier
  float4 c_prev[kNB / 4] = {};   // and its entries, from sm.Dt[j - 1]
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    float t = 0.0f;
    if (j < jb && j < kNB - 1) {  // uniform over the warp
      // entries above the diagonal carry garbage that nothing below it reads
      const float p = __shfl_sync(kAll, a[j], j);
      const float c1 = __shfl_sync(kAll, a[j], j + 1);
      const float c2 = __shfl_sync(kAll, a[j], (j + 2) & 31);
      t = a[j] * rcp_pivot(p);
      a[j + 1] = fmaf(-t, c1, a[j + 1]);
      if (j + 2 < kNB) a[j + 2] = fmaf(-t, c2, a[j + 2]);
      sm.Dt[j][lane] = a[j];
      __syncwarp();
    }
    // column j - 1 on columns j + 2 and up (those behind the chain)
#pragma unroll
    for (int q = (j + 2) / 4; q < kNB / 4; ++q) {
      const float4 c = c_prev[q];
      if (4 * q >= j + 2) a[4 * q] = fmaf(-t_prev, c.x, a[4 * q]);
      if (4 * q + 1 >= j + 2) a[4 * q + 1] = fmaf(-t_prev, c.y, a[4 * q + 1]);
      if (4 * q + 2 >= j + 2) a[4 * q + 2] = fmaf(-t_prev, c.z, a[4 * q + 2]);
      if (4 * q + 3 >= j + 2) a[4 * q + 3] = fmaf(-t_prev, c.w, a[4 * q + 3]);
    }
    t_prev = t;
#pragma unroll
    for (int q = (j + 3) / 4; q < kNB / 4; ++q) c_prev[q] = ld4(&sm.Dt[j][4 * q]);
  }
  float p = 1.0f;  // this row's pivot
#pragma unroll
  for (int l = 0; l < kNB; ++l) {
    if (l == lane) p = a[l];
  }
  const float piv = (p > 0.0f) ? sqrtf(p) : nanf("");
  const float rdiag = (lane < jb) ? 1.0f / piv : 0.0f;
  sm.rD[lane] = rdiag;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const float v = (j == lane) ? piv : a[j] * sm.rD[j];
    sm.Dt[j][lane] = (j <= lane && lane < jb) ? v : 0.0f;
  }
}

// One warp: rows [row0, row0 + 32) of the panel below the diagonal block,
// X L11^T = A21 by forward substitution, lane = row with the row in
// registers, column j of L11 read as broadcast float4s from row j of sm.Dt.
// The panel is 32 wide (a narrower last panel has no rows below it). The
// 32x32 chunk goes through the warp's staging tile so that global reads and
// writes are coalesced float4s. `src` is A at the first panel (the copy of
// tril(A) into L happens here, at first touch) and L afterwards.
__device__ __forceinline__ void solve_chunk(const Smem& sm, float* stage,
                                            const float* src, float* L,
                                            size_t n, int k0, int row0,
                                            int lane) {
  const int nn = static_cast<int>(n);
  const bool vec = (nn & 3) == 0;
  {
    float4 v[8];  // rows lane / 8 + 4 i, columns 4 (lane % 8) ..
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + (lane >> 3) + 4 * i;
      v[i] = ldcg4(src + row * n + k0 + 4 * (lane & 7), vec,
                   row < nn ? 4 : 0);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float4*>(stage + ((lane >> 3) + 4 * i) * kPad +
                                 4 * (lane & 7)) = v[i];
    }
  }
  __syncwarp();
  float x[kNB];
#pragma unroll
  for (int q = 0; q < kNB / 4; ++q) {
    const float4 v = ld4(stage + lane * kPad + 4 * q);
    x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const float xj = x[j] * sm.rD[j];
    x[j] = xj;
#pragma unroll
    for (int q = (j + 1) / 4; q < kNB / 4; ++q) {
      const float4 c = ld4(&sm.Dt[j][4 * q]);  // L11[4q .. 4q + 3][j]
      if (4 * q > j) x[4 * q] = fmaf(-xj, c.x, x[4 * q]);
      if (4 * q + 1 > j) x[4 * q + 1] = fmaf(-xj, c.y, x[4 * q + 1]);
      if (4 * q + 2 > j) x[4 * q + 2] = fmaf(-xj, c.z, x[4 * q + 2]);
      if (4 * q + 3 > j) x[4 * q + 3] = fmaf(-xj, c.w, x[4 * q + 3]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kNB / 4; ++q) {
    *reinterpret_cast<float4*>(stage + lane * kPad + 4 * q) =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (lane >> 3) + 4 * i;
    st4(L + (row0 + r) * n + k0 + 4 * (lane & 7),
        ld4(stage + r * kPad + 4 * (lane & 7)), vec, row0 + r < nn ? 4 : 0);
  }
  __syncwarp();
}

// Trailing update A22 -= L21 L21^T on the lower triangle, rows and columns
// from t0 on, 64x64 tiles dealt round-robin to the C CTAs (tile (bi, bj),
// bj <= bi, has the index bi (bi + 1) / 2 + bj). L21 (columns k0 .. k0 + 32
// of L, written by the whole cluster before the barrier) is read from L2;
// the next tile's operands and old values are in flight while this one
// computes. `src` holds the values to update: A at the first panel, else L.
__device__ __forceinline__ void update_trailing(Smem& sm, const float* src,
                                                float* L, size_t n, int k0,
                                                int t0, int rank, int C) {
  const int nn = static_cast<int>(n);
  const bool vec = (nn & 3) == 0;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int T = (nn - t0 + kTile - 1) / kTile;
  float* Ps = sm.buf;
  float* Qt = sm.buf + kTile * kPad;
  float4 rp[2], rq[2], rc[4];
  int bi = 0, bj = rank;  // this CTA's next tile: advance by C per round
  auto settle = [&]() {
    while (bj > bi) {
      bj -= bi + 1;
      ++bi;
    }
  };
  auto fetch = [&]() {
    const int r0 = t0 + bi * kTile, c0 = t0 + bj * kTile;
    fetch_rows(rp, L + r0 * n + k0, n, nn - r0, vec, tid);
    fetch_rows(rq, L + c0 * n + k0, n, nn - c0, vec, tid);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + ty + 16 * r, col = c0 + 4 * tx;
      rc[r] = ldcg4(src + row * n + col, vec, row < nn ? nn - col : 0);
    }
  };
  settle();
  if (bi < T) fetch();
  while (bi < T) {
    const int row0 = t0 + bi * kTile, col0 = t0 + bj * kTile;
    stash_rows(Ps, rp, tid);
    stash_rows_swizzled(Qt, rq, tid);
    float4 old[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) old[r] = rc[r];
    __syncthreads();
    bj += C;
    settle();
    if (bi < T) fetch();
    float prod[4][4];
    zero_acc(prod);
    fma_tile_nt(prod, Ps, Qt, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + ty + 16 * r, col = col0 + 4 * tx;
      // columns up to the diagonal only, and inside the matrix
      const int count = row < nn ? min(row, nn - 1) - col + 1 : 0;
      st4(L + row * n + col,
          make_float4(old[r].x - prod[r][0], old[r].y - prod[r][1],
                      old[r].z - prod[r][2], old[r].w - prod[r][3]),
          vec, count);
    }
    __syncthreads();
  }
}

#ifdef MADAI_CLUSTER_SKEW_NS
// Test-only (build.load_skewed; the production library is compiled without
// this define): every CTA but rank 0 waits MADAI_CLUSTER_SKEW_NS ns, by the
// global timer, before it loads a diagonal block that the cluster wrote.
// That is several times rank 0's factor of the block, so a store that could
// overtake another CTA's load of the same addresses does, and the outputs
// then differ from the production build's.
__device__ __forceinline__ void skew_wait(int rank) {
  if (rank == 0) return;
  if (threadIdx.x == 0) {
    unsigned long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    do {
      __nanosleep(1000);
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    } while (t - t0 < static_cast<unsigned long long>(MADAI_CLUSTER_SKEW_NS));
  }
  __syncthreads();
}
#endif

// Lower Cholesky factor of the n x n matrix A into L by the C CTAs of one
// cluster, right-looking over 32-wide panels. Per panel: every CTA loads the
// diagonal block and its warp 0 factors it (redundantly: 32x32 is cheaper
// than a barrier); the rows below are dealt to the cluster's warps in chunks
// of 32 and solved against the block in shared memory; cluster.sync(); the
// block written back to L (only now: every CTA loaded the same addresses
// before the barrier); the trailing update, which never reads the block;
// cluster.sync(). At the last panel, which has no rows below and no first
// barrier, CTA 0 alone loads, factors and writes the block. Only the
// lower triangle of A is read. The diagonal blocks get zeros above their
// diagonal; with ZERO_UPPER the rest of the upper triangle of L is zeroed
// too (kernel K3 uses it as scratch and zeroes it at its end). Ends on a
// cluster.sync(): all of L is visible to every CTA of the cluster.
template <bool ZERO_UPPER>
__device__ __forceinline__ void factor_in_cluster(cg::cluster_group& cluster,
                                                  Smem& sm, const float* A,
                                                  float* L, int n_, int rank,
                                                  int C) {
  const size_t n = static_cast<size_t>(n_);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* stage = sm.buf + warp * kNB * kPad;
  for (int k0 = 0; k0 < n_; k0 += kNB) {
    const int jb = min(kNB, n_ - k0);
    const int t0 = k0 + jb;  // first row below the panel
    const bool below = t0 < n_;
    const float* src = (k0 == 0) ? A : L;
    if (below || rank == 0) {
#ifdef MADAI_CLUSTER_SKEW_NS
      if (k0 > 0) skew_wait(rank);
#endif
      {  // the lower triangle of the diagonal block, one float4 per thread
        const int i = tid >> 3, j = 4 * (tid & 7);
        float4 v = ldcg4(src + (k0 + i) * n + k0 + j, (n_ & 3) == 0,
                         i < jb ? min(jb, i + 1) - j : 0);
        *reinterpret_cast<float4*>(&sm.Dt[i][j]) = v;
      }
      __syncthreads();
      if (warp == 0) factor_diag_warp(sm, lane, jb);
      __syncthreads();
    }
    if (ZERO_UPPER) {  // rows of this panel, right of the diagonal block
      const int w = n_ - t0;
      for (int idx = rank * kThreads + tid; idx < jb * w;
           idx += C * kThreads) {
        L[(k0 + idx / w) * n + t0 + idx % w] = 0.0f;
      }
    }
    if (below) {
      const int chunks = (n_ - t0 + kNB - 1) / kNB;
      for (int ch = rank + warp * C; ch < chunks; ch += C * kWarps) {
        solve_chunk(sm, stage, src, L, n, k0, t0 + ch * kNB, lane);
      }
      cluster.sync();
    }
    {  // the block into L from sm.Dt, unchanged since the factor: dealt
       // over the highest ranks, which update_trailing deals the fewest
       // tiles (K2 ~2% faster so than with rank 0 writing, H100); at the last
       // panel rank 0, the only CTA that factored the block
      const int writers = below ? C : 1;
      const int q = writers - 1 - rank;
      for (int idx = q * kThreads + tid; q >= 0 && idx < jb * kNB;
           idx += writers * kThreads) {
        const int i = idx >> 5, j = idx & 31;
        if (j < jb) L[(k0 + i) * n + k0 + j] = sm.Dt[j][i];
      }
    }
    if (below) update_trailing(sm, src, L, n, k0, t0, rank, C);
    cluster.sync();
  }
}

}  // namespace madai
