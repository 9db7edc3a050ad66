// Kernel K1: fused pairwise covariance (Gram / cross-covariance) for Hopper.
//
// Replaces the TPU kernel madaiemulator_tpu/ops/pallas/pairwise.py
// (pairwise_covariance; body _pairwise_kernel, epilogue _epilogue):
//
//     out[b, i, j] = family(sum_k (U[b, i, k] - V[b, j, k])^2)
//                    (+ diag_add[b] where i == j, when add_diag is set)
//
// on points already divided by their length scales, for a batch of B
// components at once (blockIdx.z).
//
// What bounds it on this card: the store of the (n1, n2) f32 output. The
// feature dimension d is tiny (6 at the flagship width), so one output costs
// about 3d flops and one expf for a 4-byte store: an elementwise tile pass
// far below the fp32 ridge point, not a GEMM. The inputs (n1 + n2) * d are
// negligible next to the output.
//
// Design:
//   * one CTA per 64x64 output tile; its 64 U rows and 64 V rows are staged
//     in shared memory 32 features at a time (fixed 16 KB for any d);
//   * each of the 256 threads owns 8 rows x 2 columns of the tile and keeps
//     the 16 distances in registers; a warp stores 32 consecutive floats of
//     one row (128 B, coalesced);
//   * the distance is the direct form sum_k (u_k - v_k)^2, accumulated in
//     fp32 with explicit round-to-nearest ops (no FMA contraction, no tensor
//     cores, no TF32). It therefore equals the plain PyTorch version bit for
//     bit, and for U == V entry (i, j) equals entry (j, i) bit for bit: the
//     Gram is symmetric by construction, which the factorization relies on;
//   * the family epilogue and the diagonal add are fused before the single
//     store; the ragged edge is masked instead of padded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: expf/sqrtf stay IEEE-accurate).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTM = 64;         // output tile rows
constexpr int kTN = 64;         // output tile columns
constexpr int kTK = 32;         // features staged per pass
constexpr int kBX = 32;         // threads per row of the block
constexpr int kBY = 8;          // rows of threads
constexpr int kRM = kTM / kBY;  // output rows per thread
constexpr int kRN = kTN / kBX;  // output columns per thread

enum Family { kPowerExp = 0, kMatern32 = 1, kMatern52 = 2 };

// Same operation order as the plain version (ops/hopper/pairwise.py).
template <int FAM>
__device__ __forceinline__ float epilogue(float d2, float amp) {
  if (FAM == kPowerExp) {
    return __fmul_rn(amp, expf(__fmul_rn(-0.5f, d2)));
  }
  const float r = sqrtf(__fadd_rn(d2, 1e-36f));
  if (FAM == kMatern32) {
    const float s = __fmul_rn(1.7320508075688772f, r);  // sqrt(3) r
    return __fmul_rn(__fmul_rn(amp, __fadd_rn(1.0f, s)), expf(-s));
  }
  const float s = __fmul_rn(2.2360679774997896f, r);  // sqrt(5) r
  const float poly =
      __fadd_rn(__fadd_rn(1.0f, s), __fdiv_rn(__fmul_rn(s, s), 3.0f));
  return __fmul_rn(__fmul_rn(amp, poly), expf(-s));
}

template <int FAM>
__global__ void __launch_bounds__(kBX * kBY)
pairwise_kernel(const float* __restrict__ U, const float* __restrict__ V,
                const float* __restrict__ amp,
                const float* __restrict__ diag_add, float* __restrict__ out,
                int n1, int n2, int d, int add_diag) {
  __shared__ float Us[kTK][kTM];
  __shared__ float Vs[kTK][kTN];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTM;
  const int col0 = blockIdx.x * kTN;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  const float* Ub = U + static_cast<size_t>(b) * n1 * d;
  const float* Vb = V + static_cast<size_t>(b) * n2 * d;

  float acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kTK) {
    const int kw = min(kTK, d - k0);
    // rows of U and V are contiguous in memory: idx walks them in order
    for (int idx = tid; idx < kTM * kTK; idx += kBX * kBY) {
      const int m = idx / kTK;
      const int k = idx % kTK;
      const int row = row0 + m;
      const int col = col0 + m;
      Us[k][m] = (row < n1 && k < kw)
                     ? Ub[static_cast<size_t>(row) * d + k0 + k] : 0.0f;
      Vs[k][m] = (col < n2 && k < kw)
                     ? Vb[static_cast<size_t>(col) * d + k0 + k] : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < kw; ++k) {
      float v[kRN];
#pragma unroll
      for (int j = 0; j < kRN; ++j) v[j] = Vs[k][tx + j * kBX];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float u = Us[k][ty + i * kBY];
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const float df = __fsub_rn(u, v[j]);
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(df, df));
        }
      }
    }
    __syncthreads();
  }

  const float a = amp[b];
  const float g = diag_add[b];
  float* ob = out + static_cast<size_t>(b) * n1 * n2;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = row0 + ty + i * kBY;
    if (row >= n1) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int col = col0 + tx + j * kBX;
      if (col >= n2) continue;
      float val = epilogue<FAM>(acc[i][j], a);
      if (add_diag && row == col) val = __fadd_rn(val, g);
      ob[static_cast<size_t>(row) * n2 + col] = val;
    }
  }
}

}  // namespace

// U (B, n1, d), V (B, n2, d), amp (B,), diag_add (B,), out (B, n1, n2):
// contiguous float32 device arrays. family: 0 power-exponential (alpha = 2),
// 1 Matern-3/2, 2 Matern-5/2. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch.
extern "C" int madai_pairwise_covariance(const float* U, const float* V,
                                         const float* amp,
                                         const float* diag_add, float* out,
                                         int B, int n1, int n2, int d,
                                         int family, int add_diag,
                                         void* stream) {
  if (B <= 0 || n1 <= 0 || n2 <= 0 || d <= 0 || B > 65535 ||
      (n1 + kTM - 1) / kTM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n2 + kTN - 1) / kTN, (n1 + kTM - 1) / kTM, B);
  const dim3 block(kBX, kBY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kPowerExp:
      pairwise_kernel<kPowerExp><<<grid, block, 0, s>>>(
          U, V, amp, diag_add, out, n1, n2, d, add_diag);
      break;
    case kMatern32:
      pairwise_kernel<kMatern32><<<grid, block, 0, s>>>(
          U, V, amp, diag_add, out, n1, n2, d, add_diag);
      break;
    case kMatern52:
      pairwise_kernel<kMatern52><<<grid, block, 0, s>>>(
          U, V, amp, diag_add, out, n1, n2, d, add_diag);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* madai_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
