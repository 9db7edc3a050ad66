// Kernel K1: fused pairwise covariance (Gram / cross-covariance) for Hopper.
//
// Replaces the TPU kernel madaiemulator_tpu/ops/pallas/pairwise.py
// (pairwise_covariance; body _pairwise_kernel, epilogue _epilogue):
//
//     out[b, i, j] = family(sum_k (U[b, i, k] - V[b, j, k])^2)
//                    (+ diag_add[b] where i == j, when add_diag is set)
//
// on points already divided by their length scales, for a batch of B
// components in one launch.
//
// What bounds it on this card: the store of the (B, n1, n2) f32 output. The
// feature dimension d is tiny (6 and 8 on the main paths), so an output costs
// about 3d + 10 fp32 instructions and one expf for a 4-byte store: at
// N = 16,384 the Gram's 1.07 GB store takes 0.32 ms at 3.35 TB/s, its
// arithmetic ~0.1 ms at the fp32 peak. Tensor cores would not help: there is
// no product deep enough to feed them, and TF32 fails the repo's float32
// gates (a factor error of 1.7e-3 against a gate of 5e-4 at config 4).
//
// Design, for the store path:
//   * persistent grid: min(tiles, resident CTAs) CTAs of 256 threads, each
//     walking 128x128 output tiles in a static order over (batch, tile row,
//     tile column), so all of a batch member's tiles are together. A call
//     with 128-tiles for fewer than half the SMs (the serve path's Gram and
//     one-query cross) takes 64x64 tiles instead, 4x4 outputs a thread: it
//     is launch-bound, and smaller tiles spread it over more SMs at a
//     quarter of the per-thread chain;
//   * the tile's 128 U rows and 128 V rows are staged in shared memory once
//     per tile at their true width d (a template parameter for d in 1..8, 16
//     and 32; other widths take a runtime loop over stages of up to 32
//     features): no zero-filled stages, no predicate in the inner loop (rows
//     past the edge are clamped and their outputs dropped);
//   * each thread owns 16 consecutive rows x 4 consecutive columns (64
//     distances in registers; 4 x 4 on 64-tiles); per feature it reads its u
//     values as broadcast float4s and its 4 v values as one float4;
//   * 16-byte streaming stores (st.global.cs): a warp writes one whole
//     512-byte row segment per instruction; the output is 20-40x the 50 MB
//     L2, so it is not kept there. A ragged edge is masked, never padded;
//     when n2 is not a multiple of 4 the stores are 4-byte ones;
//   * Gram (U and V the same array, n1 == n2): only tiles on or below the
//     diagonal are computed. Each off-diagonal tile is stored twice: as
//     computed, and transposed through a 64 KB shared-memory tile (16-byte
//     chunks XOR-swizzled against bank conflicts), so both stores stay
//     coalesced. This halves the distance and epilogue work; the stores stay
//     n^2;
//   * the distance is the direct form sum_k (u_k - v_k)^2, accumulated in
//     fp32 with explicit round-to-nearest ops (no FMA contraction, no tensor
//     cores, no TF32): it equals the plain PyTorch version bit for bit, and
//     (a - b)^2 == (b - a)^2 exactly, so a diagonal tile is symmetric and the
//     mirrored tiles make the whole Gram bitwise symmetric by construction,
//     which the factorization relies on;
//   * the family epilogue and the diagonal add are fused before the store.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: expf/sqrtf stay IEEE-accurate).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRN = 4;           // 4 consecutive output columns per thread
constexpr int kStage = 32;       // features staged per pass (runtime widths)
constexpr int kMaxDevices = 64;  // per-device caches of the launcher

// Thread layout of a T x T output tile (T = 128, or 64 for problems too
// small to fill the card with 128-tiles) over 256 threads: T/4 groups of 4
// columns by kTY rows of threads, each thread kRM consecutive rows.
template <int T>
struct Tile {
  static constexpr int kTX = T / kRN;
  static constexpr int kTY = kThreads / kTX;
  static constexpr int kRM = T / kTY;   // 16 at T = 128, 4 at T = 64
  static constexpr int kLd = T + 4;     // row stride of a staged operand
};

enum Family { kPowerExp = 0, kMatern32 = 1, kMatern52 = 2 };

struct Args {
  const float* U;
  const float* V;
  const float* amp;
  const float* diag_add;  // read only when add_diag
  float* out;
  int n1, n2, d, add_diag, tri;
  int tiles_n2;                   // tile columns (full route)
  long long tiles_per_batch, total;
};

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

// Stage rows row0 .. row0 + T - 1 of X (n rows of d features), features
// k0 .. k0 + w - 1, into S[k][m] (row stride kLd). Rows past n are clamped.
template <int T, int D>
__device__ __forceinline__ void stage(float* S, const float* __restrict__ X,
                                      int n, int d, int row0, int k0, int w,
                                      int tid) {
  const int width = D > 0 ? D : w;
  for (int idx = tid; idx < T * width; idx += kThreads) {
    const int m = idx / width;
    const int k = idx - m * width;
    const int row = min(row0 + m, n - 1);
    S[k * Tile<T>::kLd + m] =
        __ldg(X + static_cast<size_t>(row) * d + k0 + k);
  }
}

template <int T>
__device__ __forceinline__ void accumulate_one(
    float (&acc)[Tile<T>::kRM][kRN], const float* Us, const float* Vs, int k,
    int tx, int ty) {
  constexpr int kRM = Tile<T>::kRM;
  constexpr int kLd = Tile<T>::kLd;
  const float4 v = *reinterpret_cast<const float4*>(Vs + k * kLd + 4 * tx);
  const float vv[kRN] = {v.x, v.y, v.z, v.w};
  float u[kRM];
#pragma unroll
  for (int q = 0; q < kRM / 4; ++q) {
    const float4 t =
        *reinterpret_cast<const float4*>(Us + k * kLd + kRM * ty + 4 * q);
    u[4 * q] = t.x;
    u[4 * q + 1] = t.y;
    u[4 * q + 2] = t.z;
    u[4 * q + 3] = t.w;
  }
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const float df = __fsub_rn(u[i], vv[j]);
      acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(df, df));
    }
  }
}

// Store 4 consecutive values of one output row at (row, col): one 16-byte
// streaming store when the row is 16-byte aligned (n2 % 4 == 0), else up to
// four 4-byte ones, each masked at the edge.
__device__ __forceinline__ void store4(float* ob, int n1, int n2, int row,
                                       int col, bool vec, float4 v) {
  if (row >= n1 || col >= n2) return;
  float* p = ob + static_cast<size_t>(row) * n2 + col;
  if (vec) {
    __stcs(reinterpret_cast<float4*>(p), v);
    return;
  }
  __stcs(p, v.x);
  if (col + 1 < n2) __stcs(p + 1, v.y);
  if (col + 2 < n2) __stcs(p + 2, v.z);
  if (col + 3 < n2) __stcs(p + 3, v.w);
}

template <int T, int D>
constexpr size_t smem_bytes(bool tri) {
  return (2 * (D > 0 ? D : kStage) * Tile<T>::kLd + (tri ? T * T : 0)) *
         sizeof(float);
}

template <int FAM, int D, int T>
__global__ void __launch_bounds__(kThreads, 2) pairwise_kernel(Args a) {
  constexpr int kTX = Tile<T>::kTX;
  constexpr int kRM = Tile<T>::kRM;
  constexpr int kLd = Tile<T>::kLd;
  constexpr int kStaged = D > 0 ? D : kStage;
  extern __shared__ __align__(16) float smem[];
  float* Us = smem;
  float* Vs = smem + kStaged * kLd;
  float* Tt = smem + 2 * kStaged * kLd;  // transposed tile (Gram only)

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const bool vec = (a.n2 & 3) == 0;

  for (long long t = blockIdx.x; t < a.total; t += gridDim.x) {
    const int b = static_cast<int>(t / a.tiles_per_batch);
    const long long r = t - static_cast<long long>(b) * a.tiles_per_batch;
    int ti, tj;
    if (a.tri) {  // r walks the lower triangle row by row: tj <= ti
      int i = static_cast<int>((sqrtf(8.0f * static_cast<float>(r) + 1.0f)
                                - 1.0f) * 0.5f);
      while (static_cast<long long>(i) * (i + 1) / 2 > r) --i;
      while (static_cast<long long>(i + 1) * (i + 2) / 2 <= r) ++i;
      ti = i;
      tj = static_cast<int>(r - static_cast<long long>(i) * (i + 1) / 2);
    } else {
      ti = static_cast<int>(r / a.tiles_n2);
      tj = static_cast<int>(r - static_cast<long long>(ti) * a.tiles_n2);
    }
    const int row0 = ti * T;
    const int col0 = tj * T;
    const bool same = a.tri && ti == tj;  // V rows are the U rows
    const float* Ub = a.U + static_cast<size_t>(b) * a.n1 * a.d;
    const float* Vb = a.V + static_cast<size_t>(b) * a.n2 * a.d;

    float acc[kRM][kRN];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[i][j] = 0.0f;
    }

    if constexpr (D > 0) {
      __syncthreads();  // the previous tile is done with Us, Vs and Tt
      stage<T, D>(Us, Ub, a.n1, a.d, row0, 0, D, tid);
      if (!same) stage<T, D>(Vs, Vb, a.n2, a.d, col0, 0, D, tid);
      __syncthreads();
      const float* Vk = same ? Us : Vs;
#pragma unroll
      for (int k = 0; k < D; ++k) accumulate_one<T>(acc, Us, Vk, k, tx, ty);
    } else {
      for (int k0 = 0; k0 < a.d; k0 += kStage) {
        const int w = min(kStage, a.d - k0);
        __syncthreads();
        stage<T, 0>(Us, Ub, a.n1, a.d, row0, k0, w, tid);
        if (!same) stage<T, 0>(Vs, Vb, a.n2, a.d, col0, k0, w, tid);
        __syncthreads();
        const float* Vk = same ? Us : Vs;
#pragma unroll 2
        for (int k = 0; k < w; ++k) accumulate_one<T>(acc, Us, Vk, k, tx, ty);
      }
    }

    const float amp = a.amp[b];
    float* ob = a.out + static_cast<size_t>(b) * a.n1 * a.n2;
    const int col = col0 + 4 * tx;
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[i][j] = epilogue<FAM>(acc[i][j], amp);
    }
    if (a.add_diag && ti == tj) {  // the square tiles hold the diagonal
      const float g = a.diag_add[b];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          if (kRM * ty + i == 4 * tx + j) acc[i][j] = __fadd_rn(acc[i][j], g);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      store4(ob, a.n1, a.n2, row0 + kRM * ty + i, col,
             vec, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }

    if (a.tri && ti != tj) {
      // Tt[c][r] = out(row0 + r, col0 + c), in 16-byte chunks: chunk q of
      // row c sits at q ^ ((c >> 2) & 7), so neither the column-wise writes
      // below nor the row-wise reads after them meet a bank conflict.
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int c = 4 * tx + j;
#pragma unroll
        for (int q = 0; q < kRM / 4; ++q) {
          const int chunk = ((kRM / 4) * ty + q) ^ (tx & 7);
          *reinterpret_cast<float4*>(Tt + c * T + 4 * chunk) =
              make_float4(acc[4 * q][j], acc[4 * q + 1][j],
                          acc[4 * q + 2][j], acc[4 * q + 3][j]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kRM; ++s) {
        const int c = kRM * ty + s;
        const float4 v = *reinterpret_cast<const float4*>(
            Tt + c * T + 4 * (tx ^ ((c >> 2) & 7)));
        store4(ob, a.n1, a.n2, col0 + c, row0 + 4 * tx, vec, v);
      }
    }
  }
}

int sm_count(int dev) {
  static int sms[kMaxDevices];
  if (dev < kMaxDevices && sms[dev] > 0) return sms[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kMaxDevices) sms[dev] = n;
  return n;
}

// Tile counts of the route for tiles of side T.
void set_tiles(Args& a, int B, int T) {
  const long long t1 = (a.n1 + T - 1) / T;
  a.tiles_n2 = (a.n2 + T - 1) / T;
  a.tiles_per_batch = a.tri ? t1 * (t1 + 1) / 2 : t1 * a.tiles_n2;
  a.total = a.tiles_per_batch * B;
}

template <int FAM, int D, int T>
int launch(const Args& a, int dev, cudaStream_t s) {
  static int attr_set[kMaxDevices];  // max dynamic shared memory raised
  static int per_sm[kMaxDevices][2]; // resident CTAs per SM, [full, Gram]
  const auto kern = pairwise_kernel<FAM, D, T>;
  const bool cached = dev < kMaxDevices;
  cudaError_t err;
  if (!cached || !attr_set[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<T, D>(true)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cached) attr_set[dev] = 1;
  }
  const size_t smem = smem_bytes<T, D>(a.tri);
  int held = cached ? per_sm[dev][a.tri] : 0;
  if (held == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&held, kern, kThreads,
                                                        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (held < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (cached) per_sm[dev][a.tri] = held;
  }
  const long long resident = static_cast<long long>(held) * sm_count(dev);
  const int grid = static_cast<int>(a.total < resident ? a.total : resident);
  kern<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int FAM>
int dispatch(Args& a, int B, int dev, cudaStream_t s) {
  // 128-tiles, unless they would leave more than half of the SMs idle:
  // then 64-tiles (4 x 4 per thread), for which the width is a runtime loop
  // (those calls are launch-bound). Device times by tools/time_pairwise.py
  // on an H100 80GB HBM3 at 700 W: 40 128-tiles
  // (the slice's Gram) take 7.0 us, 144 64-tiles 4.7 us; 128 128-tiles (its
  // predict-1024 cross) 6.3 us, 512 64-tiles 8.0 us.
  set_tiles(a, B, 128);
  if (2 * a.total <= sm_count(dev)) {
    set_tiles(a, B, 64);
    return launch<FAM, 0, 64>(a, dev, s);
  }
  switch (a.d) {
    case 1: return launch<FAM, 1, 128>(a, dev, s);
    case 2: return launch<FAM, 2, 128>(a, dev, s);
    case 3: return launch<FAM, 3, 128>(a, dev, s);
    case 4: return launch<FAM, 4, 128>(a, dev, s);
    case 5: return launch<FAM, 5, 128>(a, dev, s);
    case 6: return launch<FAM, 6, 128>(a, dev, s);
    case 7: return launch<FAM, 7, 128>(a, dev, s);
    case 8: return launch<FAM, 8, 128>(a, dev, s);
    case 16: return launch<FAM, 16, 128>(a, dev, s);
    case 32: return launch<FAM, 32, 128>(a, dev, s);
    default: return launch<FAM, 0, 128>(a, dev, s);
  }
}

}  // namespace

// U (B, n1, d), V (B, n2, d), amp (B,), diag_add (B,), out (B, n1, n2):
// contiguous float32 device arrays; diag_add is read only when add_diag is
// set and may be null otherwise. family: 0 power-exponential (alpha = 2),
// 1 Matern-3/2, 2 Matern-5/2. When U and V are the same array (same pointer,
// n1 == n2) only the lower triangle of tiles is computed and mirrored.
// Launches on `stream` (on the current device), does not synchronise, and
// returns cudaGetLastError() after the launch.
extern "C" int madai_pairwise_covariance(const float* U, const float* V,
                                         const float* amp,
                                         const float* diag_add, float* out,
                                         int B, int n1, int n2, int d,
                                         int family, int add_diag,
                                         void* stream) {
  if (B <= 0 || n1 <= 0 || n2 <= 0 || d <= 0 ||
      (add_diag && diag_add == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.U = U;
  a.V = V;
  a.amp = amp;
  a.diag_add = diag_add;
  a.out = out;
  a.n1 = n1;
  a.n2 = n2;
  a.d = d;
  a.add_diag = add_diag;
  a.tri = (U == V && n1 == n2) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kPowerExp: return dispatch<kPowerExp>(a, B, dev, s);
    case kMatern32: return dispatch<kMatern32>(a, B, dev, s);
    case kMatern52: return dispatch<kMatern52>(a, B, dev, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* madai_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
