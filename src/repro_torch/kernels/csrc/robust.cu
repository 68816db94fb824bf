// Masked trimmed mean over the (N, P) arena, hand-written for Hopper.
//
// Replaces the TPU kernel of the reference:
//   repro/kernels/robust.py::masked_trimmed_mean_pallas (_masked_trimmed_mean_kernel)
// It computes what that kernel computes, column by column:
//
//   x_i    = m[i] > 0 ? (float) arena[i, p] : +inf      (a select, never a multiply)
//   n_v    = sum_i m[i]
//   rank_i = #{j : x_j < x_i} + #{j < i : x_j == x_i}    (ties to the lower row,
//                                                        so ranks are a permutation)
//   band   = trim_k <= rank_i < n_v - trim_k
//   out[p] = (sum of the band's x_i, in row order) / max(count, 1)   if count > 0
//          = (sum_i (m[i] > 0 ? x_i : 0), in row order) / max(n_v, 1) if n_v > 0
//          = 0                                                        otherwise
//
// Dead rows rank past every finite value, so their garbage (NaN, 1e30) never
// reaches the sum; a cohort too small for the trim (n_v <= 2 trim_k) falls
// back to the untrimmed masked mean, as the reference kernel does.
//
// Bound on the card: the function needs per column no more than a sorting
// network's compare-exchanges (191 for N = 32, a min and a max each) and the
// band's adds, 0.06 ms at the main shape (32 x 10,174,464 f32) over the
// H100's 67 TFLOP/s, under the 0.40 ms it takes to read the arena once at
// 3.35 TB/s: the bound is the bytes'.  This rank-select does more work, N^2
// compare-and-count pairs per column, two FP32 instructions each: 2.1e10 at
// the main shape, 0.62 ms at the FP32 pipes' issue rate of 33.5 T/s.  The
// design is the simple one that is right:
//   * one thread per column, so no thread ever reads another's data and the
//     block needs no barrier;
//   * each thread stages its column's N values (+inf for dead rows, bf16
//     widened to f32) in shared memory at [row * T + thread], so the N^2
//     re-reads come from shared memory without bank conflicts, and the
//     arena is read from device memory exactly once, coalesced along P;
//   * the block width T (256 down to 32 columns) is the widest whose N x T
//     tile fits the 227 KB a block may use; where not even one warp's tile
//     fits (N > 1,816), the same kernel reads the rows through L2 instead;
//   * ranks are taken for 8 rows at a time held in registers, so each
//     shared-memory load serves 8 compares; the band's sum and count stay in
//     registers, rows in fixed order, no atomics: the output is
//     deterministic run to run.
// It sums the band in row order where the plain sort-then-trim sums in
// sorted order, so the two agree to float rounding (about 1e-7 relative),
// not bit for bit.
//
// Plain C interface (bound with ctypes): the wrapper allocates the output,
// the kernel runs on the caller's stream and the entry returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;  // rows whose ranks are taken together, in registers
constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 32;
constexpr int kUnstagedThreads = 128;

struct F32 {
  using T = float;
  __device__ static float to_f32(float x) { return x; }
};

struct BF16 {
  using T = uint16_t;
  __device__ static float to_f32(uint16_t x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
};

template <typename R, bool kStaged>
__global__ void trimmed_mean_kernel(const typename R::T* __restrict__ arena,
                                    int64_t row_stride, const float* __restrict__ m,
                                    float* __restrict__ out, int n, int64_t p,
                                    int trim_k) {
  extern __shared__ float tile[];  // [n][blockDim.x] when kStaged
  const int t = threadIdx.x;
  const int width = blockDim.x;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * width + t;
  if (col >= p) return;  // no barrier below: each thread works alone
  const typename R::T* x_col = arena + col;

  // The column's values, dead rows as +inf.
  auto load = [&](int j) {
    return __ldg(m + j) > 0.0f ? R::to_f32(x_col[j * row_stride]) : CUDART_INF_F;
  };
  float n_valid = 0.0f;
  if constexpr (kStaged) {
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      tile[j * width + t] = load(j);
      n_valid += __ldg(m + j);
    }
  } else {
    for (int j = 0; j < n; ++j) n_valid += __ldg(m + j);
  }
  auto value = [&](int j) {
    if constexpr (kStaged) {
      return tile[j * width + t];
    } else {
      return load(j);
    }
  };

  const float lo = static_cast<float>(trim_k);
  const float hi = n_valid - static_cast<float>(trim_k);
  float sum = 0.0f, count = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    const int len = min(kChunk, n - i0);
    float xi[kChunk];
    int rank[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      xi[k] = k < len ? value(i0 + k) : 0.0f;
      rank[k] = 0;
    }
    // Rows before the chunk are lower rows of every row in it: a tie counts.
    for (int j = 0; j < i0; ++j) {
      const float xj = value(j);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) rank[k] += xj <= xi[k];
    }
    // Rows inside the chunk: a tie counts only for a lower row.
    for (int j = i0; j < i0 + len; ++j) {
      const float xj = value(j);
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        rank[k] += (j < i0 + k) ? (xj <= xi[k]) : (xj < xi[k]);
    }
    // Rows after the chunk are higher rows: strictly smaller values only.
    for (int j = i0 + len; j < n; ++j) {
      const float xj = value(j);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) rank[k] += xj < xi[k];
    }
    // The band's sum and count, in row order.
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float r = static_cast<float>(rank[k]);
      const bool in_band = k < len && r >= lo && r < hi;
      sum = in_band ? sum + xi[k] : sum;
      count = in_band ? count + 1.0f : count;
    }
  }

  float result;
  if (count > 0.0f) {
    result = sum / fmaxf(count, 1.0f);
  } else if (n_valid > 0.0f) {
    // Degenerate cohort: the untrimmed masked mean of the valid rows.
    float fb = 0.0f;
    for (int j = 0; j < n; ++j) fb = __ldg(m + j) > 0.0f ? fb + value(j) : fb;
    result = fb / fmaxf(n_valid, 1.0f);
  } else {
    result = 0.0f;
  }
  out[col] = result;
}

template <typename R>
cudaError_t launch(const void* arena, int64_t row_stride, const float* m, float* out,
                   int n, int64_t p, int trim_k, cudaStream_t stream) {
  if (p == 0) return cudaSuccess;
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // The widest block whose (n x width) f32 tile fits the block's shared memory.
  int width = kMaxThreads;
  while (width > kMinThreads &&
         static_cast<int64_t>(n) * width * 4 > static_cast<int64_t>(smem_max)) {
    width /= 2;
  }
  const bool staged = static_cast<int64_t>(n) * width * 4 <= static_cast<int64_t>(smem_max);
  if (!staged) width = kUnstagedThreads;
  const int64_t blocks = (p + width - 1) / width;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const auto* a = static_cast<const typename R::T*>(arena);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (staged) {
    const int smem = n * width * 4;
    err = cudaFuncSetAttribute(trimmed_mean_kernel<R, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    trimmed_mean_kernel<R, true><<<grid, width, smem, stream>>>(
        a, row_stride, m, out, n, p, trim_k);
  } else {
    trimmed_mean_kernel<R, false><<<grid, width, 0, stream>>>(
        a, row_stride, m, out, n, p, trim_k);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 rows, 1 = bfloat16 rows.  Needs 0 <= trim_k and
// 2 * trim_k < n (the wrapper raises the reference's ValueError first).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_trimmed_mean(const void* arena, int dtype, long long row_stride,
                                  const void* mask, void* out, int n, long long p,
                                  int trim_k, void* stream) {
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n < 1 || p < 0 || row_stride < p || trim_k < 0 || 2LL * trim_k >= n) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0: return launch<F32>(arena, row_stride, m, o, n, p, trim_k, s);
    case 1: return launch<BF16>(arena, row_stride, m, o, n, p, trim_k, s);
    default: return cudaErrorInvalidValue;
  }
}
