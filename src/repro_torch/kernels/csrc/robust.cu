// Masked trimmed mean over the (N, P) arena, hand-written for Hopper.
//
// Replaces the TPU kernel of the reference:
//   repro/kernels/robust.py::masked_trimmed_mean_pallas (_masked_trimmed_mean_kernel)
// It computes what that kernel computes, column by column:
//
//   x_i    = m[i] > 0 ? (float) arena[i, p] : +inf      (a select, never a multiply)
//   s      = the column's x sorted ascending; n_v = (int) sum_i m[i]
//   band   = [trim_k, n_v - trim_k)
//   out[p] = (sum of s over the band) / (n_v - 2 trim_k)           if n_v > 2 trim_k
//          = (sum of the live x_i) / max(sum_i m[i], 1)             if n_v > 0
//          = 0                                                      otherwise
//
// Dead rows sort past every finite value, so their garbage (NaN, 1e30) never
// reaches the sum; a cohort too small for the trim (n_v <= 2 trim_k) falls
// back to the untrimmed masked mean, as the reference kernel does.
//
// Bound on the card: reading the arena once, 0.40 ms at the main shape
// (32 x 10,174,464 f32) at 3.35 TB/s.  The work a column needs is a sorting
// network's compare-exchanges (191 for N = 32, a min and a max each) and
// the band's adds, 0.06 ms at the main shape over the 67 TFLOP/s f32 peak,
// so the bytes bound the function.  This kernel's own pace is its min/max
// instructions: 383 FMNMX a column, which the SM issues at one warp
// instruction a clock, 0.47 ms at the main shape at 1.98 GHz, just over the
// bytes (the compare-exchange note below says what was tried).
//
// N <= 64: a sorting network in registers (network_kernel).
//   * One thread per column.  The warp reads the mask once (lane j holds rows
//     j and j + 32) and ballots it into a 64-bit live set; each thread then
//     loads its column's N values once, coalesced along P, with 64-bit row
//     offsets, bf16 widened exactly, and a dead row becomes +inf by a select
//     without its load.  No shared memory and no barrier.
//   * Batcher's odd-even merge sort on NP = N rounded up to a power of two
//     (4 to 64; positions N..NP-1 hold +inf), generated at compile time from
//     the loop nest in network_walk and fully unrolled, so every
//     index is a constant and the column never leaves registers.
//     kernels/robust.py's sorting_network is the same loop nest, held to the
//     0-1 principle and to the counts 5, 19, 63, 191, 543 by the CPU tests.
//   * The compare-exchange is fminf/fmaxf: two FMNMX and no predicate.  The
//     min/max pipe sets the kernel's pace (one FMNMX a clock an SM: 383 of
//     them a column take 0.45-0.48 ms at the main shape on an H100 SXM at
//     700 W, over the bytes' 0.40 ms), so every instruction a row adds
//     shows: a select pair (a compare and two selects) ran at 0.58 ms,
//     integer keys with IMNMX at 0.59-0.64 ms.  fminf/fmaxf differ from a
//     select pair only on a -0/+0 pair, where they may return the same zero
//     twice; that can change only the sign of a sum of zeros.  They would
//     drop a NaN: no valid row carries one on the federation's paths (the
//     admission screen rejects non-finite uploads), and dead rows are +inf
//     here.  The kernel still agrees with the sort on one: a plain sum of the
//     loaded column (an FADD a row, off the min/max pipe; 1% in time) is NaN
//     exactly when a live row holds NaN or +inf meets -inf, and that column
//     alone is recomputed by rank (nan_aware_mean), NaN last as the sort
//     puts it.
//   * The band is summed in sorted order with constant register indices;
//     n_v and trim_k are the same for every thread, so its predicates do not
//     diverge.  The sum is never total minus extremes: under the `scale`
//     byzantine fate the extremes are orders of magnitude larger than the
//     band and would cancel its bits.  The degenerate fallback sums
//     s[0 : n_live), the live rows being the smallest positions.
//   * The plain sort-then-trim adds the same values in the same order, up
//     to the torch reduction's own grouping, so the two agree to float
//     rounding.
//
// N > 64: a rank-select (rank_select_kernel).
//   * One thread per column, which stages its column (+inf for dead rows,
//     bf16 widened) in shared memory at [row * T + thread] and ranks every
//     row against every other, 8 rows at a time in registers: N^2
//     compare-and-count pairs a column.  Ties go to the lower row, so the
//     ranks are a permutation; the band is summed in row order.
//   * The block width T (256 down to 32 columns) is the widest whose N x T
//     tile fits the 227 KB a block may use; where not even one warp's tile
//     fits (N > 1,816), the same kernel reads the rows through L2 instead.
//   * A warp per column for large N is still open (ROADMAP.md, queue 4).
//
// Both write each output once, no atomics: deterministic run to run.
//
// Plain C interface (bound with ctypes): the wrapper allocates the output,
// the kernel runs on the caller's stream and the entry returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kNetworkThreads = 128;
constexpr int kNetworkMaxN = 64;
constexpr int kChunk = 8;  // rank-select: rows whose ranks are taken together
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

// ---------------------------------------------------------------------------
// Batcher's odd-even merge sort on np = 2^t inputs, at compile time
// ---------------------------------------------------------------------------

struct Pair {
  int lo, hi;
};

// Visits the network's compare-exchanges in order; returns how many there
// are, or the index pair of the want-th when want >= 0.
__host__ __device__ constexpr Pair network_walk(int np, int want) {
  int c = 0;
  for (int p = 1; p < np; p <<= 1)
    for (int k = p; k >= 1; k >>= 1)
      for (int j = k % p; j + k < np; j += 2 * k)
        for (int i = 0; i < k && i + j + k < np; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            if (c == want) return Pair{i + j, i + j + k};
            ++c;
          }
  return Pair{c, c};
}

__host__ __device__ constexpr int network_size(int np) { return network_walk(np, -1).lo; }

static_assert(network_size(4) == 5 && network_size(8) == 19 && network_size(16) == 63 &&
                  network_size(32) == 191 && network_size(64) == 543,
              "Batcher's odd-even merge sort: (t^2 - t + 4) 2^(t-2) - 1 compare-exchanges");

template <int A, int B, int NP>
__device__ __forceinline__ void compare_exchange(float (&v)[NP]) {
  const float a = v[A], b = v[B];
  v[A] = fminf(a, b);
  v[B] = fmaxf(a, b);
}

template <int NP, int... I>
__device__ __forceinline__ void sort_network(float (&v)[NP], std::integer_sequence<int, I...>) {
  (compare_exchange<network_walk(NP, I).lo, network_walk(NP, I).hi>(v), ...);
}

// The sort's order with NaN last: an integer key per value, every NaN the
// largest.
__device__ __forceinline__ int nan_last_key(float f) {
  const int b = __float_as_int(f);
  return f != f ? 0x7fffffff : b ^ ((b >> 31) & 0x7fffffff);
}

// The column's result where a live row holds NaN, which fminf/fmaxf would
// drop, or +inf meets -inf: re-read the column and rank each row in the
// sort's order (NaN last, ties to the lower row), the band summed in row
// order; the fallback sums the live rows, NaN and all, as the sort-then-trim
// does.  Never taken on the federation's paths.
template <typename R>
__device__ float nan_aware_mean(const typename R::T* __restrict__ x, int64_t row_stride,
                                uint64_t live, int n, int n_valid, int count, int lo, int hi,
                                float m_sum) {
  if (n_valid <= 0) return 0.0f;
  auto value = [&](int j) {
    return ((live >> j) & 1u) ? R::to_f32(x[j * row_stride]) : CUDART_INF_F;
  };
  float sum = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float xi = value(i);
    if (count > 0) {
      const int ki = nan_last_key(xi);
      int rank = 0;
      for (int j = 0; j < n; ++j) {
        const int kj = nan_last_key(value(j));
        rank += kj < ki || (kj == ki && j < i);
      }
      if (rank >= lo && rank < hi) sum += xi;
    } else if ((live >> i) & 1u) {
      sum += xi;
    }
  }
  return count > 0 ? sum / static_cast<float>(count) : sum / fmaxf(m_sum, 1.0f);
}

template <typename R, int NP>
__global__ void __launch_bounds__(kNetworkThreads)
network_kernel(const typename R::T* __restrict__ arena, int64_t row_stride,
               const float* __restrict__ m, float* __restrict__ out, int n, int64_t p,
               int trim_k) {
  static_assert(NP >= 4 && NP <= kNetworkMaxN && (NP & (NP - 1)) == 0,
                "the network takes a power of two from 4 to 64");
  // The mask, once a warp: lane j reads rows j and j + 32.  Every lane takes
  // part in the ballots, so they come before the early return.
  const int lane = threadIdx.x & 31;
  const float m_lo = lane < n ? __ldg(m + lane) : 0.0f;
  const float m_hi = (NP > 32 && lane + 32 < n) ? __ldg(m + lane + 32) : 0.0f;
  const uint64_t live =
      static_cast<uint64_t>(__ballot_sync(0xffffffffu, m_lo > 0.0f)) |
      (static_cast<uint64_t>(__ballot_sync(0xffffffffu, m_hi > 0.0f)) << 32);
  float m_sum = m_lo + m_hi;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m_sum += __shfl_xor_sync(0xffffffffu, m_sum, off);

  const int64_t col = static_cast<int64_t>(blockIdx.x) * kNetworkThreads + threadIdx.x;
  if (col >= p) return;  // no barrier below: each thread works alone

  // The column in registers; dead rows and the padding positions are +inf.
  const typename R::T* x = arena + col;
  float v[NP];
  float total = 0.0f;  // NaN when a live row holds NaN (or +inf meets -inf)
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    v[j] = ((live >> j) & 1u) ? R::to_f32(x[j * row_stride]) : CUDART_INF_F;
    total += v[j];
  }

  sort_network(v, std::make_integer_sequence<int, network_size(NP)>{});

  // The band, in sorted order; the degenerate cohort sums its live rows.
  const int n_valid = static_cast<int>(m_sum);
  const int count = n_valid - 2 * trim_k;
  const int lo = count > 0 ? trim_k : 0;
  const int hi = count > 0 ? n_valid - trim_k : __popcll(live);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NP; ++i) sum = (i >= lo && i < hi) ? sum + v[i] : sum;
  float result = 0.0f;
  if (count > 0) {
    result = sum / static_cast<float>(count);
  } else if (n_valid > 0) {
    result = sum / fmaxf(m_sum, 1.0f);
  }
  if (total != total) {
    result = nan_aware_mean<R>(x, row_stride, live, n, n_valid, count, lo, hi, m_sum);
  }
  out[col] = result;
}

template <typename R, int NP>
cudaError_t launch_network(const void* arena, int64_t row_stride, const float* m, float* out,
                           int n, int64_t p, int trim_k, cudaStream_t stream) {
  const int64_t blocks = (p + kNetworkThreads - 1) / kNetworkThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  network_kernel<R, NP><<<static_cast<unsigned>(blocks), kNetworkThreads, 0, stream>>>(
      static_cast<const typename R::T*>(arena), row_stride, m, out, n, p, trim_k);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Rank-select for N > 64
// ---------------------------------------------------------------------------

template <typename R, bool kStaged>
__global__ void rank_select_kernel(const typename R::T* __restrict__ arena,
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
cudaError_t launch_rank_select(const void* arena, int64_t row_stride, const float* m,
                               float* out, int n, int64_t p, int trim_k,
                               cudaStream_t stream) {
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
    err = cudaFuncSetAttribute(rank_select_kernel<R, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    rank_select_kernel<R, true><<<grid, width, smem, stream>>>(
        a, row_stride, m, out, n, p, trim_k);
  } else {
    rank_select_kernel<R, false><<<grid, width, 0, stream>>>(
        a, row_stride, m, out, n, p, trim_k);
  }
  return cudaGetLastError();
}

template <typename R>
cudaError_t launch(const void* arena, int64_t row_stride, const float* m, float* out, int n,
                   int64_t p, int trim_k, cudaStream_t stream) {
  if (p == 0) return cudaSuccess;
  if (n <= 4) return launch_network<R, 4>(arena, row_stride, m, out, n, p, trim_k, stream);
  if (n <= 8) return launch_network<R, 8>(arena, row_stride, m, out, n, p, trim_k, stream);
  if (n <= 16) return launch_network<R, 16>(arena, row_stride, m, out, n, p, trim_k, stream);
  if (n <= 32) return launch_network<R, 32>(arena, row_stride, m, out, n, p, trim_k, stream);
  if (n <= kNetworkMaxN) {
    return launch_network<R, 64>(arena, row_stride, m, out, n, p, trim_k, stream);
  }
  return launch_rank_select<R>(arena, row_stride, m, out, n, p, trim_k, stream);
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
