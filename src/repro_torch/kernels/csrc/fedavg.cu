// Masked weighted FedAvg over the (N, P) arena, hand-written for Hopper.
//
// Replaces the TPU kernels of the reference:
//   repro/kernels/fedavg.py::masked_fedavg_pallas (_masked_fedavg_kernel)
//   repro/kernels/fedavg.py::fedavg_pallas        (_fedavg_kernel)
// One kernel serves both, templated on the row type (f32, bf16) and on
// whether a validity mask is given.
//
//   out[p] = sum_n  w_hat[n] * (mask ? (m[n] > 0 ? x[n, p] : 0) : x[n, p])
//
// w_hat is the normalized (N,) weight vector, computed on the device by the
// Python wrapper (repro_torch/kernels/fedavg.py); the kernel does the (N, P)
// pass.  Accumulation is f32 in registers, over n = 0..N-1 in a fixed order,
// with no atomics, so the result is deterministic run to run.
//
// Bound on the card: the pass does 2 FLOP per element read (about 0.5 FLOP
// per byte for f32), far below the H100's ~20 FLOP/byte ridge for f32 CUDA
// cores, so it is bound by HBM bandwidth:
//   t >= (N * P * sizeof(row) + 4 * P) / 3.35 TB/s
// (32 learners x 10,174,464 f32 columns: ~0.39 ms).  The design is therefore
// a single streaming pass that reads every valid arena byte exactly once:
//   * each thread owns VEC consecutive columns and reads them with one
//     16-byte load per row (4 f32 or 8 bf16), neighbouring threads on
//     neighbouring addresses, so every warp issues fully coalesced 512-byte
//     requests;
//   * rows go in batches of 8 whose loads are all issued before the first is
//     used, so eight 16-byte loads per thread are in flight at once (a
//     branch per row would leave one in flight and run latency-bound);
//   * w_hat and m are staged in shared memory when N <= 1024 (8 KB), and read
//     through the read-only cache otherwise;
//   * a dead row (m[n] <= 0) is excluded by a select, acc = live ? fma : acc,
//     never by a multiply, so NaN in it cannot leak into the sum;
//   * the arena is read in place at its padded width (row stride passed in);
//     the caller slices [:num_params].  A scalar path covers a ragged tail and
//     any pointer or stride that is not 16-byte aligned; the arena's
//     1024-aligned rows never take it.
//
// Plain C interface (bound with ctypes): the wrapper allocates the output,
// the kernel runs on the caller's stream and the entry returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemRows = 1024;
constexpr int kRowBatch = 8;

// Row element types: float, or bf16 held as its raw 16 bits.
struct F32 {
  using T = float;
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static float to_f32(float x) { return x; }
  __device__ static void unpack(const uint4& v, float (&x)[kVec]) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
};

struct BF16 {
  using T = uint16_t;
  static constexpr int kVec = 8;
  __device__ static float to_f32(uint16_t x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  // Little-endian: element 2k is the low half of word k.
  __device__ static void unpack(const uint4& v, float (&x)[kVec]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

template <typename R, bool kMasked>
__global__ void __launch_bounds__(kThreads)
fedavg_kernel(const typename R::T* __restrict__ arena, int64_t row_stride,
              const float* __restrict__ w, const float* __restrict__ m,
              float* __restrict__ out, int n, int64_t p, int64_t n_vec) {
  constexpr int kVec = R::kVec;
  __shared__ float s_w[kSmemRows];
  __shared__ float s_m[kSmemRows];
  const bool staged = n <= kSmemRows;
  if (staged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_w[i] = w[i];
      s_m[i] = kMasked ? m[i] : 1.0f;
    }
  }
  __syncthreads();

  auto weight = [&](int r) { return staged ? s_w[r] : __ldg(w + r); };
  auto live = [&](int r) {
    return !kMasked || (staged ? s_m[r] : __ldg(m + r)) > 0.0f;
  };
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t tail = p - n_vec * kVec;
  if (unit < n_vec) {
    // Vector path: columns [unit*kVec, unit*kVec + kVec).  Rows go in
    // batches of kRowBatch whose loads are all issued before any is used,
    // so kRowBatch 16-byte loads per thread are in flight at once.
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
    const typename R::T* col = arena + unit * kVec;
    auto fold = [&](const uint4& v, int r) {
      float x[kVec];
      R::unpack(v, x);
      const float wr = weight(r);
      const bool ok = live(r);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = ok ? fmaf(wr, x[j], acc[j]) : acc[j];
    };
    int r = 0;
    for (; r + kRowBatch <= n; r += kRowBatch) {
      uint4 v[kRowBatch];
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k)
        v[k] = __ldg(reinterpret_cast<const uint4*>(col + (r + k) * row_stride));
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) fold(v[k], r + k);
    }
    for (; r < n; ++r) fold(__ldg(reinterpret_cast<const uint4*>(col + r * row_stride)), r);
    float* o = out + unit * kVec;
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      reinterpret_cast<float4*>(o)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  } else if (unit < n_vec + tail) {
    // Scalar path: one column of the ragged tail (or of an unaligned input).
    const int64_t c = n_vec * kVec + (unit - n_vec);
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) {
      const float x = R::to_f32(arena[r * row_stride + c]);
      acc = live(r) ? fmaf(weight(r), x, acc) : acc;
    }
    out[c] = acc;
  }
}

template <typename R>
cudaError_t launch(const void* arena, int64_t row_stride, const float* w,
                   const float* m, float* out, int n, int64_t p,
                   cudaStream_t stream) {
  constexpr int kVec = R::kVec;
  const bool aligned =
      reinterpret_cast<uintptr_t>(arena) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
      (row_stride * static_cast<int64_t>(sizeof(typename R::T))) % 16 == 0;
  const int64_t n_vec = aligned ? p / kVec : 0;
  const int64_t units = n_vec + (p - n_vec * kVec);
  const int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const auto* a = static_cast<const typename R::T*>(arena);
  if (m != nullptr) {
    fedavg_kernel<R, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        a, row_stride, w, m, out, n, p, n_vec);
  } else {
    fedavg_kernel<R, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        a, row_stride, w, m, out, n, p, n_vec);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 rows, 1 = bfloat16 rows.  mask may be NULL (unmasked).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_fedavg(const void* arena, int dtype, long long row_stride,
                            const void* weights, const void* mask, void* out,
                            int n, long long p, void* stream) {
  const auto* w = static_cast<const float*>(weights);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n < 1 || p < 0 || row_stride < p) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<F32>(arena, row_stride, w, m, o, n, p, s);
    case 1: return launch<BF16>(arena, row_stride, w, m, o, n, p, s);
    default: return cudaErrorInvalidValue;
  }
}
