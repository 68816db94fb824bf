// Fused dequant-into-aggregate over the int8-resident arena, hand-written for
// Hopper.
//
// Replaces the TPU kernel of the reference:
//   repro/kernels/fused_agg.py::masked_fedavg_q8_pallas (_masked_fedavg_q8_kernel)
//
//   out[p] = sum_n  w_hat[n] * (m[n] > 0 ? q[n, p] * s[n, p / group] : 0)
//
// in the reference's arithmetic: each value is dequantized to f32 first
// (q * s, rounded), then folded into the sum with one FMA per row,
// acc = fma(w_hat[n], q * s, acc).
//
// q is the (N, P) int8 arena, s its (N, P/group) f32 group scales, w_hat the
// normalized (N,) weight vector (computed on the device by the Python
// wrapper, repro_torch/kernels/fused_agg.py).  One pass over the quantized
// bytes: the f32 (N, P) stack is never built.  Accumulation is f32 in
// registers over n = 0..N-1 in a fixed order, with no atomics, so the result
// is deterministic run to run.
//
// Bound on the card: 3 FLOP per int8 byte read (the dequantizing multiply
// and the FMA), far below the ridge, so HBM bytes bound it:
//   t >= (N*P + 4*N*P/group + 4*P + 8*N) / 3.35 TB/s
// (32 x 10,174,464 at group 256: 371.4 MB, ~111 us).  The design:
//   * each thread owns kVec consecutive columns (16, or 8 when the group is
//     not a multiple of 16) and reads each row's with one 16-byte (8-byte)
//     load; the columns lie in one group, so there is one scale per row per
//     thread.  The weight is not folded into the scale (w_hat * s once per
//     row would save a multiply per value): that rounds differently from
//     dequantize-then-reduce and put 8 of 10,174,464 outputs 2e-5 away from
//     the plain version on the card;
//   * int8 -> f32 without the I2F unit, whose rate is a small fraction of
//     the FMA rate: flipping each byte's sign bit gives v + 128 in 0..255,
//     __byte_perm places it in the mantissa of 2^23, and subtracting
//     2^23 + 128 leaves v exactly (one PRMT and one FADD per value);
//   * rows go in batches of 8 whose loads (values and scale) are all issued
//     before any is used, so 8 loads per thread are in flight at once;
//   * a dead row (m[n] <= 0) is excluded by a select, acc = live ? fma : acc,
//     never by a multiply, so a NaN or 1e30 scale in it cannot leak;
//   * w_hat and m are staged in shared memory when N <= 1024.
// P is a multiple of the group (the scales' shape says so), so there is no
// ragged tail.
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

// int8 byte k of w (sign bit already flipped) as an exact float.
__device__ __forceinline__ float byte_to_f32(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | k)) - 8388736.0f;
}

struct V16 {
  using L = uint4;
  static constexpr int kVec = 16;
  __device__ static L load(const int8_t* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static void unpack(const L& v, float (&x)[kVec]) {
    const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                           v.w ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = byte_to_f32(w[j >> 2], j & 3);
  }
};

struct V8 {
  using L = uint2;
  static constexpr int kVec = 8;
  __device__ static L load(const int8_t* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ static void unpack(const L& v, float (&x)[kVec]) {
    const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = byte_to_f32(w[j >> 2], j & 3);
  }
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
fedavg_q8_kernel(const int8_t* __restrict__ q, int64_t q_stride,
                 const float* __restrict__ s, int64_t s_stride,
                 const float* __restrict__ w, const float* __restrict__ m,
                 float* __restrict__ out, int n, int64_t n_units, int group) {
  constexpr int kVec = V::kVec;
  __shared__ float s_w[kSmemRows];
  __shared__ float s_m[kSmemRows];
  const bool staged = n <= kSmemRows;
  if (staged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_w[i] = w[i];
      s_m[i] = m[i];
    }
  }
  __syncthreads();
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (unit >= n_units) return;

  auto weight = [&](int r) { return staged ? s_w[r] : __ldg(w + r); };
  auto live = [&](int r) { return (staged ? s_m[r] : __ldg(m + r)) > 0.0f; };
  const int64_t col = unit * kVec;
  const int8_t* qc = q + col;
  const float* sc = s + col / group;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  auto fold = [&](const typename V::L& v, float scale, int r) {
    float x[kVec];
    V::unpack(v, x);
    const float wr = weight(r);
    const bool ok = live(r);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = ok ? fmaf(wr, x[j] * scale, acc[j]) : acc[j];
  };
  int r = 0;
  for (; r + kRowBatch <= n; r += kRowBatch) {
    typename V::L v[kRowBatch];
    float sv[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      v[k] = V::load(qc + (r + k) * q_stride);
      sv[k] = __ldg(sc + (r + k) * s_stride);
    }
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) fold(v[k], sv[k], r + k);
  }
  for (; r < n; ++r) fold(V::load(qc + r * q_stride), __ldg(sc + r * s_stride), r);

  float4* o = reinterpret_cast<float4*>(out + col);
#pragma unroll
  for (int j = 0; j < kVec / 4; ++j)
    o[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
}

template <typename V>
cudaError_t launch(const int8_t* q, int64_t q_stride, const float* s, int64_t s_stride,
                   const float* w, const float* m, float* out, int n, int64_t p, int group,
                   cudaStream_t stream) {
  const int64_t units = p / V::kVec;
  const int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fedavg_q8_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      q, q_stride, s, s_stride, w, m, out, n, units, group);
  return cudaGetLastError();
}

}  // namespace

// q (N, P) int8 with row stride q_stride (elements), s (N, P/group) f32 with
// row stride s_stride, w_hat and mask (N,) f32, out (P,) f32.  P and both
// strides must be multiples of the group, the group a multiple of 8, and q
// and out 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int repro_fedavg_q8(const void* q, long long q_stride, const void* scales,
                               long long s_stride, const void* weights, const void* mask,
                               void* out, int n, long long p, int group, void* stream) {
  const auto* qq = static_cast<const int8_t*>(q);
  const auto* ss = static_cast<const float*>(scales);
  const auto* w = static_cast<const float*>(weights);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (n < 1 || p < 0 || group < 8 || group % 8 || p % group || q_stride < p ||
      q_stride % group || s_stride < p / group ||
      reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (group % 16 == 0) return launch<V16>(qq, q_stride, ss, s_stride, w, m, o, n, p, group, st);
  return launch<V8>(qq, q_stride, ss, s_stride, w, m, o, n, p, group, st);
}
