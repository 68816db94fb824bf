// Blockwise symmetric int8 quantize and dequantize, hand-written for Hopper.
//
// Replaces the TPU kernels of the reference:
//   repro/kernels/quantize.py::quantize_pallas   (_quant_kernel)
//   repro/kernels/quantize.py::dequantize_pallas (_dequant_kernel)
//
// The (P,) buffer is viewed as (P/group, group) rows, group a multiple of 8.
//   quantize:   scale_g = amax_g > 0 ? amax_g * f32(1/127) : 1
//               q_i     = clip(rint(x_i / scale_g), -127, 127), NaN -> 0
//   dequantize: x_i     = f32(q_i) * scale_g
//
// Both must give the reference's bytes exactly, because the wire carries
// them (repro_torch/kernels/quantize.py says why each rule is what the
// reference executes):
//   * the scale is amax times the f32 constant 1/127 (bits 0x3c010204), not
//     amax / 127;
//   * x / scale is IEEE division (__fdiv_rn; the library is built without
//     --use_fast_math), rounded half to even (rintf);
//   * amax propagates NaN (fmaxf would drop it), and the clip sends NaN to 0
//     (fminf(fmaxf(NaN, -127), 127) would give -127);
//   * subnormal floats count as zero: an element below FLT_MIN in magnitude
//     reads as 0 and a subnormal scale is 0, as XLA computes on the CPU
//     (flush to zero) and the TPU, which has no subnormals.
//
// Bound on the card: both are single streaming passes with a handful of
// operations per element, so HBM bytes bound them:
//   quantize   (4n read + P + 4P/group written) / 3.35 TB/s
//   dequantize (P + 4P/group read + 4P written) / 3.35 TB/s
// (10,174,464 elements at group 256: 51.0 MB, ~15.2 us each).  The design:
//   * quantize reads the unpadded (n,) row and writes the int8 wire layout
//     of the padded (P,) row in one pass: q into the head of one buffer and
//     every group's scale right after it, where the caller used to pad the
//     row (a fill and a copy) and concatenate the wire (a third pass).
//     Elements at n and beyond read as the pad's zeros, so a group past n
//     gets scale 1.0 and q = 0, as the reference's pad gives.
//   * quantize gives one warp to each group.  Each lane reads 8 consecutive
//     f32 as two 16-byte loads (scalar loads for the one 8-value chunk that
//     straddles n), the warp takes the group's amax with a __shfl_xor
//     butterfly, and each lane writes its 8 int8 as one 8-byte store.  Up to
//     group 256 each lane's 8 values stay in registers from the load to the
//     store; a wider group loops over its chunks twice, the second pass
//     re-reading what the first just brought into L1;
//   * dequantize gives each thread 8 consecutive values (one 8-byte load,
//     two 16-byte stores) that lie in one group, so one scale load each.
//
// Plain C interface (bound with ctypes): the wrapper allocates the outputs,
// the kernels run on the caller's stream and each entry returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// float32(1/127), the reference's scale multiplier.
__device__ __forceinline__ float inv127() { return __int_as_float(0x3c010204); }

// Subnormal -> 0 (NaN and inf pass).
__device__ __forceinline__ float daz(float v) { return fabsf(v) < FLT_MIN ? 0.0f : v; }

// max that keeps a NaN from either side.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ uint32_t quant1(float v, float scale) {
  float r = rintf(__fdiv_rn(daz(v), scale));
  r = (r != r) ? 0.0f : fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r))));
}

// One 8-value chunk at x[i0, i0 + 8), zeros at n and beyond.  x is 16-byte
// aligned and i0 a multiple of 8, so a whole chunk is two aligned loads.
__device__ __forceinline__ void load8(const float* __restrict__ x, int64_t n, int64_t i0,
                                      float (&v)[8]) {
  if (i0 + 8 <= n) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + i0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + i0 + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = i0 + j < n ? __ldg(x + i0 + j) : 0.0f;
  }
}

__device__ __forceinline__ float amax8(float amax, const float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = nanmax(amax, fabsf(daz(v[j])));
  return amax;
}

__device__ __forceinline__ void store8(int8_t* __restrict__ q, const float (&v)[8],
                                       float scale) {
  uint2 packed;
  packed.x = quant1(v[0], scale) | (quant1(v[1], scale) << 8) |
             (quant1(v[2], scale) << 16) | (quant1(v[3], scale) << 24);
  packed.y = quant1(v[4], scale) | (quant1(v[5], scale) << 8) |
             (quant1(v[6], scale) << 16) | (quant1(v[7], scale) << 24);
  *reinterpret_cast<uint2*>(q) = packed;
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int64_t n, int8_t* __restrict__ q,
                float* __restrict__ scales, int64_t n_groups, int group) {
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= n_groups) return;  // g is uniform across the warp: it leaves whole
  const int chunks = group >> 3;
  const int64_t base = g * group;

  float v[8];
  float amax = 0.0f;
  if (chunks <= 32) {  // one chunk a lane, kept in registers
    if (lane < chunks) {
      load8(x, n, base + 8 * lane, v);
      amax = amax8(amax, v);
    }
  } else {
    for (int c = lane; c < chunks; c += 32) {
      load8(x, n, base + 8 * c, v);
      amax = amax8(amax, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  float scale = 1.0f;
  if (amax > 0.0f) {
    scale = amax * inv127();
    if (scale < FLT_MIN) scale = 0.0f;
  }

  if (chunks <= 32) {
    if (lane < chunks) store8(q + base + 8 * lane, v, scale);
  } else {
    for (int c = lane; c < chunks; c += 32) {
      load8(x, n, base + 8 * c, v);
      store8(q + base + 8 * c, v, scale);
    }
  }
  if (lane == 0) scales[g] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  float* __restrict__ out, int64_t n_units, int group) {
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (unit >= n_units) return;
  const int64_t i0 = unit * 8;
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(q + i0));
  const float s = __ldg(scales + i0 / group);
  const uint32_t w[2] = {v.x, v.y};
  float f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    f[j] = static_cast<float>(static_cast<int8_t>((w[j >> 2] >> (8 * (j & 3))) & 0xffu)) * s;
  float4* o = reinterpret_cast<float4*>(out + i0);
  o[0] = make_float4(f[0], f[1], f[2], f[3]);
  o[1] = make_float4(f[4], f[5], f[6], f[7]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (n,) f32, read as zeros from n to n_groups * group -> q int8
// (n_groups * group,), scales (n_groups,) f32.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int repro_quantize(const void* x, long long n, void* q, void* scales,
                              long long n_groups, int group, void* stream) {
  if (n_groups < 0 || group < 8 || group % 8 || n < 0 || n > n_groups * group ||
      (n > 0 && !aligned16(x)) || !aligned16(q) || reinterpret_cast<uintptr_t>(scales) % 4)
    return cudaErrorInvalidValue;
  if (n_groups == 0) return cudaSuccess;
  const long long blocks = (n_groups * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  quantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<int8_t*>(q), static_cast<float*>(scales),
      n_groups, group);
  return cudaGetLastError();
}

// q (n,) int8, scales (n/group,) f32 -> out (n,) f32; n a multiple of group.
extern "C" int repro_dequantize(const void* q, const void* scales, void* out, long long n,
                                int group, void* stream) {
  if (n < 0 || group < 8 || group % 8 || n % group || !aligned16(q) || !aligned16(out))
    return cudaErrorInvalidValue;
  const long long units = n / 8;
  if (units == 0) return cudaSuccess;
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dequantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), units, group);
  return cudaGetLastError();
}
