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
// (10,174,464 elements at group 256: 51.0 MB, ~15.2 us each; gemma3-4b's
// 3,879,927,808: 19.46 GB, ~5.81 ms).  Quantize's design:
//   * it reads the unpadded (n,) row and writes the int8 wire layout
//     of the padded (P,) row in one pass: q into the head of one buffer and
//     every group's scale right after it, where the caller used to pad the
//     row (a fill and a copy) and concatenate the wire (a third pass).
//     Elements at n and beyond read as the pad's zeros, so a group past n
//     gets scale 1.0 and q = 0, as the reference's pad gives.
//   * it gives one warp to each group.  Each lane reads 8 consecutive
//     f32 as two 16-byte loads (scalar loads for the one 8-value chunk that
//     straddles n), the warp takes the group's amax with a __shfl_xor
//     butterfly, and each lane writes its 8 int8 as one 8-byte store.  Up to
//     group 256 each lane's 8 values stay in registers from the load to the
//     store; a wider group loops over its chunks twice, the second pass
//     re-reading what the first just brought into L1.
//
// Dequantize writes four bytes for every one it reads, so its stores decide
// its rate.  Its design, against the three faults of its first version (one
// 8-value unit a thread on a grid of one block per 2,048 values; each warp
// store 16 bytes a lane at a 32-byte stride, so every sector was half
// written by each of two instructions; a scale load and a 64-bit divide
// for every 8 values):
//   * a persistent grid: the wrapper sizes it from the card's SM count
//     (kernels/quantize.py, dequant_plan; at most six 256-thread blocks an
//     SM, the kernel's launch bound) so that every warp takes the same
//     number of 2,048-value chunks, and each warp strides over the chunks.
//     The 10m row's 4,968 chunks take one round, one chunk a warp;
//   * a lane loads a chunk's 64 int8 as four 16-byte loads, all in flight
//     before the first is used (each warp load reads 512 contiguous bytes),
//     and puts them in its warp's 2 KB stage in shared memory; the warp then
//     reads the stage back as 4-byte words, lane after lane, so that each
//     lane converts four consecutive values and each warp store writes 512
//     contiguous bytes, 16 a lane (no bank conflict either way).  The
//     values past the last whole chunk (fewer than 2,048, a multiple of 8)
//     go to the warp next in line, four a lane from 4-byte loads;
//   * four values never straddle a group (a group is a multiple of 8), so
//     each store takes one scale.  The group index is 32-bit: the chunk's
//     first group and its offset in it are carried from chunk to chunk by
//     one add and a compare, and each store's group within the chunk is a
//     multiply-high and a shift (division by the invariant group, exact
//     below 2^31).  A lane's first scale of a chunk is loaded with its
//     values; the next only when its group changes, from the line already
//     in L1.  Element offsets stay 64-bit: gemma3-4b's row is past 2^31;
//   * every store streams (st.global.cs, evict-first): the output is
//     written once and read, if at all, by the next kernel.  No L2 holds the
//     serve row's 15.5 GB, and stored with the default policy the 10m row's
//     40.7 MB did not reach the L2 norm that follows it any faster: on the
//     H100, streaming was as fast or faster at both shapes (PERF.md).
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

constexpr int kDqWarps = kThreads / 32;
constexpr int kDqLoads = 4;                       // 16-byte loads a lane per chunk
constexpr int kDqChunkQuads = 32 * 4 * kDqLoads;  // 4-value quads a warp per chunk: 512
constexpr int kDqBlocksPerSm = 6;                 // kernels/quantize.py's DQ_BLOCKS_PER_SM

// Four int8 packed in w, times s: one rounding each, as x * scale is.
__device__ __forceinline__ float4 dequant4(uint32_t w, float s) {
  return make_float4(static_cast<float>(static_cast<int8_t>(w & 0xffu)) * s,
                     static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)) * s,
                     static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu)) * s,
                     static_cast<float>(static_cast<int8_t>(w >> 24)) * s);
}

// Quad i (values 4i .. 4i + 3) lies in group i / g4, g4 = group / 4.  For
// x < 2^31, x / g4 == umulhi(x, magic) >> shift (set by repro_dequantize).
__global__ void __launch_bounds__(kThreads, kDqBlocksPerSm)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  float* __restrict__ out, long long n_chunks, long long n_quads,
                  uint32_t g4, uint32_t magic, uint32_t shift) {
  __shared__ __align__(16) uint32_t stage[kDqWarps][kDqChunkQuads];
  const int lane = threadIdx.x & 31;
  uint32_t* st = stage[threadIdx.x >> 5];
  const long long warp = static_cast<long long>(blockIdx.x) * kDqWarps + (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * kDqWarps;
  const uint4* q16 = reinterpret_cast<const uint4*>(q);
  float4* out16 = reinterpret_cast<float4*>(out);

  // The chunk's first quad q0 = g0 * g4 + r0 (r0 < g4), carried over the
  // stride; the first quad and the stride are below 2^31 (the grid is capped).
  const uint32_t first = static_cast<uint32_t>(warp * kDqChunkQuads);
  const uint32_t step = static_cast<uint32_t>(warps * kDqChunkQuads);
  long long g0 = __umulhi(first, magic) >> shift;
  uint32_t r0 = first - static_cast<uint32_t>(g0) * g4;
  const uint32_t step_g = __umulhi(step, magic) >> shift;
  const uint32_t step_r = step - step_g * g4;
  for (long long c = warp; c < n_chunks; c += warps) {
    const long long q0 = c * kDqChunkQuads;
    uint4 v[kDqLoads];
#pragma unroll
    for (int u = 0; u < kDqLoads; ++u) v[u] = __ldg(q16 + q0 / 4 + 32 * u + lane);
    // The first scale travels with the values; later ones hit its line in L1.
    uint32_t gp = __umulhi(r0 + lane, magic) >> shift;
    float s = __ldg(scales + g0 + gp);
    __syncwarp();  // the last chunk's reads of the stage are done
#pragma unroll
    for (int u = 0; u < kDqLoads; ++u) reinterpret_cast<uint4*>(st)[32 * u + lane] = v[u];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4 * kDqLoads; ++j) {
      const uint32_t gl = __umulhi(r0 + 32 * j + lane, magic) >> shift;
      if (gl != gp) {
        s = __ldg(scales + g0 + gl);
        gp = gl;
      }
      __stcs(out16 + q0 + 32 * j + lane, dequant4(st[32 * j + lane], s));
    }
    g0 += step_g;
    r0 += step_r;
    if (r0 >= g4) {
      r0 -= g4;
      ++g0;
    }
  }
  if (warp == n_chunks % warps) {  // the quads past the last whole chunk
    const uint32_t* q4 = reinterpret_cast<const uint32_t*>(q);
    for (long long i = n_chunks * kDqChunkQuads + lane; i < n_quads; i += 32)
      __stcs(out16 + i, dequant4(__ldg(q4 + i), __ldg(scales + i / g4)));
  }
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
// grid: the persistent grid of kernels/quantize.py's dequant_plan (1 when n
// is under one chunk).
extern "C" int repro_dequantize(const void* q, const void* scales, void* out, long long n,
                                int group, int grid, void* stream) {
  if (n < 0 || group < 8 || group % 8 || n % group || !aligned16(q) || !aligned16(out) ||
      reinterpret_cast<uintptr_t>(scales) % 4)
    return cudaErrorInvalidValue;
  // Keeps the kernel's first quad and stride (grid * 4,096 quads) within 2^30.
  if (grid < 1 || grid > (1 << 30) / (kDqWarps * kDqChunkQuads))
    return cudaErrorInvalidConfiguration;
  if (n == 0) return cudaSuccess;
  const uint32_t g4 = static_cast<uint32_t>(group / 4);  // >= 2
  uint32_t log2 = 0;  // ceil(log2(g4))
  while ((1u << log2) < g4) ++log2;
  const uint32_t magic = static_cast<uint32_t>(((1ULL << (31 + log2)) + g4 - 1) / g4);
  const long long n_quads = n / 4;
  const long long n_chunks = n_quads / kDqChunkQuads;
  dequantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), static_cast<float*>(out),
      n_chunks, n_quads, g4, magic, log2 - 1);
  return cudaGetLastError();
}
