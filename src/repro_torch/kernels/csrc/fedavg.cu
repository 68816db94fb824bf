// Masked weighted FedAvg over the (N, P) arena, hand-written for Hopper.
//
// Replaces the TPU kernels of the reference:
//   repro/kernels/fedavg.py::masked_fedavg_pallas (_masked_fedavg_kernel)
//   repro/kernels/fedavg.py::fedavg_pallas        (_fedavg_kernel)
// One kernel serves both, templated on the row type (f32, bf16); the mask is
// optional.
//
//   out[p] = sum over live n, ascending, of  w_hat[n] * x[n, p]
//
// with w_hat normalized inside the kernel exactly as the wrapper's plain
// versions do (repro_torch/kernels/fedavg.py):
//   masked:   w*m / sum(w*m) when that sum is > 0, else m / max(sum(m), 1);
//   unmasked: w / sum(w)     when that sum is > 0, else 1/N;
// and live meaning m > 0 (every row when unmasked).  Accumulation is f32 in
// registers with fmaf, over live rows in ascending order, with no atomics, so
// two launches on the same inputs are bit-identical.
//
// Bound on the card: 2 FLOP per element read (about 0.5 FLOP per byte for
// f32), far below the H100's f32 ridge, so the pass is bound by HBM:
//   t >= (N * P * sizeof(row) + 4 * P) / 3.35 TB/s
// which for 32 learners x 10,174,464 f32 columns is 0.4009 ms (the bound
// chip_smoke.py counts; it adds the 8N bytes of weights and mask).  The
// design spends its effort on keeping HBM busy with only the bytes that
// bound counts, in one launch:
//   * one launch per aggregate: every block sums w*m (or w) in one fixed
//     order (strided partials, a fixed shuffle tree, warps summed in order),
//     so every block holds the same w_hat bit for bit, and stages w_hat and
//     the ascending list of live rows in shared memory.  Up to kStageCap
//     (2,048) rows are staged; past that the producer reads the mask and weights
//     from global memory (L1-resident) and finds live rows by warp ballots,
//     tile by tile, with the same arithmetic;
//   * bytes arrive by cp.async.bulk into a 3-stage ring in shared memory: a
//     persistent grid of blocks walks 32 KB column tiles (of each row);
//     one producer lane issues one bulk copy per live row into the next
//     stage, a 32 KB slot, and posts its bytes on the stage's full
//     mbarrier; eight consumer warps wait on it, fold the row into f32
//     registers and release the stage on its empty mbarrier.  Up to 96 KB
//     per block are in flight without a register holding any of them, and
//     dead rows are never loaded, so the bytes read scale with the live
//     rows;
//   * aligned windows serve unaligned rows: a bulk copy needs 16-byte-aligned
//     source, destination and size, so each (row, tile) copies the window
//     that covers the tile, its start rounded down to 128 bytes and its end
//     up to 16, clipped to the view's extent.  The window lands in its slot
//     at the same offset mod 128 as in global memory, so source and
//     destination are both 128-byte aligned (unless clipped), and the tile
//     is read in shared memory at the row's byte offset delta < 128
//     (4 * (r mod 4) mod 16 for the stack leg's 10,174,081-float rows) by a
//     funnel shift of two 16-byte words.  What the clip cuts off (under 16
//     bytes at either edge) the producer loads with plain loads into the
//     same slot.  This one path serves aligned and unaligned strides, f32
//     and bf16, and a view whose data_ptr is not 16-byte aligned;
//     tile_window() in fedavg.py is the same arithmetic, and the CPU tests
//     hold it to exactly-once coverage;
//   * the output is written with 16-byte stores, a ragged last unit with
//     scalar ones.
// The launch plan is fixed (32 KB tiles, 3 stages, 2 blocks per SM, chosen
// by measurement on the card: PERF.md); fedavg.py's launch_plan() sizes the
// grid and the dynamic shared memory, and this file refuses any other tile,
// stage count or shared memory than Layout below.
//
// Plain C interface (bound with ctypes): the wrapper allocates the output,
// the kernel runs on the caller's stream and the entry returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr int kConsumers = 256;                 // 8 consumer warps
constexpr int kThreads = kConsumers + 32;       // + 1 producer warp (warp 0)
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 32768;               // fedavg.py TILE_BYTES, of each row
constexpr int kUnits = kTileBytes / (16 * kConsumers);  // 16-byte units per consumer
constexpr int kStages = 3;                      // fedavg.py STAGES
constexpr int kSlotBytes = kTileBytes + 128;    // a window starts up to 112 bytes early
constexpr int kStageCap = 2048;                 // fedavg.py STAGE_CAP
constexpr int kMiscBytes = 512;                 // fedavg.py _MISC_BYTES

using u64 = unsigned long long;  // byte addresses
__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// Row element types: float, or bf16 held as its raw 16 bits.
struct F32 {
  using T = uint32_t;
  static constexpr int kVec = 4;  // elements per 16 bytes
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

// Dynamic shared memory, in this order (fedavg.py smem_bytes()): the ring's
// slots, each slot's weight and byte offset, a full and an empty barrier per
// stage, misc (floats 0-50: warp partials and the sums), then (staged) w_hat
// and the live list.
struct Layout {
  int64_t hw, hd, bars, misc, what, live, total;
};

__host__ __device__ inline Layout layout(int n, bool staged) {
  Layout l;
  l.hw = static_cast<int64_t>(kStages) * kSlotBytes;
  l.hd = l.hw + 4 * kStages;
  l.bars = l.hd + 4 * kStages;
  l.misc = l.bars + 16 * kStages;
  l.what = l.misc + kMiscBytes;
  l.live = l.what + (staged ? 4LL * n : 0);
  l.total = l.live + (staged ? 4LL * n : 0);
  return l;
}

struct Params {
  u64 base;                 // arena data_ptr
  int64_t row_bytes;        // row stride in bytes
  int esize;                // bytes per element
  const float* w;
  const float* m;           // nullptr when unmasked
  float* out;
  int n;
  int64_t p;
  int64_t tile_cols;
  int64_t n_tiles;
  bool staged;
  u64 lo, hi;               // the view's extent: first byte, one past the last
};

// One row's window of one tile (fedavg.py tile_window, the same arithmetic).
struct Window {
  u64 a, b, src, head_end, tail_start;
  uint32_t nbytes, dst, delta;
};

__device__ __forceinline__ Window tile_window(const Params& q, int row, int64_t c0,
                                              int64_t c1) {
  Window v;
  v.a = q.base + static_cast<u64>(row * q.row_bytes + c0 * q.esize);
  v.b = q.base + static_cast<u64>(row * q.row_bytes + c1 * q.esize);
  const u64 origin = v.a & ~127ull;  // the slot's first byte maps here
  const u64 ws = umax(origin, (q.lo + 15) & ~15ull);
  const u64 we = umax(umin((v.b + 15) & ~15ull, q.hi & ~15ull), ws);
  v.src = ws;
  v.nbytes = static_cast<uint32_t>(we - ws);
  v.dst = static_cast<uint32_t>(ws - origin);
  v.delta = static_cast<uint32_t>(v.a - origin);
  v.head_end = umin(umax(ws, v.a), v.b);
  v.tail_start = umin(umax(we, v.a), v.b);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, u64 src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 16 bytes that start `delta` bytes into s[0..1] (delta < 16).
__device__ __forceinline__ uint4 shifted(const uint4* s, uint32_t delta) {
  const uint4 lo = s[0];
  if (delta == 0) return lo;
  const uint4 hi = s[1];
  const uint32_t k = (delta & 3) * 8;
#define FS(x, y) __funnelshift_r((x), (y), k)
  switch (delta >> 2) {
    case 0: return make_uint4(FS(lo.x, lo.y), FS(lo.y, lo.z), FS(lo.z, lo.w), FS(lo.w, hi.x));
    case 1: return make_uint4(FS(lo.y, lo.z), FS(lo.z, lo.w), FS(lo.w, hi.x), FS(hi.x, hi.y));
    case 2: return make_uint4(FS(lo.z, lo.w), FS(lo.w, hi.x), FS(hi.x, hi.y), FS(hi.y, hi.z));
    default: return make_uint4(FS(lo.w, hi.x), FS(hi.x, hi.y), FS(hi.y, hi.z), FS(hi.z, hi.w));
  }
#undef FS
}

// w_hat of row i, from the block's sums (the same expression staged or not).
__device__ __forceinline__ float weight_hat(const Params& q, int i, float total, float msum) {
  const float wi = __ldg(q.w + i);
  const float mi = q.m ? __ldg(q.m + i) : 1.0f;
  const float x = q.m ? __fmul_rn(wi, mi) : wi;
  if (total > 0.0f) return __fdiv_rn(x, total);
  // torch.clamp(sum(m), min=1): a NaN sum stays NaN (fmaxf would drop it).
  return q.m ? __fdiv_rn(mi, msum < 1.0f ? 1.0f : msum) : static_cast<float>(1.0 / q.n);
}

__device__ __forceinline__ bool row_live(const Params& q, int i) {
  return i < q.n && (q.m == nullptr || __ldg(q.m + i) > 0.0f);
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
fedavg_kernel(const Params q) {
  constexpr int kVec = R::kVec;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(q.n, q.staged);
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kStages;
  float* s_hw = reinterpret_cast<float*>(smem + lay.hw);
  uint32_t* s_hd = reinterpret_cast<uint32_t*>(smem + lay.hd);
  float* misc = reinterpret_cast<float*>(smem + lay.misc);
  int* misc_i = reinterpret_cast<int*>(misc);
  float* s_what = reinterpret_cast<float*>(smem + lay.what);
  int* s_live = reinterpret_cast<int*>(smem + lay.live);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 1);                  // the producer lane arrives
      bar_init(empty + s, kConsumers / 32);   // one lane per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Sums in one fixed order: strided partials, a fixed shuffle tree, warps
  // in order.  The same in every block, so every block's w_hat is the same.
  float sx = 0.0f, sm = 0.0f;
  int live = 0;
  for (int i = threadIdx.x; i < q.n; i += kThreads) {
    const float wi = __ldg(q.w + i);
    if (q.m) {
      const float mi = __ldg(q.m + i);
      sx = __fadd_rn(sx, __fmul_rn(wi, mi));
      sm = __fadd_rn(sm, mi);
      live += mi > 0.0f;
    } else {
      sx = __fadd_rn(sx, wi);
      live += 1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sx = __fadd_rn(sx, __shfl_xor_sync(0xffffffffu, sx, off));
    sm = __fadd_rn(sm, __shfl_xor_sync(0xffffffffu, sm, off));
    live += __shfl_xor_sync(0xffffffffu, live, off);
  }
  if (lane == 0) {
    misc[warp] = sx;
    misc[16 + warp] = sm;
    misc_i[32 + warp] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f, u = 0.0f;
    int l = 0;
    for (int k = 0; k < kWarps; ++k) {
      t = __fadd_rn(t, misc[k]);
      u = __fadd_rn(u, misc[16 + k]);
      l += misc_i[32 + k];
    }
    misc[48] = t;
    misc[49] = u;
    misc_i[50] = l;
  }
  __syncthreads();
  const float total = misc[48], msum = misc[49];
  const int n_live = misc_i[50];
  if (q.staged) {
    for (int i = threadIdx.x; i < q.n; i += kThreads) s_what[i] = weight_hat(q, i, total, msum);
    if (warp == 0) {  // the ascending live list, 32 rows a ballot
      int count = 0;
      for (int base = 0; base < q.n; base += 32) {
        const bool f = row_live(q, base + lane);
        const uint32_t b = __ballot_sync(0xffffffffu, f);
        if (f) s_live[count + __popc(b & ((1u << lane) - 1u))] = base + lane;
        count += __popc(b);
      }
    }
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer: lane 0 fills one stage per live row of each tile; ----
    // ---- unstaged, the whole warp finds the next live row by ballots  ----
    if (q.staged && lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t tile = blockIdx.x; tile < q.n_tiles; tile += gridDim.x) {
      const int64_t c0 = tile * q.tile_cols;
      const int64_t c1 = min(c0 + q.tile_cols, q.p);
      int row = -1;
      for (int k = 0; k < n_live; ++k) {
        if (q.staged) {
          row = s_live[k];
        } else {  // the first live row after `row`, 32 rows a ballot
          for (int from = row + 1;; from += 32) {
            const uint32_t b = __ballot_sync(0xffffffffu, row_live(q, from + lane));
            if (b) {
              row = from + __ffs(b) - 1;
              break;
            }
          }
        }
        if (lane == 0) {
          bar_wait(empty + stage, phase ^ 1u);
          const Window v = tile_window(q, row, c0, c1);
          unsigned char* slot = ring + static_cast<int64_t>(stage) * kSlotBytes;
          s_hw[stage] = q.staged ? s_what[row] : weight_hat(q, row, total, msum);
          s_hd[stage] = v.delta;
          // The edges the clip cut off, under 16 bytes each: plain loads.
          using T = typename R::T;
          for (u64 x = v.a; x < v.head_end; x += sizeof(T))
            *reinterpret_cast<T*>(slot + v.delta + (x - v.a)) = *reinterpret_cast<const T*>(x);
          for (u64 x = v.tail_start; x < v.b; x += sizeof(T))
            *reinterpret_cast<T*>(slot + v.delta + (x - v.a)) = *reinterpret_cast<const T*>(x);
          bar_arrive_tx(full + stage, v.nbytes);
          if (v.nbytes) bulk_copy(slot + v.dst, v.src, v.nbytes, full + stage);
        }
        if (++stage == kStages) { stage = 0; phase ^= 1u; }
      }
    }
  } else {
    // ---- consumer warps: thread t owns 16-byte units t, t + 256, ... ----
    const int ct = threadIdx.x - 32;
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t tile = blockIdx.x; tile < q.n_tiles; tile += gridDim.x) {
      const int64_t c0 = tile * q.tile_cols;
      const int64_t c1 = min(c0 + q.tile_cols, q.p);
      float acc[kUnits][kVec];
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[u][j] = 0.0f;
      for (int k = 0; k < n_live; ++k) {
        bar_wait(full + stage, phase);
        const float wk = s_hw[stage];
        const uint32_t dk = s_hd[stage];
        const uint4* s =
            reinterpret_cast<const uint4*>(ring + static_cast<int64_t>(stage) * kSlotBytes) +
            (dk >> 4) + ct;
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          float x[kVec];
          R::unpack(shifted(s + u * kConsumers, dk & 15), x);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[u][e] = fmaf(wk, x[e], acc[u][e]);
        }
        __syncwarp();
        if (lane == 0) bar_arrive(empty + stage);
        if (++stage == kStages) { stage = 0; phase ^= 1u; }
      }
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int64_t col = c0 + static_cast<int64_t>(ct + u * kConsumers) * kVec;
        float* o = q.out + col;
        if (col + kVec <= c1) {
#pragma unroll
          for (int e = 0; e < kVec; e += 4)
            *reinterpret_cast<float4*>(o + e) =
                make_float4(acc[u][e], acc[u][e + 1], acc[u][e + 2], acc[u][e + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            if (col + e < c1) o[e] = acc[u][e];
        }
      }
    }
  }
}

template <typename R>
cudaError_t launch(const Params& q, int grid, int smem, cudaStream_t stream) {
  auto kernel = fedavg_kernel<R>;
  // Dynamic shared memory above 48 KB is granted only when asked for, per device.
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 rows, 1 = bfloat16 rows.  mask may be NULL (unmasked).
// weights are raw (normalized in the kernel).  grid, tile_bytes, stages and
// smem_bytes are fedavg.py's launch_plan(); any tile or stage count but this
// file's, or shared memory that is not Layout's, is refused.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_fedavg(const void* arena, int dtype, long long row_stride,
                            const void* weights, const void* mask, void* out, int n,
                            long long p, int grid, int tile_bytes, int stages,
                            int smem_bytes, void* stream) {
  if (n < 1 || p < 0 || row_stride < p || tile_bytes != kTileBytes || stages != kStages)
    return cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (esize == 0 || reinterpret_cast<uintptr_t>(arena) % esize ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  const bool staged = n <= kStageCap;
  if (layout(n, staged).total != smem_bytes) return cudaErrorInvalidValue;
  if (p == 0) return cudaSuccess;
  Params q;
  q.base = reinterpret_cast<u64>(arena);
  q.row_bytes = row_stride * esize;
  q.esize = esize;
  q.w = static_cast<const float*>(weights);
  q.m = static_cast<const float*>(mask);
  q.out = static_cast<float*>(out);
  q.n = n;
  q.p = p;
  q.tile_cols = kTileBytes / esize;
  q.n_tiles = (p + q.tile_cols - 1) / q.tile_cols;
  q.staged = staged;
  q.lo = q.base;
  q.hi = q.base + static_cast<u64>(((n - 1) * row_stride + p) * esize);
  if (grid < 1 || grid > q.n_tiles) return cudaErrorInvalidConfiguration;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<F32>(q, grid, smem_bytes, s) : launch<BF16>(q, grid, smem_bytes, s);
}
