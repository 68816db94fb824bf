// Masked weighted FedAvg over the (N, P) arena, hand-written for Hopper: f32,
// bf16 and int8 rows through one ring.
//
// Replaces the TPU kernels of the reference:
//   repro/kernels/fedavg.py::masked_fedavg_pallas       (_masked_fedavg_kernel)
//   repro/kernels/fedavg.py::fedavg_pallas              (_fedavg_kernel)
//   repro/kernels/fused_agg.py::masked_fedavg_q8_pallas (_masked_fedavg_q8_kernel)
// One kernel serves all three, templated on the row type (f32, bf16, or int8
// values with one f32 scale per group of columns); the mask is optional for
// f32 and bf16.
//
//   out[p] = sum over live n, ascending, of  w_hat[n] * x[n, p]
//   int8:    x[n, p] = q[n, p] * s[n, p / group], rounded to f32
//
// with w_hat normalized inside the kernel exactly as the wrappers' plain
// versions do (repro_torch/kernels/fedavg.py):
//   masked:   w*m / sum(w*m) when that sum is > 0, else m / max(sum(m), 1);
//   unmasked: w / sum(w)     when that sum is > 0, else 1/N;
// and live meaning m > 0 (every row when unmasked).  Accumulation is f32 in
// registers with fmaf, over live rows in ascending order, with no atomics, so
// two launches on the same inputs are bit-identical.  An int8 row is
// dequantized value by value and rounded (the reference's q * s) before its
// fmaf, so the fused reduce equals this kernel's f32 reduce of the
// dequantized rows bit for bit: the same w_hat, the same products, the same
// fold order.
//
// Bound on the card: 2 FLOP per element read for f32 and bf16, 3 for int8
// (the dequantizing multiply), far below the H100's f32 ridge, so the pass is
// bound by HBM, reading only the live rows:
//   f32, bf16: t >= (L * P * sizeof(row) + 4 * P) / 3.35 TB/s
//   int8:      t >= (L * P + 4 * L * P / group + 4 * P) / 3.35 TB/s
// for L live rows (chip_smoke.py adds the 8N bytes of weights and mask).  At
// 32 live rows of 10,174,464 columns that is 0.4009 ms for f32 and, at group
// 256, 0.1109 ms for int8 (0.0368 ms with 8 of 32 live).  An int8 value costs
// about 4.5 instructions (one PRMT, one FADD, one FMUL, one FFMA and a share
// of the sign flip and the shared-memory load), about 49 us of issue a call
// at 32 live rows on 132 SMs, so the int8 pass is bound by HBM too, as long as
// the consumers spend nothing on loads or addresses.  The design spends its
// effort on keeping HBM busy with only the bytes that bound counts, in one
// launch:
//   * one launch per aggregate: every block sums w*m (or w) in one fixed
//     order (strided partials, a fixed shuffle tree, warps summed in order),
//     so every block holds the same w_hat bit for bit, and stages w_hat and
//     the ascending list of live rows in shared memory.  Up to kStageCap
//     (2,048) rows are staged; past that the producer reads the mask and
//     weights from global memory (L1-resident) and finds live rows by warp
//     ballots, tile by tile, with the same arithmetic;
//   * bytes arrive by cp.async.bulk into a 3-stage ring in shared memory: a
//     persistent grid of blocks walks column tiles (32 KB of each f32 or
//     bf16 row, 16 KB of each int8 row: 16,384 columns, so that a consumer
//     thread holds 64 accumulators as it does for bf16); one producer lane
//     issues one bulk copy per live row into the next stage (and, for int8,
//     one more of the tile's scales, 256 bytes at group 256, into the stage's
//     scale slot) and posts their bytes on the stage's full mbarrier; eight
//     consumer warps wait on it, fold the row into f32 registers and release
//     the stage on its empty mbarrier.  No register holds a byte in flight,
//     and dead rows are never loaded, so the bytes read scale with the live
//     rows;
//   * int8 -> f32 without the I2F unit, whose rate is a small fraction of the
//     FMA rate: flipping each byte's sign bit gives v + 128 in 0..255,
//     __byte_perm places it in the mantissa of 2^23, and subtracting
//     2^23 + 128 leaves v exactly (one PRMT and one FADD per value).  A
//     consumer's 16 columns lie in at most two groups (halves of 8 columns,
//     the group being a multiple of 8), whose scales it reads from the scale
//     slot at offsets it computes once a tile;
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
//     same slot.  This one path serves aligned and unaligned strides, f32,
//     bf16, int8 values and their scales, and a view whose data_ptr is not
//     16-byte aligned; tile_window() in fedavg.py is the same arithmetic, and
//     the CPU tests hold it to exactly-once coverage;
//   * the output is written with 16-byte stores, a ragged last unit with
//     scalar ones.
// The launch plan is fixed (3 stages, 2 blocks per SM, the tiles above,
// chosen by measurement on the card: PERF.md); fedavg.py's launch_plan()
// sizes the grid and the dynamic shared memory, and this file refuses any
// other tile, stage count or shared memory than Layout below.
//
// Plain C interface (bound with ctypes): the wrapper allocates the output,
// the kernel runs on the caller's stream and each entry returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>



namespace {

constexpr int kConsumers = 256;                 // 8 consumer warps
constexpr int kThreads = kConsumers + 32;       // + 1 producer warp (warp 0)
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;                 // fedavg.py BLOCKS_PER_SM
constexpr int kStages = 3;                      // fedavg.py STAGES
constexpr int kStageCap = 2048;                 // fedavg.py STAGE_CAP
constexpr int kMiscBytes = 512;                 // fedavg.py _MISC_BYTES

using u64 = unsigned long long;  // byte addresses
__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// int8 byte k of w (sign bit already flipped) as an exact float.
__device__ __forceinline__ float byte_to_f32(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | k)), 8388736.0f);
}

// Row types: what one 16-byte unit of a row holds, and the tile of each row
// (fedavg.py TILE_BYTES, TILE_BYTES_Q8) that fills one ring slot.
struct F32 {
  using T = uint32_t;
  static constexpr int kVec = 4;  // elements per 16 bytes
  static constexpr int kTileBytes = 32768;
  static constexpr bool kScaled = false;
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
  static constexpr int kTileBytes = 32768;
  static constexpr bool kScaled = false;
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

// int8 values, exact as floats; their scales come from the stage's scale slot.
struct Q8 {
  using T = uint8_t;
  static constexpr int kVec = 16;
  static constexpr int kTileBytes = 16384;
  static constexpr bool kScaled = true;
  __device__ static void unpack(const uint4& v, float (&x)[kVec]) {
    const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                           v.w ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = byte_to_f32(w[j >> 2], j & 3);
  }
};

__host__ __device__ constexpr int64_t round_up(int64_t x, int64_t to) {
  return (x + to - 1) / to * to;
}

// A slot of the ring: one row's tile, its window starting up to 112 bytes early.
template <typename R>
__host__ __device__ constexpr int64_t slot_bytes() {
  return R::kTileBytes + 128;
}

// A scale slot (int8 only): the groups one tile's columns touch, at most
// ceil(tile / group) + 1 of them, 128 bytes early at most, in a multiple of
// 128 bytes (fedavg.py scale_slot_bytes()).
__host__ __device__ inline int64_t scale_slot_bytes(int64_t tile_cols, int group) {
  return 128 + round_up(4 * ((tile_cols + group - 1) / group + 1), 128);
}

// Dynamic shared memory, in this order (fedavg.py smem_bytes()): the ring's
// slots, the scale slots (int8), each slot's weight, byte offset and scale
// byte offset (int8), a full and an empty barrier per stage (8-byte
// aligned), misc (floats 0-50: warp partials and the sums), then (staged)
// w_hat and the live list.
struct Layout {
  int64_t sring, hw, hd, sd, bars, misc, what, live, total;
};

__host__ __device__ inline Layout layout(int n, bool staged, int64_t slot, int64_t sslot) {
  Layout l;
  l.sring = kStages * slot;
  l.hw = l.sring + kStages * sslot;
  l.hd = l.hw + 4 * kStages;
  l.sd = l.hd + 4 * kStages;
  l.bars = round_up(l.sd + (sslot ? 4 * kStages : 0), 8);
  l.misc = l.bars + 16 * kStages;
  l.what = l.misc + kMiscBytes;
  l.live = l.what + (staged ? 4LL * n : 0);
  l.total = l.live + (staged ? 4LL * n : 0);
  return l;
}

// One strided (N, cols) view: its first byte, row stride and element size,
// and its extent [lo, hi), the first byte to one past the last row's last.
struct View {
  u64 base, lo, hi;
  int64_t row_bytes;
  int esize;
};

__host__ inline View make_view(const void* ptr, int64_t row_stride, int esize, int n,
                               int64_t cols) {
  View v;
  v.base = v.lo = reinterpret_cast<u64>(ptr);
  v.row_bytes = row_stride * esize;
  v.esize = esize;
  v.hi = v.base + static_cast<u64>(((n - 1) * row_stride + cols) * esize);
  return v;
}

struct Params {
  View x;                   // the rows
  View s;                   // int8: the scales, one f32 per group
  const float* w;
  const float* m;           // nullptr when unmasked
  float* out;
  int n;
  int64_t p;
  int64_t tile_cols;
  int64_t n_tiles;
  bool staged;
  int group;                // int8: columns per scale
  int64_t sslot;            // int8: scale slot bytes (0 otherwise)
};

// One row's window of one tile (fedavg.py tile_window, the same arithmetic).
struct Window {
  u64 a, b, src, head_end, tail_start;
  uint32_t nbytes, dst, delta;
};

__device__ __forceinline__ Window tile_window(const View& x, int row, int64_t c0,
                                              int64_t c1) {
  Window v;
  v.a = x.base + static_cast<u64>(row * x.row_bytes + c0 * x.esize);
  v.b = x.base + static_cast<u64>(row * x.row_bytes + c1 * x.esize);
  const u64 origin = v.a & ~127ull;  // the slot's first byte maps here
  const u64 ws = umax(origin, (x.lo + 15) & ~15ull);
  const u64 we = umax(umin((v.b + 15) & ~15ull, x.hi & ~15ull), ws);
  v.src = ws;
  v.nbytes = static_cast<uint32_t>(we - ws);
  v.dst = static_cast<uint32_t>(ws - origin);
  v.delta = static_cast<uint32_t>(v.a - origin);
  v.head_end = umin(umax(ws, v.a), v.b);
  v.tail_start = umin(umax(we, v.a), v.b);
  return v;
}

// The edges a window's clip cut off, under 16 bytes each: plain loads into
// the slot, at the same offsets as the bulk copy's bytes.
template <typename T>
__device__ __forceinline__ void load_edges(unsigned char* slot, const Window& v) {
  for (u64 x = v.a; x < v.head_end; x += sizeof(T))
    *reinterpret_cast<T*>(slot + v.delta + (x - v.a)) = *reinterpret_cast<const T*>(x);
  for (u64 x = v.tail_start; x < v.b; x += sizeof(T))
    *reinterpret_cast<T*>(slot + v.delta + (x - v.a)) = *reinterpret_cast<const T*>(x);
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
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fedavg_kernel(const Params q) {
  constexpr int kVec = R::kVec;
  constexpr int kUnits = R::kTileBytes / (16 * kConsumers);  // 16-byte units per consumer
  constexpr int64_t kSlot = slot_bytes<R>();
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(q.n, q.staged, kSlot, q.sslot);
  unsigned char* ring = smem;
  unsigned char* sring = smem + lay.sring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kStages;
  float* s_hw = reinterpret_cast<float*>(smem + lay.hw);
  uint32_t* s_hd = reinterpret_cast<uint32_t*>(smem + lay.hd);
  uint32_t* s_sd = reinterpret_cast<uint32_t*>(smem + lay.sd);
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
      // int8: the groups [g0, g1) that the tile's columns touch.
      const int64_t g0 = R::kScaled ? c0 / q.group : 0;
      const int64_t g1 = R::kScaled ? (c1 + q.group - 1) / q.group : 0;
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
          const Window v = tile_window(q.x, row, c0, c1);
          unsigned char* slot = ring + static_cast<int64_t>(stage) * kSlot;
          s_hw[stage] = q.staged ? s_what[row] : weight_hat(q, row, total, msum);
          s_hd[stage] = v.delta;
          load_edges<typename R::T>(slot, v);
          uint32_t bytes = v.nbytes;
          Window sv{};
          unsigned char* sslot = sring + static_cast<int64_t>(stage) * q.sslot;
          if constexpr (R::kScaled) {
            sv = tile_window(q.s, row, g0, g1);
            s_sd[stage] = sv.delta;
            load_edges<float>(sslot, sv);
            bytes += sv.nbytes;
          }
          bar_arrive_tx(full + stage, bytes);
          if (v.nbytes) bulk_copy(slot + v.dst, v.src, v.nbytes, full + stage);
          if (sv.nbytes) bulk_copy(sslot + sv.dst, sv.src, sv.nbytes, full + stage);
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
      // int8: each unit's two halves of 8 columns lie in one group each; their
      // scales sit at these float offsets into the tile's scale window (a
      // unit past the tile's end reads its last group and is never stored).
      int goff[kUnits][2];
      if constexpr (R::kScaled) {
        const uint32_t r0 = static_cast<uint32_t>(c0 % q.group);
        const uint32_t last = static_cast<uint32_t>(c1 - c0 - 1);
        const uint32_t g = static_cast<uint32_t>(q.group);
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          const uint32_t k = static_cast<uint32_t>((ct + u * kConsumers) * kVec);
          goff[u][0] = static_cast<int>((r0 + min(k, last)) / g);
          goff[u][1] = static_cast<int>((r0 + min(k + 8, last)) / g);
        }
      }
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
            reinterpret_cast<const uint4*>(ring + static_cast<int64_t>(stage) * kSlot) +
            (dk >> 4) + ct;
        const float* sc = reinterpret_cast<const float*>(
            sring + static_cast<int64_t>(stage) * q.sslot + (R::kScaled ? s_sd[stage] : 0));
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          float x[kVec];
          R::unpack(shifted(s + u * kConsumers, dk & 15), x);
          if constexpr (R::kScaled) {  // dequantize first, rounded, as the reference does
            const float lo = sc[goff[u][0]], hi = sc[goff[u][1]];
#pragma unroll
            for (int e = 0; e < kVec; ++e) x[e] = __fmul_rn(x[e], e < 8 ? lo : hi);
          }
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

// Check the plan against this file's and launch on the caller's stream.
template <typename R>
cudaError_t launch(Params& q, int grid, int tile_bytes, int stages, int smem,
                   cudaStream_t stream) {
  if (tile_bytes != R::kTileBytes || stages != kStages) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q.out) % 16) return cudaErrorInvalidValue;
  q.tile_cols = R::kTileBytes / q.x.esize;
  q.n_tiles = (q.p + q.tile_cols - 1) / q.tile_cols;
  q.staged = q.n <= kStageCap;
  q.sslot = R::kScaled ? scale_slot_bytes(q.tile_cols, q.group) : 0;
  if (layout(q.n, q.staged, slot_bytes<R>(), q.sslot).total != smem) return cudaErrorInvalidValue;
  if (q.p == 0) return cudaSuccess;
  if (grid < 1 || grid > q.n_tiles) return cudaErrorInvalidConfiguration;
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
  const int esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (n < 1 || p < 0 || row_stride < p || esize == 0 ||
      reinterpret_cast<uintptr_t>(arena) % esize)
    return cudaErrorInvalidValue;
  Params q{};
  q.x = make_view(arena, row_stride, esize, n, p);
  q.w = static_cast<const float*>(weights);
  q.m = static_cast<const float*>(mask);
  q.out = static_cast<float*>(out);
  q.n = n;
  q.p = p;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<F32>(q, grid, tile_bytes, stages, smem_bytes, s)
                    : launch<BF16>(q, grid, tile_bytes, stages, smem_bytes, s);
}

// The fused dequant-into-aggregate over the int8 arena: q (N, P) int8 with row
// stride q_stride, scales (N, P/group) f32 with row stride s_stride (both in
// elements, any alignment), raw weights and the mask (N,) f32, out (P,) f32.
// P must be a multiple of the group, the group a multiple of 8.  grid,
// tile_bytes, stages and smem_bytes are fedavg.py's launch_plan(rows,
// group=group).  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_fedavg_q8(const void* values, long long q_stride, const void* scales,
                               long long s_stride, const void* weights, const void* mask,
                               void* out, int n, long long p, int group, int grid,
                               int tile_bytes, int stages, int smem_bytes, void* stream) {
  if (n < 1 || p < 0 || group < 8 || group % 8 || p % group || q_stride < p ||
      s_stride < p / group || mask == nullptr || reinterpret_cast<uintptr_t>(scales) % 4)
    return cudaErrorInvalidValue;
  Params q{};
  q.x = make_view(values, q_stride, 1, n, p);
  q.s = make_view(scales, s_stride, 4, n, p / group);
  q.w = static_cast<const float*>(weights);
  q.m = static_cast<const float*>(mask);
  q.out = static_cast<float*>(out);
  q.n = n;
  q.p = p;
  q.group = group;
  return launch<Q8>(q, grid, tile_bytes, stages, smem_bytes, static_cast<cudaStream_t>(stream));
}
