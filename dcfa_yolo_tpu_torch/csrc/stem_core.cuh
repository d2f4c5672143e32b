// Shared core of the two stem kernels for Hopper (sm_90a): kernel A
// (stem_eval.cu, the fused eval stem) and kernel C (stem_train.cu, the fused
// train stem).  Both compute conv3x3 s1 (3 -> 16) over 8x16 pooled pixels a
// tile, keep the 17x33 conv tile in shared memory and pool it 3x3 s2 pad 1;
// only the pooled maps (and C's per-CTA sums) reach device memory.  The stem
// split probe's four variants (stem_probe.cu) run on kernel A's staging,
// conv step and pool: conv, pool and dblbuf on A's walk (eval_walk) with
// their own conv step or finish, pipe on a split-role walk of its own.
//
// What is shared:
//   * the tile geometry and the persistent tile walk: a fixed grid of CTAs
//     (the wrapper picks min(tiles, resident CTAs), ops/stem_core.py), CTA i
//     taking tiles i, i + grid, i + 2*grid, ...; tile t is (image, tile row,
//     tile col) with the tile column fastest, so CTAs that run together
//     share halo rows in L2;
//   * double buffering (walk_tiles): two input stage buffers, so that a
//     CTA copies tile k+1's input by cp.async while it convolves tile k,
//     and in A and C's bf16 instantiation two conv tiles, so that it pools
//     tile k-1 in the same step, behind one barrier (4- or 8-byte copies:
//     A's canvas rows are 1,284 B at 640^2, not a multiple of the 16 B a
//     TMA stride needs, and C's input is read the same way so that one
//     staging scheme serves both);
//   * the conv as an implicit GEMM on the tensor cores
//     (mma.sync m16n8k16 bf16 -> f32): M = conv positions, N = 16 channels
//     (two n8 tiles), K = 32 (two k16 steps).  K rows 0-26 are the taps in
//     the order k = ci*9 + dy*3 + dx; in A row 27 is the bias against an
//     A-operand column fixed at 1.0, in C it is zero; rows 28-31 are zero.
//     The B fragments (8 registers a thread) are packed once per CTA from
//     the (16, 3, 3, 3) weight tensor.  The K-padding columns of the A
//     operand are zeroed in registers, never read from shared memory (0 *
//     a stale Inf or NaN would be NaN);
//   * the f32 CUDA-core conv for C's float32 instantiation (one fmaf a tap
//     in the order k = ci*9 + dy*3 + dx, as before: TF32 is ruled out by its
//     tolerance), its weights in constant memory;
//   * the pool trees (max in A, max and min in C) reading 16 bytes at a
//     time (bf16 maxima and minima as bf16x2 instructions), and C's
//     per-channel sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace stem {

constexpr int CO = 16;             // stem output channels (phi='n')
constexpr int TH = 8;              // pooled rows per tile
constexpr int TW = 16;             // pooled cols per tile
constexpr int CR = 2 * TH + 1;     // conv rows under the tile's pool windows
constexpr int CC = 2 * TW + 1;     // conv cols
constexpr int NPOS = CR * CC;      // conv positions per tile (561)
constexpr int IR = CR + 2;         // input rows incl. the 3x3 halo
constexpr int IC = CC + 2;         // input cols incl. the halo
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MTILES = (NPOS + 15) / 16;  // m16 tiles of conv positions
static_assert(TH * TW * 2 == THREADS, "one pool item per (pooled pixel, 8 channels)");

typedef __nv_bfloat16 bf16;

struct Tile {
  int b, pr0, pc0;  // image, first pooled row and col
};

__host__ __device__ __forceinline__ int tiles_x_of(int W) { return (W / 2 + TW - 1) / TW; }
__host__ __device__ __forceinline__ int tiles_y_of(int H) { return (H / 2 + TH - 1) / TH; }

// Tile t as (image, tile row, tile col), and the walk from one tile to the
// tile `step` further on without a division per step.
struct TileIndex {
  int b, ty, tx;
  __device__ __forceinline__ TileIndex(int t, int tiles_x, int tiles_y) {
    const int per_img = tiles_x * tiles_y, rem = t % per_img;
    b = t / per_img;
    ty = rem / tiles_x;
    tx = rem % tiles_x;
  }
  __device__ __forceinline__ void advance(const TileIndex& step, int tiles_x, int tiles_y) {
    tx += step.tx;  // step.tx < tiles_x and step.ty < tiles_y: one carry each
    ty += step.ty + (tx >= tiles_x);
    if (tx >= tiles_x) tx -= tiles_x;
    b += step.b + (ty >= tiles_y);
    if (ty >= tiles_y) ty -= tiles_y;
  }
  __device__ __forceinline__ Tile tile() const { return Tile{b, ty * TH, tx * TW}; }
};

// ---- cp.async ------------------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src-size 0 zero-fills the destination (the conv's halo)
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
               "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- the persistent tile walk ---------------------------------------------

// CTA blockIdx.x walks tiles blockIdx.x, + gridDim.x, ... (grid <= tiles)
// of the B images.
// Two input stage buffers: in step k the CTA issues the copy of tile k+1's
// input into stage (k+1) & 1 and convolves tile k from stage k & 1.
//   kConvTiles == 2 (kernel A, kernel C in bf16): two conv tiles, and in the
//     same step the CTA finishes (pools, and so on) tile k-1 from conv tile
//     (k-1) & 1, behind one barrier a step.  That barrier publishes tile
//     k's input (every thread waited for its own copies) and tile k-1's
//     conv tile, and tells every thread that step k-1's reads of stage
//     (k+1) & 1 and of conv tile k & 1 are done.  The conv of one tile and
//     the pools of the one before it thus run side by side.
//   kConvTiles == 1 (kernel C in float32, whose conv tile is twice the
//     size): one conv tile, finished in the same step after a second
//     barrier; the smaller footprint lets more CTAs share an SM instead.
//   stage(t, sbuf): issue tile t's copies into stage buffer sbuf
//   conv(t, sbuf, cbuf): stage buffer sbuf -> conv tile cbuf
//   finish(t, cbuf): conv tile cbuf -> device memory
template <int kConvTiles, class Stage, class Conv, class Finish>
__device__ __forceinline__ void walk_tiles(int B, int tiles_x, int tiles_y, Stage&& stage,
                                           Conv&& conv, Finish&& finish) {
  static_assert(kConvTiles == 1 || kConvTiles == 2, "one or two conv tiles");
  const TileIndex step(gridDim.x, tiles_x, tiles_y);
  TileIndex cur(blockIdx.x, tiles_x, tiles_y);  // past the last tile once cur.b == B
  Tile prev = cur.tile();                        // read with two conv tiles only
  stage(cur.tile(), 0);
  cp_async_commit();
  bool have_prev = false;
  for (int k = 0;; ++k) {
    const bool have = cur.b < B;
    cp_async_wait_all();
    __syncthreads();
    if (!have && !(kConvTiles == 2 && have_prev)) break;  // the same for every thread
    TileIndex next = cur;
    next.advance(step, tiles_x, tiles_y);
    if (have) {
      if (next.b < B) stage(next.tile(), (k + 1) & 1);
      cp_async_commit();
      conv(cur.tile(), k & 1, kConvTiles == 2 ? k & 1 : 0);
    }
    if constexpr (kConvTiles == 1) {
      __syncthreads();
      finish(cur.tile(), 0);
    } else {
      if (have_prev) finish(prev, (k + 1) & 1);
      prev = cur.tile();
    }
    cur = next;
    have_prev = have;
  }
}

// ---- bf16 bits -----------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float a, float b) {  // a in the low half
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return __bfloat1622float2(h);
}

constexpr uint32_t BF16_ONE = 0x3F80u;
constexpr uint32_t BF16_NEG_INF2 = 0xFF80FF80u;

// ---- the tensor-core conv --------------------------------------------------

// Where a stage buffer keeps input value (ci, row, col) of the tile:
// ci*CS + row*RS + col*PS + SH elements from its start.
template <int CS, int RS, int PS, int SH>
struct StageLayout {
  static constexpr int kCS = CS, kRS = RS, kPS = PS, kSH = SH;
  __device__ __forceinline__ static int tap(int k) {  // k = ci*9 + dy*3 + dx
    return (k / 9) * CS + ((k % 9) / 3) * RS + (k % 3) * PS;
  }
  __device__ __forceinline__ static int base(int p) {  // conv position p
    return (p / CC) * RS + (p % CC) * PS + SH;
  }
};

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One thread's share of the GEMM operands that stays the same for every tile:
// the B fragments and the offsets of its eight A-operand K columns.
struct MmaOperands {
  uint32_t b[2][2][2];  // [k16 step][n8 tile][register]
  int off[8];           // byte offsets of K columns 2t, 2t+1, 2t+8, 2t+9, 16+.., 24+..
  uint32_t keep, ones;  // the last register's K columns 24+2t, 25+2t: taps, bias one, zero
};

// Pack the operands from the (16, 27) weight (co-major, k = ci*9 + dy*3 +
// dx) and, where `bias` is given, K row 27 = bias against a 1.0 column.
// Fragment layout of mma.m16n8k16 (PTX ISA): lane = 4g + t; B register r of
// k16 step s holds K rows s*16 + r*8 + 2t, +1 of column n = 8j + g; A
// registers hold rows g and g+8 at K columns 2t, 2t+1 (regs 0, 1) and 2t+8,
// 2t+9 (regs 2, 3).
template <class L>
__device__ __forceinline__ void mma_operands(const bf16* __restrict__ weight,
                                             const float* __restrict__ bias, MmaOperands& o) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint16_t* w16 = reinterpret_cast<const uint16_t*>(weight);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = 8 * j + g;
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 16 * s + 8 * r + 2 * t + e;
          v[e] = k < 27 ? w16[n * 27 + k]
                        : (k == 27 && bias != nullptr
                               ? static_cast<uint32_t>(__bfloat16_as_ushort(
                                     __float2bfloat16_rn(bias[n])))
                               : 0u);
        }
        o.b[s][j][r] = v[0] | (v[1] << 16);
      }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 8 * (i >> 1) + 2 * t + (i & 1);
    o.off[i] = k < 27 ? 2 * L::tap(k) : 0;  // padding columns read any valid element ...
  }
  // ... and are masked here: t = 0 holds taps 24, 25; t = 1 tap 26 and K row
  // 27 (1.0 where the bias rides in row 27, else 0); t = 2, 3 hold zeros
  o.keep = t == 0 ? 0xFFFFFFFFu : (t == 1 ? 0x0000FFFFu : 0u);
  o.ones = (t == 1 && bias != nullptr) ? (BF16_ONE << 16) : 0u;
}

// The tile's conv on the tensor cores.  `stage` holds the tile's bf16 input
// in layout L; warp w takes m16 tiles w, w + 8, ...  epi(p, ch, v0, v1, v2,
// v3) receives the f32 sums of conv position p at channels ch, ch + 1 (v0,
// v1) and ch + 8, ch + 9 (v2, v3), ch = 2 * (lane % 4).
template <class L, class Epi>
__device__ __forceinline__ void conv_tile_mma(const bf16* stage, const MmaOperands& o,
                                              Epi&& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const char* sb = reinterpret_cast<const char*>(stage);
  // the pair of K columns (i, i + 1) of the position at byte address r
  auto pair = [&](const char* r, int i) {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(r + o.off[i])) |
           (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(r + o.off[i + 1])) << 16);
  };
  for (int mt = warp; mt < MTILES; mt += WARPS) {
    const int p0 = 16 * mt + g, p1 = p0 + 8;
    const char* r0 = sb + 2 * L::base(p0 < NPOS ? p0 : NPOS - 1);
    const char* r1 = sb + 2 * L::base(p1 < NPOS ? p1 : NPOS - 1);
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t a[4] = {pair(r0, 0), pair(r1, 0), pair(r0, 2), pair(r1, 2)};
    mma_16816(d0, a, o.b[0][0][0], o.b[0][0][1]);
    mma_16816(d1, a, o.b[0][1][0], o.b[0][1][1]);
    a[0] = pair(r0, 4);
    a[1] = pair(r1, 4);
    a[2] = (pair(r0, 6) & o.keep) | o.ones;
    a[3] = (pair(r1, 6) & o.keep) | o.ones;
    mma_16816(d0, a, o.b[1][0][0], o.b[1][0][1]);
    mma_16816(d1, a, o.b[1][1][0], o.b[1][1][1]);
    // accumulator layout: d[0], d[1] row g, d[2], d[3] row g + 8, cols 2t, 2t+1
    if (p0 < NPOS) epi(p0, 2 * t, d0[0], d0[1], d1[0], d1[1]);
    if (p1 < NPOS) epi(p1, 2 * t, d0[2], d0[3], d1[2], d1[3]);
  }
}

// ---- the CUDA-core conv (C's float32 instantiation) ------------------------

// One thread per conv position, all 16 channels, one fmaf a tap in the
// order k = ci*9 + dy*3 + dx.  wt(co, k) gives weight (co, k); the kernel
// reads it from constant memory at an index known at compile time, which
// the compiler turns into uniform-register loads (one a pair of weights for
// the whole warp), so the shared-memory pipe is left to the input taps, the
// conv tile and the pools.  epi(p, g, a0, a1, a2, a3) receives channels 4g
// .. 4g + 3.
template <class L, class Wt, class Epi>
__device__ __forceinline__ void conv_tile_fma(const float* stage, Wt&& wt, Epi&& epi) {
  for (int p = threadIdx.x; p < NPOS; p += THREADS) {
    const float* src = stage + L::base(p);
    float in[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) in[k] = src[L::tap(k)];
#pragma unroll
    for (int g = 0; g < CO / 4; ++g) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 27; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = fmaf(in[k], wt(4 * g + j, k), a[j]);
      epi(p, g, a[0], a[1], a[2], a[3]);
    }
  }
}

// ---- conv tile element access ----------------------------------------------

// 8 channels of one conv position, the half `h` of a pool item: in bf16
// channels 8h .. 8h + 7, 16 contiguous bytes (max and min as bf16x2
// instructions, exact); in f32 channels 4h .. 4h + 3 and 8 + 4h .. 11 + 4h,
// two 16-byte pieces 32 bytes apart, so that the two halves of a pixel
// write whole 32-byte sectors with each store instruction.  kHalf is the
// offset of half 1, kGap that of the second piece.
template <typename T>
struct Pack8;

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  x = __hmax2(x, y);
  memcpy(&a, &x, 4);
  return a;
}

__device__ __forceinline__ uint32_t bf16x2_min(uint32_t a, uint32_t b) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  x = __hmin2(x, y);
  memcpy(&a, &x, 4);
  return a;
}

template <>
struct Pack8<bf16> {
  static constexpr int kHalf = 8;
  uint32_t w[4];  // bf16 pairs, the lower channel in the low half
  __device__ __forceinline__ static Pack8 fill(float v) {
    const uint32_t u = pack2(v, v);
    return Pack8{{u, u, u, u}};
  }
  __device__ __forceinline__ void load(const bf16* src) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
  }
  __device__ __forceinline__ void store(bf16* dst) const {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ void max(const Pack8& o) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = bf16x2_max(w[j], o.w[j]);
  }
  __device__ __forceinline__ void min(const Pack8& o) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = bf16x2_min(w[j], o.w[j]);
  }
};

template <>
struct Pack8<float> {
  static constexpr int kHalf = 4, kGap = 8;
  float v[8];
  __device__ __forceinline__ static Pack8 fill(float x) {
    Pack8 p;
#pragma unroll
    for (int j = 0; j < 8; ++j) p.v[j] = x;
    return p;
  }
  __device__ __forceinline__ void load(const float* src) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + kGap);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  __device__ __forceinline__ void store(float* dst) const {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + kGap) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ __forceinline__ void max(const Pack8& o) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(v[j], o.v[j]);
  }
  __device__ __forceinline__ void min(const Pack8& o) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fminf(v[j], o.v[j]);
  }
};

// ---- pools ---------------------------------------------------------------

// Pool item `item` (0 .. 2*TH*TW - 1) of a tile: (pooled pixel, half of the
// channels); by default the thread's own, item threadIdx.x.  The pool
// functions skip items outside the image (ragged tiles) by returning from
// themselves only: the caller's tile loop has barriers.
struct PoolItem {
  int lr, lc, half, pr, pc;
  __device__ __forceinline__ explicit PoolItem(const Tile& t) : PoolItem(t, threadIdx.x) {}
  __device__ __forceinline__ PoolItem(const Tile& t, int item) {
    const int pix = item >> 1;
    half = item & 1;
    lr = pix / TW;
    lc = pix % TW;
    pr = t.pr0 + lr;
    pc = t.pc0 + lc;
  }
  template <int SCS, typename T>
  __device__ __forceinline__ int at(int dy, int dx) const {  // conv tile offset
    return ((2 * lr + dy) * CC + 2 * lc + dx) * SCS + half * Pack8<T>::kHalf;
  }
  template <typename T>
  __device__ __forceinline__ size_t out_index(int b, int Hp, int Wp) const {
    return (((size_t)b * Hp + pr) * Wp + pc) * CO + half * Pack8<T>::kHalf;
  }
};

// A: max over the 3x3 window (positions outside the image hold -inf), ReLU;
// for pool item `item` (by default the thread's own)
template <int SCS>
__device__ __forceinline__ void pool_max_relu(const bf16* s_conv, bf16* __restrict__ out,
                                              const Tile& t, int Hp, int Wp, int item) {
  const PoolItem it(t, item);
  if (it.pr >= Hp || it.pc >= Wp) return;
  Pack8<bf16> m = Pack8<bf16>::fill(0.f);  // the ReLU, folded into the max
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      Pack8<bf16> v;
      v.load(s_conv + it.at<SCS, bf16>(dy, dx));
      m.max(v);
    }
  m.store(out + it.out_index<bf16>(t.b, Hp, Wp));
}

template <int SCS>
__device__ __forceinline__ void pool_max_relu(const bf16* s_conv, bf16* __restrict__ out,
                                              const Tile& t, int Hp, int Wp) {
  pool_max_relu<SCS>(s_conv, out, t, Hp, Wp, threadIdx.x);
}

// C: max and min over the window's positions inside the image (with pad 1,
// stride 2 and even H, W every window holds >= 4).  The window's positions
// (dy, dx) in {1, 2}^2 are the conv pixels 2*pr .. 2*pr + 1, 2*pc .. 2*pc +
// 1, which the tile owns for the sums ("C's sums"): owned(v) sees each of
// them once.
template <int SCS, typename T, class Owned>
__device__ __forceinline__ void pool_max_min(const T* s_conv, T* __restrict__ pmax,
                                             T* __restrict__ pmin, const Tile& t, int H,
                                             int W, Owned&& owned) {
  const PoolItem it(t);
  if (it.pr >= H / 2 || it.pc >= W / 2) return;
  Pack8<T> mx = Pack8<T>::fill(-INFINITY), mn = Pack8<T>::fill(INFINITY);
  // only the top row and the left col of a window can lie outside the
  // image: with H, W even its last row 2*pr + 1 is at most H - 1
  const int y_lo = it.pr == 0, x_lo = it.pc == 0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    if (dy < y_lo) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      if (dx < x_lo) continue;
      Pack8<T> v;
      v.load(s_conv + it.at<SCS, T>(dy, dx));
      mx.max(v);
      mn.min(v);
      if (dy > 0 && dx > 0) owned(v);
    }
  }
  const size_t o = it.out_index<T>(t.b, H / 2, W / 2);
  mx.store(pmax + o);
  mn.store(pmin + o);
}

// ---- C's sums ----------------------------------------------------------

// Ownership: a tile owns conv rows [2*pr0, 2*pr0 + 2*TH) and cols [2*pc0,
// 2*pc0 + 2*TW) (local rows and cols 1 .. 2*TH, 1 .. 2*TW) inside the
// image, so every conv pixel is counted once: the 2x2 conv pixels under
// each of its pooled pixels.  Each thread adds the values and squares of
// its channels at the owned positions it sees to sums that live in
// registers across all the CTA's tiles.
//   bf16: in the conv epilogue (`owns`), in double, as are the CTAs'
//     partials until the wrapper has added them.  A bf16 value has 8
//     significant bits and its square 16, so the sums are exact whatever
//     the order: the correctly rounded float32 of the true sums,
//     independent of the grid and of the tile walk.
//   float32: in the pool (`pool_max_min`'s owned positions), in f32 per
//     thread (about 130 values a channel at 640^2 b16), then in double
//     across threads and CTAs; float32 sums cannot be exact anyway.
__device__ __forceinline__ bool owns(int p, const Tile& t, int H, int W) {
  const int r = p / CC, c = p % CC;
  return r >= 1 && c >= 1 && 2 * t.pr0 - 1 + r < H && 2 * t.pc0 - 1 + c < W;
}

template <int N, typename A>
__device__ __forceinline__ void sums_add(const float (&v)[N], A (&sum)[N], A (&sq)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const A d = v[j];
    sum[j] += d;
    sq[j] = fma(d, d, sq[j]);
  }
}

// The CTA's (16, 2) partial [sum, sum of squares] in double.  The thread's N
// channels are `ch`; lanes kApart apart share them, so a fixed shuffle tree
// over those lanes, then a fixed order over the warps, adds them up.  s_red
// is [WARPS][2 * CO] double.  No atomics.
template <int kApart, int N, typename A>
__device__ __forceinline__ void sums_write(const A (&sum)[N], const A (&sq)[N],
                                           const int (&ch)[N], double* s_red,
                                           double* __restrict__ partial) {
  static_assert(kApart * N == CO, "the lanes below kApart hold all 16 channels");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    double s = sum[j], q = sq[j];
#pragma unroll
    for (int o = kApart; o < 32; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane < kApart) {
      s_red[warp * 2 * CO + 2 * ch[j]] = s;
      s_red[warp * 2 * CO + 2 * ch[j] + 1] = q;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * CO) {
    double acc = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += s_red[w * 2 * CO + threadIdx.x];
    partial[threadIdx.x] = acc;
  }
}

// ---- kernel A's walk (stem_eval.cu; the probe's variants) -------------------

constexpr int ICB = IC + 1;     // staged canvas cols, from the even column x0 - 1
constexpr int WORDS = ICB / 2;  // 4-byte copies per staged row
constexpr int EVAL_SCS = 24;    // conv tile: bf16 elements per position (16 used)

// stage value (ci, r, c) of the tile (canvas row y0 + r, col x0 + c) sits at
// ci*IR*ICB + r*ICB + c + 1: row r starts at the even column x0 - 1
typedef StageLayout<IR * ICB, ICB, 1, 1> EvalLayout;

struct EvalSmem {
  alignas(16) bf16 conv[2][NPOS * EVAL_SCS];
  alignas(16) bf16 stage[2][3 * IR * ICB];
};

// The tile's canvas rows y0 .. y0 + IR - 1, cols x0 - 1 .. x0 + IC - 1, by
// 4-byte cp.async (canvas rows are W + 2 elements: only 4 bytes align).
// Pairs outside the canvas are zero-filled; gx and W + 2 are even, so a pair
// lies wholly inside or outside.  Thread tid < 14 * WORDS copies word
// tid % WORDS of staged rows (ci, r) = tid / WORDS, + 14, ... (3 * IR rows).
__device__ __forceinline__ void stage_canvas(const bf16* __restrict__ img, bf16* dst, int y0,
                                             int x0, int H2, int W2) {
  constexpr int GROUPS = THREADS / WORDS;
  if (threadIdx.x >= GROUPS * WORDS) return;
  const int w = threadIdx.x % WORDS;
  const int gx = x0 - 1 + 2 * w;
  const bool col_ok = gx >= 0 && gx < W2;
  for (int row = threadIdx.x / WORDS; row < 3 * IR; row += GROUPS) {
    const int ci = row / IR, gy = y0 + row % IR;
    const bool ok = col_ok && gy >= 0 && gy < H2;
    const bf16* src = ok ? img + ((size_t)ci * H2 + gy) * W2 + gx : img;
    cp_async<4>(dst + row * ICB + 2 * w, src, ok);
  }
}

// Whether conv position p of the tile whose conv tile starts at conv pixel
// (y0, x0) = (2*pr0 - 1, 2*pc0 - 1) lies inside the H x W image; outside, a
// conv step writes -inf, the pool's padding.
__device__ __forceinline__ bool in_image(int y0, int x0, int p, int H, int W) {
  const int y = y0 + p / CC, x = x0 + p % CC;
  return y >= 0 && y < H && x >= 0 && x < W;
}

// Kernel A's conv step: stage buffer -> conv tile on the tensor cores, the
// bias in K row 27, each value rounded to bf16 at EVAL_SCS elements a
// position.  The B fragments are packed when the step is made, once a CTA.
struct EvalConvMma {
  MmaOperands ops;
  int H, W;
  __device__ __forceinline__ EvalConvMma(const bf16* __restrict__ weight,
                                         const float* __restrict__ bias, int H_, int W_)
      : H(H_), W(W_) {
    mma_operands<EvalLayout>(weight, bias, ops);
  }
  __device__ __forceinline__ void operator()(const Tile& t, const bf16* stage,
                                             bf16* conv) const {
    const int y0 = 2 * t.pr0 - 1, x0 = 2 * t.pc0 - 1;
    conv_tile_mma<EvalLayout>(stage, ops,
                              [&](int p, int ch, float v0, float v1, float v2, float v3) {
                                const bool in = in_image(y0, x0, p, H, W);
                                uint32_t* dst = reinterpret_cast<uint32_t*>(conv + p * EVAL_SCS);
                                dst[ch / 2] = in ? pack2(v0, v1) : BF16_NEG_INF2;
                                dst[ch / 2 + 4] = in ? pack2(v2, v3) : BF16_NEG_INF2;
                              });
  }
};

// Kernel A's persistent walk over the canvas (B, 3, H+2, W+2) bf16: each
// tile staged by stage_canvas, turned into a conv tile by conv(t, stage
// buffer, conv tile) (A's is EvalConvMma), then finish(t, conv tile) in the
// next step.  A's finish is pool_max_relu<EVAL_SCS>.
template <class Conv, class Finish>
__device__ __forceinline__ void eval_walk(const bf16* __restrict__ canvas, int B, int H, int W,
                                          EvalSmem& sm, Conv&& conv, Finish&& finish) {
  const int tiles_x = tiles_x_of(W), tiles_y = tiles_y_of(H);
  const int H2 = H + 2, W2 = W + 2;
  const size_t img_elems = (size_t)3 * H2 * W2;

  walk_tiles<2>(
      B, tiles_x, tiles_y,
      [&](const Tile& t, int buf) {
        stage_canvas(canvas + t.b * img_elems, sm.stage[buf], 2 * t.pr0 - 1, 2 * t.pc0 - 1,
                     H2, W2);
      },
      [&](const Tile& t, int sbuf, int cbuf) { conv(t, sm.stage[sbuf], sm.conv[cbuf]); },
      [&](const Tile& t, int buf) { finish(t, sm.conv[buf]); });
}

// ---- host side -------------------------------------------------------------

// info: registers, local (stack) bytes a thread, static and dynamic shared
// memory a CTA, CTAs of `threads` threads resident on the device (SMs x CTAs
// per SM).  Also sets the kernel's dynamic shared memory limit, which a
// launch above 48 KB needs.
template <class K>
int kernel_info(K kernel, int dyn_smem, int* info, int threads = THREADS) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       dyn_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes a;
  if ((e = cudaFuncGetAttributes(&a, kernel)) != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                         dyn_smem)) != cudaSuccess)
    return static_cast<int>(e);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.localSizeBytes);
  info[2] = static_cast<int>(a.sharedSizeBytes);
  info[3] = dyn_smem;
  info[4] = sms * per_sm;
  return 0;
}

// A launch's grid must be a CTA count in [1, tiles]: the wrapper computes it
// (ops/stem_core.py::num_ctas) from kernel_info's resident count.
inline bool grid_ok(int n_cta, int B, int H, int W) {
  return n_cta >= 1 && n_cta <= B * tiles_x_of(W) * tiles_y_of(H);
}

// Launch a kernel on A's staging and EvalSmem (A, the probe's variants) on
// the persistent grid of n_cta CTAs of `threads` threads; returns a CUDA
// error code.
template <class K>
int launch_eval(K kernel, const void* canvas, const void* weight, const void* bias, void* out,
                int B, int H, int W, int n_cta, void* stream, int threads = THREADS) {
  if (!grid_ok(n_cta, B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(EvalSmem));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_cta, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(canvas), static_cast<const bf16*>(weight),
      static_cast<const float*>(bias), static_cast<bf16*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stem
