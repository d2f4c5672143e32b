// Backward of the fused train stem for Hopper (sm_90a): the gradients of
// conv3x3 s1 pad 1 (3 -> 16) -> train-BatchNorm -> ReLU -> maxpool3x3 s2
// pad 1 with respect to the conv kernel, gamma, beta and (when asked) the
// input, for ops/cuda_stem_train.py (kernel C's autograd Function).
//
// Replaces no TPU kernel.  The Pallas train stem has no backward: its VJP
// differentiates the plain decomposition (dcfa_yolo_tpu/ops/
// pallas_stem_train.py:333, _fused_bwd), which XLA fuses into a few passes
// on the TPU.  Eager PyTorch runs the same decomposition as some 40 unfused
// float32 ops a modality at full resolution (420 MB tensors at b16 640^2),
// about a quarter of phi n's b16 train step; this kernel computes the same
// gradients from one read of the input and of the cotangent a pass.
//
// Contract (T = __nv_bfloat16 or float, the compute dtype; one template,
// one C entry with a dtype flag):
//   x        (B, H, W, 3) T NHWC, H and W even
//   weight   (16, 3, 3, 3) T, the conv kernel OIHW in the compute dtype
//   gy       (B, H/2, W/2, 16) T NHWC, the cotangent of the pooled output
//   prm      (7, 16) float: mean, rstd, gamma, beta (pass 1 reads these
//            four), then A, B, C of dc^ = A*dy + B + C*c^ (pass 2)
//   route    (B, H/2, W/2, 16) uint8: each pooled output's first argmax in
//            its window, dy*3 + dx, or 255 where the ReLU drops its
//            cotangent; pass 1 writes it, pass 2 routes by it
//   pass 1   partials (n_cta, 16, 2) double: per CTA [sum dy, sum dy*(c^ -
//            mean)]
//   pass 2   partials (n_cta, 16, 27) double: per CTA dW = sum dc^ (x) patch;
//            dc, where given, (B, H, W, 16) T: dc^ at every conv pixel
//   dx pass  dc and the weight -> dx (B, H, W, 3) T (the transposed taps)
//
// Arithmetic: that of the plain backward it replaces (autograd through
// reference_stem given the forward's moments, the decomposition the JAX VJP
// differentiates).  c^ is recomputed as kernel C's forward computes it
// (tensor cores in bf16, rounded to bf16; one fmaf a tap in float32).  r =
// relu(round_T(((c^ - mean) * rstd) * gamma + beta)) in reference_stem's
// float32 operation order without contraction, so that ties in r resolve
// as the plain version's; each pooled cotangent goes to the first maximum
// of r in its 3x3 s2 pad-1 window in row-major order (the position of
// F.max_pool2d's index) and is dropped where that maximum is 0 (ReLU).  A
// position's routed cotangents are summed in float in row-major window
// order and rounded once to T (the pool's backward in T), giving dy.  The
// wrapper forms dgamma = rstd * sum dy (c^ - mean), dbeta = sum dy and
// A, B, C from the pass-1 totals (all-reduced over a process group there).
// dc^ = fma(C, c^, fma(A, dy, B)) rounded to T (the VJP of c.float()),
// and dW sums dc^ (x) patch in float32 (bf16 products are exact), rounded
// once to T by the wrapper.
//
// Tiles.  The persistent walk of stem_core.cuh over 8x16 pooled tiles.  A
// tile owns the 16x32 conv pixels under its pooled pixels (C's ownership
// rule) and recomputes the conv over 19x35 positions (one conv row and col
// more than the forward's tile on each side it needs): the 9x17 pooled
// windows that cover its owned pixels, so that every owned pixel's dy is
// formed inside the tile with no exchange between CTAs.  Per tile, behind
// barriers: stage (cp.async, double-buffered: the next tile's copy runs
// under this tile's work) -> conv -> route (one item a window and half of
// the channels: pass 1 finds the first argmax of r and writes it to
// `route`, pass 2 reads it back; the cotangent kept, in shared memory) ->
// dy at the owned pixels (pass 1: the per-channel sums in double registers;
// pass 2: dc^ written over c^ in place) -> pass 2: dW as a tensor-core
// product (bf16: mma m16n8k16, M = 16 channels, N = 32 taps, K = the 512
// owned positions; float32: one fmaf a product on the CUDA cores, 4x4
// blocks a thread).  The sums and dW stay in registers across a CTA's tiles
// and reach device memory once a CTA, reduced in a fixed order; no atomics,
// so two launches give equal bits.
//
// Bound at b16 640^2, one modality, bf16: one read of x (39.3 MB) and of gy
// (52.4 MB) and the write of dW: 91.7 MB, 27 us at 3.35 TB/s; the three
// conv-sized products (the conv, recomputed, and dW; dx when asked) are
// about 17 GFLOP, 17 us at the bf16 peak.  The design reads x and gy once
// a pass (twice in all, plus the 1.2x halo of the windows) and keeps c^, r
// and dc^ in shared memory: of full resolution only the routing (one byte a
// pooled output, 26 MB) reaches device memory, unless dx is asked for.

#include <type_traits>

#include "stem_core.cuh"

namespace {

using namespace stem;

constexpr int GR = 2 * TH + 3;     // conv rows recomputed a tile (19)
constexpr int GC = 2 * TW + 3;     // conv cols (35)
constexpr int GPOS = GR * GC;      // conv positions a tile (665)
constexpr int GIR = GR + 2;        // input rows staged (21)
constexpr int GROWE = 112;         // staged elements an input row: 37 pixels x 3, even
constexpr int WR = TH + 1;         // pooled windows over the owned pixels: 9 rows
constexpr int WC = TW + 1;         // 17 cols
constexpr int NWIN = WR * WC;
constexpr int OWN_C = 2 * TW;      // owned conv pixels: 16 rows x 32 cols
constexpr int NOWN = 2 * TH * OWN_C;
constexpr int NK = CO * 27;        // dW entries
constexpr uint8_t NO_ROUTE = 0xFF;

// float32 instantiation's weights, (co, ci, dy, dx), written on the
// launch's stream just before it (ops/cuda_stem_train.py orders float32
// launches from different streams)
__constant__ float g_weight[CO * 27];

// conv position p = (r, c) of the tile, r, c from 0, is the conv pixel (2*pr0
// - 1 + r, 2*pc0 - 1 + c); its 3x3 patch starts at staged input row r, pixel
// c, the input staged from pixel (2*pr0 - 2, 2*pc0 - 2)
struct GradLayout {
  __device__ __forceinline__ static int tap(int k) {  // k = ci*9 + dy*3 + dx
    return k / 9 + ((k % 9) / 3) * GROWE + (k % 3) * 3;
  }
  __device__ __forceinline__ static int base(int p) { return (p / GC) * GROWE + (p % GC) * 3; }
};

template <typename T>
struct GradSmem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int SCS = kF32 ? 20 : 24;  // conv tile elements a position, as C's
  alignas(16) T conv[GPOS * SCS];             // c^, then dc^ at the owned positions
  alignas(16) T stage[2][GIR * GROWE];
  float route_g[NWIN * CO];                   // a window's kept cotangent, 0 if dropped
  uint8_t route_i[NWIN * CO];                 // its first argmax dy*3 + dx
  float prm[7 * CO];
};
// after the walk, the conv tile holds the CTA's reductions
static_assert(sizeof(GradSmem<bf16>::conv) >= WARPS * CO * 32 * sizeof(float), "dW scratch");
static_assert(sizeof(GradSmem<float>::conv) >= 9 * 28 * 16 * sizeof(float), "dW scratch");

// A pool item's 8 channels: element j of half h's Pack8 is channel
// chan<T>(h, j) (stem_core.cuh, Pack8)
template <typename T>
__device__ __forceinline__ int chan(int h, int j) {
  if constexpr (std::is_same<T, float>::value) return j < 4 ? 4 * h + j : 4 + 4 * h + j;
  return 8 * h + j;
}

__device__ __forceinline__ void to_float(const Pack8<float>& p, float (&f)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = p.v[j];
}

__device__ __forceinline__ void to_float(const Pack8<bf16>& p, float (&f)[8]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float2 v = unpack2(p.w[m]);
    f[2 * m] = v.x, f[2 * m + 1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ Pack8<T> from_float(const float (&f)[8]) {  // rounded to T
  Pack8<T> p;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < 8; ++j) p.v[j] = f[j];
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) p.w[m] = pack2(f[2 * m], f[2 * m + 1]);
  }
  return p;
}

// the route bytes of a pool item's 8 channels, in Pack8 order
template <typename T>
__device__ __forceinline__ void load_route(const uint8_t* pixel, int h, uint32_t (&r)[8]) {
  uint32_t lo, hi;
  if constexpr (std::is_same<T, float>::value) {
    lo = *reinterpret_cast<const uint32_t*>(pixel + 4 * h);
    hi = *reinterpret_cast<const uint32_t*>(pixel + 8 + 4 * h);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(pixel + 8 * h);
    lo = v.x, hi = v.y;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = (lo >> (8 * j)) & 0xFFu, r[4 + j] = (hi >> (8 * j)) & 0xFFu;
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int PASS>
__global__ void __launch_bounds__(THREADS, 2)
stem_grad_kernel(const T* __restrict__ x, const T* __restrict__ weight, const T* __restrict__ gy,
                 const float* __restrict__ prm, double* __restrict__ partials, T* __restrict__ dc,
                 uint8_t* __restrict__ route, int B, int H, int W) {
  typedef GradSmem<T> Smem;
  constexpr bool kF32 = Smem::kF32;
  constexpr int SCS = Smem::SCS, KH = Pack8<T>::kHalf;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tiles_x = tiles_x_of(W), tiles_y = tiles_y_of(H);
  const int Hp = H / 2, Wp = W / 2;
  const size_t img_elems = (size_t)H * W * 3;
  const int half = threadIdx.x & 1;  // every item of this thread: THREADS is even
  for (int i = threadIdx.x; i < (PASS == 1 ? 4 : 7) * CO; i += THREADS) sm.prm[i] = prm[i];
  const float* s_mean = sm.prm;
  const float* s_rstd = sm.prm + CO;
  const float* s_gamma = sm.prm + 2 * CO;
  const float* s_beta = sm.prm + 3 * CO;

  MmaOperands ops;
  if constexpr (!kF32) mma_operands<GradLayout>(weight, nullptr, ops);
  double s1[8], s2[8];  // pass 1: sum dy, sum dy (c^ - mean) of chan(half, j)
  float acc[4][4];      // pass 2: this thread's dW fragment
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  int sbuf_cur = 0;  // the stage buffer of the tile being finished

  walk_tiles<1>(
      B, tiles_x, tiles_y,
      [&](const Tile& t, int buf) {
        stage_nhwc<GROWE, GIR>(x + t.b * img_elems, sm.stage[buf], 2 * t.pr0 - 2,
                               2 * t.pc0 - 2, H, W);
      },
      [&](const Tile& t, int sbuf, int) {
        sbuf_cur = sbuf;
        if constexpr (kF32) {
          conv_tile_fma<GradLayout, GPOS>(
              sm.stage[sbuf], [](int co, int k) { return g_weight[co * 27 + k]; },
              [&](int p, int g, float a0, float a1, float a2, float a3) {
                *reinterpret_cast<float4*>(sm.conv + p * SCS + 4 * g) =
                    make_float4(a0, a1, a2, a3);
              });
        } else {
          conv_tile_mma<GradLayout, GPOS>(
              sm.stage[sbuf], ops, [&](int p, int c, float v0, float v1, float v2, float v3) {
                uint32_t* dst = reinterpret_cast<uint32_t*>(sm.conv + p * SCS);
                dst[c / 2] = pack2(v0, v1);
                dst[c / 2 + 4] = pack2(v2, v3);
              });
        }
      },
      [&](const Tile& t, int) {
        // route: the first argmax of r in each window, and its cotangent
        for (int item = threadIdx.x; item < 2 * NWIN; item += THREADS) {
          const int w = item >> 1, wr = w / WC, wc = w % WC;
          const int pr = t.pr0 + wr, pc = t.pc0 + wc;
          float* rg = sm.route_g + w * CO;
          uint8_t* ri = sm.route_i + w * CO;
          if (pr >= Hp || pc >= Wp) {
#pragma unroll
            for (int j = 0; j < 8; ++j) rg[chan<T>(half, j)] = 0.f, ri[chan<T>(half, j)] = NO_ROUTE;
            continue;
          }
          const size_t o = (((size_t)t.b * Hp + pr) * Wp + pc) * CO;
          Pack8<T> g;
          g.load(gy + o + half * KH);
          float gf[8];
          to_float(g, gf);
          uint32_t at[8];
          if constexpr (PASS == 1) {
            float best[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) best[j] = -INFINITY, at[j] = 0;
            // only a window's top row and left col can lie outside (H, W even)
            const int y_lo = pr == 0, x_lo = pc == 0;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              if (dy < y_lo) continue;
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                if (dx < x_lo) continue;
                Pack8<T> v;
                v.load(sm.conv + ((2 * wr + dy) * GC + 2 * wc + dx) * SCS + half * KH);
                float c[8];
                to_float(v, c);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  const int ch = chan<T>(half, j);
                  const float y = __fadd_rn(
                      __fmul_rn(__fmul_rn(__fsub_rn(c[j], s_mean[ch]), s_rstd[ch]), s_gamma[ch]),
                      s_beta[ch]);
                  const float r = fmaxf(round_to<T>(y), 0.f);
                  if (r > best[j]) best[j] = r, at[j] = dy * 3 + dx;
                }
              }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (!(best[j] > 0.f)) at[j] = NO_ROUTE;
              if (wr < TH && wc < TW) route[o + chan<T>(half, j)] = static_cast<uint8_t>(at[j]);
            }
          } else {
            load_route<T>(route + o, half, at);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ch = chan<T>(half, j);
            rg[ch] = at[j] == NO_ROUTE ? 0.f : gf[j];
            ri[ch] = static_cast<uint8_t>(at[j]);
          }
        }
        __syncthreads();
        // dy at the owned pixels: the cotangents routed to them, rounded to T
        for (int q = threadIdx.x >> 1; q < NOWN; q += THREADS / 2) {
          const int orow = q / OWN_C, ocol = q % OWN_C;
          const int Y = 2 * t.pr0 + orow, X = 2 * t.pc0 + ocol;
          T* cp = sm.conv + ((orow + 1) * GC + ocol + 1) * SCS + half * KH;
          const bool in = Y < H && X < W;
          float d[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) d[j] = 0.f;
          if (in) {
            // an even conv row lies in one window (at its centre), an odd one
            // in two (the lower edge of one, the upper of the next)
            const int wr_a = orow >> 1, wc_a = ocol >> 1;
            const int nr = 1 + (orow & 1), nc = 1 + (ocol & 1);
            for (int i = 0; i < nr; ++i)
              for (int k = 0; k < nc; ++k) {
                const int w = (wr_a + i) * WC + wc_a + k;
                const uint8_t at = static_cast<uint8_t>(
                    ((orow & 1) ? 2 - 2 * i : 1) * 3 + ((ocol & 1) ? 2 - 2 * k : 1));
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  const int ch = chan<T>(half, j);
                  if (sm.route_i[w * CO + ch] == at) d[j] += sm.route_g[w * CO + ch];
                }
              }
#pragma unroll
            for (int j = 0; j < 8; ++j) d[j] = round_to<T>(d[j]);
          }
          Pack8<T> v;
          v.load(cp);
          float c[8];
          to_float(v, c);
          if constexpr (PASS == 1) {
            if (in) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int ch = chan<T>(half, j);
                s1[j] += d[j];
                s2[j] += static_cast<double>(d[j]) * __fsub_rn(c[j], s_mean[ch]);
              }
            }
          } else {
            float g[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int ch = chan<T>(half, j);
              g[j] = in ? fmaf(sm.prm[6 * CO + ch], c[j],
                               fmaf(sm.prm[4 * CO + ch], d[j], sm.prm[5 * CO + ch]))
                        : 0.f;
            }
            const Pack8<T> o = from_float<T>(g);
            o.store(cp);
            if (dc != nullptr && in) o.store(dc + (((size_t)t.b * H + Y) * W + X) * CO + half * KH);
          }
        }
        if constexpr (PASS == 2) {
          __syncthreads();
          const T* st = sm.stage[sbuf_cur];
          if constexpr (kF32) {
            // thread (cell, grp): channels 4cb .. 4cb + 3 by taps 4tb .. 4tb + 3
            // (tap 27 is zero) over the positions grp, grp + 9, ...
            if (threadIdx.x < 9 * 28) {
              const int cell = threadIdx.x % 28, grp = threadIdx.x / 28;
              const int cb = cell / 7, tb = cell % 7;
              int toff[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) toff[i] = 4 * tb + i < 27 ? GradLayout::tap(4 * tb + i) : -1;
              for (int q = grp; q < NOWN; q += 9) {
                const int orow = q / OWN_C, ocol = q % OWN_C;
                const int p = (orow + 1) * GC + ocol + 1;
                const float4 d4 = *reinterpret_cast<const float4*>(sm.conv + p * SCS + 4 * cb);
                const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
                const float* src = st + GradLayout::base(p);
                float pt[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) pt[i] = toff[i] >= 0 ? src[toff[i]] : 0.f;
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                  for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dv[i], pt[j], acc[i][j]);
              }
            }
          } else {
            // warp w: k16 steps s = w, w + 8, ... of K = the owned positions;
            // A = dc^ transposed (16 channels x 16 positions), B = the
            // patches (16 positions x 8 taps) of n8 tile j = taps 8j .. 8j + 7
            const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
            const int g = lane >> 2, t4 = lane & 3;
            const uint16_t* cv = reinterpret_cast<const uint16_t*>(sm.conv);
            const uint16_t* sv = reinterpret_cast<const uint16_t*>(st);
            int toff[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) toff[j] = 8 * j + g < 27 ? GradLayout::tap(8 * j + g) : -1;
            for (int s = warp; s < NOWN / 16; s += WARPS) {
              const int orow = (16 * s) / OWN_C, oc0 = (16 * s) % OWN_C;
              const int p0 = (orow + 1) * GC + oc0 + 1;  // the step's first position
              auto dcv = [&](int i, int co) {
                return static_cast<uint32_t>(cv[(p0 + i) * SCS + co]);
              };
              auto pv = [&](int i, int j) {
                return toff[j] < 0 ? 0u
                                   : static_cast<uint32_t>(sv[GradLayout::base(p0 + i) + toff[j]]);
              };
              const uint32_t a[4] = {dcv(2 * t4, g) | dcv(2 * t4 + 1, g) << 16,
                                     dcv(2 * t4, g + 8) | dcv(2 * t4 + 1, g + 8) << 16,
                                     dcv(2 * t4 + 8, g) | dcv(2 * t4 + 9, g) << 16,
                                     dcv(2 * t4 + 8, g + 8) | dcv(2 * t4 + 9, g + 8) << 16};
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_16816(acc[j], a, pv(2 * t4, j) | pv(2 * t4 + 1, j) << 16,
                          pv(2 * t4 + 8, j) | pv(2 * t4 + 9, j) << 16);
            }
          }
        }
      });

  // the CTA's partial, reduced in a fixed order (the conv tile is free now)
  if constexpr (PASS == 1) {
    int ch[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) ch[j] = chan<T>(half, j);
    sums_write<2>(s1, s2, ch, reinterpret_cast<double*>(sm.conv),
                  partials + (size_t)blockIdx.x * 2 * CO);
  } else {
    float* red = reinterpret_cast<float*>(sm.conv);
    if constexpr (kF32) {
      if (threadIdx.x < 9 * 28)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) red[threadIdx.x * 16 + 4 * i + j] = acc[i][j];
      __syncthreads();
      for (int e = threadIdx.x; e < NK; e += THREADS) {
        const int co = e / 27, k = e % 27;
        const int cell = (co / 4) * 7 + k / 4, slot = 4 * (co % 4) + k % 4;
        double s = 0.0;
        for (int grp = 0; grp < 9; ++grp) s += red[(grp * 28 + cell) * 16 + slot];
        partials[(size_t)blockIdx.x * NK + e] = s;
      }
    } else {
      // warp w's fragment: acc[j][0..1] channel g, taps 8j + 2t, +1; [2..3]
      // channel g + 8
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int g = lane >> 2, t4 = lane & 3;
      float* mine = red + warp * CO * 32;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 8 * j + 2 * t4;
        mine[g * 32 + k] = acc[j][0];
        mine[g * 32 + k + 1] = acc[j][1];
        mine[(g + 8) * 32 + k] = acc[j][2];
        mine[(g + 8) * 32 + k + 1] = acc[j][3];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < NK; e += THREADS) {
        const int co = e / 27, k = e % 27;
        double s = 0.0;
        for (int w = 0; w < WARPS; ++w) s += red[(w * CO + co) * 32 + k];
        partials[(size_t)blockIdx.x * NK + e] = s;
      }
    }
  }
}

// dx from dc^: dx(y, x, ci) = sum over (ky, kx, co) of dc^(y - ky + 1, x - kx
// + 1, co) * w(co, ci, ky, kx), in float in that order, rounded once to T.
// One thread a pixel, a grid-stride loop; only where dx is asked for.
template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_grad_dx_kernel(const T* __restrict__ dc, const T* __restrict__ weight, T* __restrict__ dx,
                    int B, int H, int W) {
  __shared__ float w[CO * 27];
  for (int i = threadIdx.x; i < CO * 27; i += THREADS) {
    if constexpr (std::is_same<T, float>::value) w[i] = weight[i];
    else w[i] = __bfloat162float(weight[i]);
  }
  __syncthreads();
  const long long n = (long long)B * H * W;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const int xq = static_cast<int>(i % W), yq = static_cast<int>((i / W) % H);
    const long long b = i / ((long long)H * W);
    float a[3] = {0.f, 0.f, 0.f};
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = yq - ky + 1;
      if (yy < 0 || yy >= H) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = xq - kx + 1;
        if (xx < 0 || xx >= W) continue;
        const T* src = dc + ((b * H + yy) * W + xx) * CO;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          Pack8<T> v;
          v.load(src + h * Pack8<T>::kHalf);
          float f[8];
          to_float(v, f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int co = chan<T>(h, j);
#pragma unroll
            for (int ci = 0; ci < 3; ++ci) a[ci] = fmaf(f[j], w[co * 27 + ci * 9 + ky * 3 + kx], a[ci]);
          }
        }
      }
    }
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      if constexpr (std::is_same<T, float>::value) dx[i * 3 + ci] = a[ci];
      else dx[i * 3 + ci] = __float2bfloat16_rn(a[ci]);
    }
  }
}

template <typename T, int PASS>
int info(int* out) {
  return kernel_info(stem_grad_kernel<T, PASS>, static_cast<int>(sizeof(GradSmem<T>)), out);
}

template <typename T, int PASS>
int launch(const void* x, const void* weight, const void* gy, const void* prm, void* partials,
           void* dc, void* route, int B, int H, int W, int n_cta, void* stream) {
  if (!grid_ok(n_cta, B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(GradSmem<T>));
  cudaError_t e = cudaFuncSetAttribute(stem_grad_kernel<T, PASS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (std::is_same<T, float>::value) {
    e = cudaMemcpyToSymbolAsync(g_weight, weight, sizeof(g_weight), 0, cudaMemcpyDeviceToDevice,
                                st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  stem_grad_kernel<T, PASS><<<n_cta, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), static_cast<const T*>(gy),
      static_cast<const float*>(prm), static_cast<double*>(partials), static_cast<T*>(dc),
      static_cast<uint8_t*>(route), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dx(const void* dc, const void* weight, void* dx, int B, int H, int W, int blocks,
              void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  stem_grad_dx_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dc), static_cast<const T*>(weight), static_cast<T*>(dx), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// info[5] of pass 1 or 2 of the bf16 (f32 == 0) or float32 kernel, as
// stem_train_info's; returns a CUDA error code.
extern "C" int stem_grad_info(int f32, int pass, int* out) {
  if (f32) return pass == 1 ? info<float, 1>(out) : info<float, 2>(out);
  return pass == 1 ? info<bf16, 1>(out) : info<bf16, 2>(out);
}

// Pass 1 or 2 (the contract above) on the persistent grid of n_cta CTAs.
extern "C" int stem_grad(int f32, int pass, const void* x, const void* weight, const void* gy,
                         const void* prm, void* partials, void* dc, void* route, int B, int H,
                         int W, int n_cta, void* stream) {
  if (pass != 1 && pass != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (f32)
    return pass == 1 ? launch<float, 1>(x, weight, gy, prm, partials, dc, route, B, H, W, n_cta, stream)
                     : launch<float, 2>(x, weight, gy, prm, partials, dc, route, B, H, W, n_cta, stream);
  return pass == 1 ? launch<bf16, 1>(x, weight, gy, prm, partials, dc, route, B, H, W, n_cta, stream)
                   : launch<bf16, 2>(x, weight, gy, prm, partials, dc, route, B, H, W, n_cta, stream);
}

extern "C" int stem_grad_dx(int f32, const void* dc, const void* weight, void* dx, int B, int H,
                            int W, int blocks, void* stream) {
  return f32 ? launch_dx<float>(dc, weight, dx, B, H, W, blocks, stream)
             : launch_dx<bf16>(dc, weight, dx, B, H, W, blocks, stream);
}
