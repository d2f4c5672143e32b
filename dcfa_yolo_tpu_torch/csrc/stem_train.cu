// Fused train stem for Hopper (sm_90a): conv3x3 s1 pad 1 (3 -> 16) without
// any BN fold, the conv value c^ (rounded to bf16 in the bf16 instantiation,
// kept in float32 in the float32 one), then from c^ in one pass: maxpool3x3
// s2 pad 1, minpool3x3 s2 pad 1, and the per-channel sums of c^ and c^^2
// over the batch.  The full-resolution conv output never reaches device
// memory.  Train-BN needs the batch statistics before it can normalize; the
// pool commutes with the per-channel affine a*c+b up to the sign of a, so the
// wrapper (ops/cuda_stem_train.py) applies BN and ReLU at pool resolution,
// picking the max or the min pool by sign(gamma).
//
// Replaces the TPU kernel dcfa_yolo_tpu/ops/pallas_stem_train.py:
//   fused_train_stem -> _fused_fwd_impl -> _stem_pool_stats ->
//   _train_stem_kernel (same function, not a block-by-block carry-over), at
//   both of its compute dtypes: bf16 rounds the conv output
//   (pallas_stem_train.py:116-120), float32 skips that rounding.
//
// Contract (T = __nv_bfloat16 or float; one template, two C entries)
//   x        (B, H, W, 3) T NHWC (the model's input; the zero halo comes
//            from bounds checks, so there is no pad or transpose pass)
//   weight   (16, 3, 3, 3) T, the conv kernel OIHW
//   pmax     (B, H/2, W/2, 16) T NHWC,  pmin likewise
//   partials (n_cta, 16, 2) f32: per-CTA [sum c^, sum c^^2] per channel;
//            the wrapper reduces them in a fixed order.  H and W even.
//
// Numerics: f32 accumulation in one fixed order, k = ci*9 + dy*3 + dx, each
// step an fmaf.  In bf16 the products are exact in f32, so contraction does
// not change them, and c^ is rounded to bf16 BEFORE both pools and both
// sums.  In float32 the fmaf order is what it is: the result is not bit-equal
// to cuDNN's float32 conv (another summation order), only within a few ulp
// of max|c^|.  Pool padding is skipped by bounds checks; with pad 1, stride 2
// and even H, W every window holds at least 4 real pixels.  The sums are
// deterministic: per-thread register sums, a fixed warp-shuffle tree, and a
// fixed order over the warps; no float atomics.
//
// Each conv pixel is counted exactly once in the sums: a CTA owns the conv
// rows [2*pr0, 2*pr0 + 2*TH) and columns [2*pc0, 2*pc0 + 2*TW) of its tile;
// the halo row and column 2*pr0 - 1, 2*pc0 - 1 that its pool windows also
// read belong to the tiles above and to the left.
//
// Bound at b16 640^2, one modality, bf16: 39.3 MB of input + 104.9 MB of
// pooled maps = 144.2 MB, 43.0 us at 3.35 TB/s; 5.66 GFLOP, 5.7 us at 989
// TFLOP/s bf16.  float32: 78.6 MB + 209.7 MB = 288.4 MB, 86.1 us; 5.66 GFLOP
// on the CUDA cores at 67 TFLOP/s, 84.5 us: bytes-bound, barely.  This first
// version multiplies on the CUDA cores in f32 at both dtypes: each CTA loads
// its input tile plus halo once into shared memory, keeps the 17x33 conv tile
// (in T) in shared memory, and writes each pooled pixel's 16 channels as
// 16-byte stores (one per 8 channels in bf16, two in float32).  Shared
// memory: bf16 28.7 KB, float32 46.6 KB (static, under the 48 KB limit).  The
// 432 weights stay in shared memory and are re-read inside the loop (an
// opaque zero offset stops the compiler from hoisting them into registers,
// which made kernel A spill).  Tensor cores, TMA and a persistent schedule
// are left for a later revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int CO = 16;          // stem output channels (phi='n')
constexpr int TH = 8;           // pooled rows per CTA
constexpr int TW = 16;          // pooled cols per CTA
constexpr int CR = 2 * TH + 1;  // conv rows under the tile's pool windows
constexpr int CC = 2 * TW + 1;  // conv cols
constexpr int IR = CR + 2;      // input rows incl. the 3x3 halo
constexpr int IC = CC + 2;      // input cols
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(TH * TW * 2 == THREADS, "one thread per (pooled pixel, 8 channels)");

// bf16 pairs <-> 32-bit words, kept in registers (no local arrays)
__device__ __forceinline__ uint32_t pack2(float a, float b) {
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
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_train_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                  T* __restrict__ pmax, T* __restrict__ pmin,
                  float* __restrict__ partials, int H, int W) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  __shared__ float s_in[3][IR][IC];
  __shared__ __align__(16) float s_w[27][CO];  // [ci*9 + dy*3 + dx][co]
  __shared__ __align__(16) T s_conv[CR * CC][CO];
  __shared__ float s_red[WARPS][2 * CO];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * TH;  // first pooled row / col of the tile
  const int pc0 = blockIdx.x * TW;
  const int Hp = H / 2, Wp = W / 2;
  // conv row of local row 0 (the tile's first pool window starts there);
  // local conv row r reads input rows y0 + r - 1 .. y0 + r + 1
  const int y0 = 2 * pr0 - 1, x0 = 2 * pc0 - 1;

  for (int i = tid; i < CO * 27; i += THREADS) {
    s_w[i % 27][i / 27] = to_float(weight[i]);  // (co, ci, dy, dx)
  }
  const T* img = x + (size_t)b * H * W * 3;
  // channel-fastest order: neighbouring threads read neighbouring bytes
  for (int i = tid; i < IR * IC * 3; i += THREADS) {
    const int ci = i % 3, c = (i / 3) % IC, r = i / (3 * IC);
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_float(img[((size_t)gy * W + gx) * 3 + ci]);
    s_in[ci][r][c] = v;
  }
  __syncthreads();

  float sum[CO], sq[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) sum[co] = sq[co] = 0.f;

  const float4* s_w4 = reinterpret_cast<const float4*>(&s_w[0][0]);
  for (int p = tid; p < CR * CC; p += THREADS) {
    const int r = p / CC, c = p % CC;
    const int y = y0 + r, xx = x0 + c;
    if (y < 0 || y >= H || xx < 0 || xx >= W) continue;  // pool padding
    float in[27];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          in[ci * 9 + dy * 3 + dx] = s_in[ci][r + dy][c + dx];
    // opaque zero: keeps the weight reads inside this loop
    int off = 0;
    asm volatile("" : "+r"(off));
    const bool owned = r >= 1 && c >= 1;
    if constexpr (kF32) {  // c^ in float32: sums and the tile straight away
      float4* dst = reinterpret_cast<float4*>(s_conv[p]);
#pragma unroll
      for (int g = 0; g < CO / 4; ++g) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int k = 0; k < 27; ++k) {
          const float4 w4 = s_w4[k * (CO / 4) + g + off];
          a0 = fmaf(in[k], w4.x, a0);
          a1 = fmaf(in[k], w4.y, a1);
          a2 = fmaf(in[k], w4.z, a2);
          a3 = fmaf(in[k], w4.w, a3);
        }
        if (owned) {
          sum[4 * g] += a0;
          sum[4 * g + 1] += a1;
          sum[4 * g + 2] += a2;
          sum[4 * g + 3] += a3;
          sq[4 * g] = fmaf(a0, a0, sq[4 * g]);
          sq[4 * g + 1] = fmaf(a1, a1, sq[4 * g + 1]);
          sq[4 * g + 2] = fmaf(a2, a2, sq[4 * g + 2]);
          sq[4 * g + 3] = fmaf(a3, a3, sq[4 * g + 3]);
        }
        dst[g] = make_float4(a0, a1, a2, a3);
      }
    } else {  // c^ rounded to bf16 before the sums and the tile
      uint32_t pk[CO / 2];  // two bf16 channels a word
#pragma unroll
      for (int g = 0; g < CO / 4; ++g) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int k = 0; k < 27; ++k) {
          const float4 w4 = s_w4[k * (CO / 4) + g + off];
          a0 = fmaf(in[k], w4.x, a0);
          a1 = fmaf(in[k], w4.y, a1);
          a2 = fmaf(in[k], w4.z, a2);
          a3 = fmaf(in[k], w4.w, a3);
        }
        pk[2 * g] = pack2(a0, a1);
        pk[2 * g + 1] = pack2(a2, a3);
      }
      if (owned) {
#pragma unroll
        for (int j = 0; j < CO / 2; ++j) {
          const float2 f = unpack2(pk[j]);
          sum[2 * j] += f.x;
          sum[2 * j + 1] += f.y;
          sq[2 * j] = fmaf(f.x, f.x, sq[2 * j]);
          sq[2 * j + 1] = fmaf(f.y, f.y, sq[2 * j + 1]);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(s_conv[p]);
      dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
  }

  // per-CTA sums: fixed shuffle tree per warp, then a fixed order over warps
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int co = 0; co < CO; ++co) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum[co] += __shfl_xor_sync(0xffffffffu, sum[co], o);
      sq[co] += __shfl_xor_sync(0xffffffffu, sq[co], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      s_red[warp][2 * co] = sum[co];
      s_red[warp][2 * co + 1] = sq[co];
    }
  }
  __syncthreads();
  if (tid < 2 * CO) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += s_red[w][tid];
    const size_t cta = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partials[cta * 2 * CO + tid] = t;
  }

  // pools: thread -> (pooled pixel, half of the channels)
  const int pix = tid >> 1, half = tid & 1;
  const int lr = pix / TW, lc = pix % TW;
  const int pr = pr0 + lr, pc = pc0 + lc;
  if (pr >= Hp || pc >= Wp) return;
  float mx[8], mn[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[j] = -INFINITY;
    mn[j] = INFINITY;
  }
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int y = 2 * pr - 1 + dy;
    if (y < 0 || y >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = 2 * pc - 1 + dx;
      if (xx < 0 || xx >= W) continue;
      const T* src = s_conv[(2 * lr + dy) * CC + 2 * lc + dx] + half * 8;
      if constexpr (kF32) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 f = s4[j];
          mx[4 * j] = fmaxf(mx[4 * j], f.x);
          mx[4 * j + 1] = fmaxf(mx[4 * j + 1], f.y);
          mx[4 * j + 2] = fmaxf(mx[4 * j + 2], f.z);
          mx[4 * j + 3] = fmaxf(mx[4 * j + 3], f.w);
          mn[4 * j] = fminf(mn[4 * j], f.x);
          mn[4 * j + 1] = fminf(mn[4 * j + 1], f.y);
          mn[4 * j + 2] = fminf(mn[4 * j + 2], f.z);
          mn[4 * j + 3] = fminf(mn[4 * j + 3], f.w);
        }
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = unpack2(words[j]);
          mx[2 * j] = fmaxf(mx[2 * j], f.x);
          mx[2 * j + 1] = fmaxf(mx[2 * j + 1], f.y);
          mn[2 * j] = fminf(mn[2 * j], f.x);
          mn[2 * j + 1] = fminf(mn[2 * j + 1], f.y);
        }
      }
    }
  }
  const size_t o = (((size_t)b * Hp + pr) * Wp + pc) * CO + half * 8;
  if constexpr (kF32) {  // 32 B per map: two 16-byte stores each
    float4* dmax = reinterpret_cast<float4*>(pmax + o);
    float4* dmin = reinterpret_cast<float4*>(pmin + o);
    dmax[0] = make_float4(mx[0], mx[1], mx[2], mx[3]);
    dmax[1] = make_float4(mx[4], mx[5], mx[6], mx[7]);
    dmin[0] = make_float4(mn[0], mn[1], mn[2], mn[3]);
    dmin[1] = make_float4(mn[4], mn[5], mn[6], mn[7]);
  } else {
    // re-rounding is exact: the extrema are bf16 values
    *reinterpret_cast<uint4*>(pmax + o) =
        make_uint4(pack2(mx[0], mx[1]), pack2(mx[2], mx[3]),
                   pack2(mx[4], mx[5]), pack2(mx[6], mx[7]));
    *reinterpret_cast<uint4*>(pmin + o) =
        make_uint4(pack2(mn[0], mn[1]), pack2(mn[2], mn[3]),
                   pack2(mn[4], mn[5]), pack2(mn[6], mn[7]));
  }
}

dim3 grid_of(int B, int H, int W) {
  return dim3((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
}

template <typename T>
int launch(const void* x, const void* weight, void* pmax, void* pmin,
           void* partials, int B, int H, int W, void* stream) {
  stem_train_kernel<T><<<grid_of(B, H, W), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight),
      static_cast<T*>(pmax), static_cast<T*>(pmin),
      static_cast<float*>(partials), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stem_train_num_ctas(int B, int H, int W) {
  const dim3 g = grid_of(B, H, W);
  return static_cast<int>(g.x * g.y * g.z);
}

extern "C" int stem_train_bf16(const void* x, const void* weight, void* pmax,
                               void* pmin, void* partials, int B, int H, int W,
                               void* stream) {
  return launch<__nv_bfloat16>(x, weight, pmax, pmin, partials, B, H, W,
                               stream);
}

extern "C" int stem_train_f32(const void* x, const void* weight, void* pmax,
                              void* pmin, void* partials, int B, int H, int W,
                              void* stream) {
  return launch<float>(x, weight, pmax, pmin, partials, B, H, W, stream);
}
