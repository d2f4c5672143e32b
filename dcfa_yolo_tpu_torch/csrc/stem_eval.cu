// Fused eval stem for Hopper (sm_90a): conv3x3 s1 (3 -> 16) with eval-BN and
// the /255 input scale folded into the weights, then maxpool 3x3 s2 pad 1,
// then ReLU.  Only the pooled map is written to device memory.
//
// Replaces the TPU kernels of dcfa_yolo_tpu/ops/pallas_stem.py:
//   pallas_stem (_stem_kernel, v2), pallas_stem_d (_stem_kernel_d, v3),
//   pallas_stem_e (_stem_kernel_e, v4) and pallas_stem_f (_stem_kernel_f, v5).
// The four compute one function over four TPU canvas layouts; this kernel
// computes it over the plain zero-bordered canvas and follows the v4/v5
// weight contract (fold_stem_params_e): bf16 weights, a bf16-rounded bias
// held in f32, f32 accumulation, the conv value rounded to bf16 BEFORE the
// max tree (pallas_stem.py:260-264), ReLU after the pool (it absorbs the
// pad: relu(max(S u {pad})) == relu(max(S))).
//
// Contract
//   canvas (B, 3, H+2, W+2) bf16: raw 0..255 pixels, 1-px zero border
//   weight (16, 3, 3, 3) bf16, bias (16,) f32
//   out    (B, H/2, W/2, 16) bf16 (NHWC == NCHW in channels_last); H, W even
//
// Bound (640^2, per image and modality): 3 * 642 * 642 * 2 B = 2.47 MB in,
// 320 * 320 * 16 * 2 B = 3.28 MB out, 640 * 640 * 16 * 27 * 2 = 354 MFLOP.
// max(5.75 MB / 3.35 TB/s, 354 MFLOP / 989 TFLOP/s) = 1.7 us: the function is
// memory-bound on an H100.  The design moves only those bytes: each CTA
// reads its canvas tile plus halo once into shared memory (the halo overlap
// re-reads about 15% of the canvas, mostly from L2), keeps the
// full-resolution conv tile in shared memory, and writes each pooled pixel's
// 16 channels as two 16-byte stores.  The conv runs on CUDA cores in f32
// (the products of 0..255 integers and bf16 weights are exact in f32, so FMA
// contraction does not change them); tensor cores, TMA and a persistent
// schedule are left for a later revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CO = 16;          // stem output channels (phi='n')
constexpr int TH = 8;           // pooled rows per CTA
constexpr int TW = 16;          // pooled cols per CTA
constexpr int CR = 2 * TH + 1;  // conv rows under the tile's pool windows
constexpr int CC = 2 * TW + 1;  // conv cols
constexpr int IR = CR + 2;      // canvas rows incl. the 3x3 halo
constexpr int IC = CC + 2;      // canvas cols
constexpr int THREADS = 256;
static_assert(TH * TW * 2 == THREADS, "one thread per (pooled pixel, 8 channels)");

__global__ void __launch_bounds__(THREADS)
stem_eval_kernel(const __nv_bfloat16* __restrict__ canvas,
                 const __nv_bfloat16* __restrict__ weight,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int H, int W) {
  __shared__ float s_in[3][IR][IC];
  __shared__ float s_w[27][CO];  // [ci*9 + dy*3 + dx][co]
  __shared__ float s_b[CO];
  __shared__ __align__(16) __nv_bfloat16 s_conv[CR * CC][CO];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * TH;  // first pooled row / col of the tile
  const int pc0 = blockIdx.x * TW;
  const int Hp = H / 2, Wp = W / 2;
  const int H2 = H + 2, W2 = W + 2;
  // conv row y reads canvas rows y..y+2; the tile's first pool window starts
  // at conv row 2*pr0 - 1, so canvas rows and conv rows share this origin
  const int y0 = 2 * pr0 - 1, x0 = 2 * pc0 - 1;

  for (int i = tid; i < CO * 27; i += THREADS) {
    s_w[i % 27][i / 27] = __bfloat162float(weight[i]);  // (co, ci, dy, dx)
  }
  if (tid < CO) s_b[tid] = bias[tid];

  const __nv_bfloat16* img = canvas + (size_t)b * 3 * H2 * W2;
  for (int i = tid; i < 3 * IR * IC; i += THREADS) {
    const int ci = i / (IR * IC), r = (i / IC) % IR, c = i % IC;
    const int gy = y0 + r, gx = x0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2)
      v = __bfloat162float(img[((size_t)ci * H2 + gy) * W2 + gx]);
    s_in[ci][r][c] = v;
  }
  __syncthreads();

  // conv tile: one thread per conv position, all 16 channels; positions
  // outside the image are the pool's padding (-inf, never the max)
  for (int p = tid; p < CR * CC; p += THREADS) {
    const int r = p / CC, c = p % CC;
    const int y = y0 + r, x = x0 + c;
    __nv_bfloat16* dst = s_conv[p];
    if (y < 0 || y >= H || x < 0 || x >= W) {
#pragma unroll
      for (int co = 0; co < CO; ++co) dst[co] = __float2bfloat16_rn(-INFINITY);
      continue;
    }
    float in[27];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          in[ci * 9 + dy * 3 + dx] = s_in[ci][r + dy][c + dx];
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 27; ++k) acc = fmaf(in[k], s_w[k][co], acc);
      dst[co] = __float2bfloat16_rn(acc + s_b[co]);
    }
  }
  __syncthreads();

  // pool: thread -> (pooled pixel, half of the channels)
  const int pix = tid >> 1, half = tid & 1;
  const int lr = pix / TW, lc = pix % TW;
  const int pr = pr0 + lr, pc = pc0 + lc;
  if (pr >= Hp || pc >= Wp) return;
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = -INFINITY;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const __nv_bfloat16* src = s_conv[(2 * lr + dy) * CC + 2 * lc + dx] + half * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = fmaxf(m[j], __bfloat162float(src[j]));
    }
  __align__(16) __nv_bfloat16 res[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) res[j] = __float2bfloat16_rn(fmaxf(m[j], 0.f));
  uint4* dst = reinterpret_cast<uint4*>(
      out + (((size_t)b * Hp + pr) * Wp + pc) * CO + half * 8);
  *dst = *reinterpret_cast<const uint4*>(res);
}

}  // namespace

extern "C" int stem_eval_bf16(const void* canvas, const void* weight,
                              const void* bias, void* out, int B, int H, int W,
                              void* stream) {
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  stem_eval_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(canvas),
      static_cast<const __nv_bfloat16*>(weight), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dcfa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
