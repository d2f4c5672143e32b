// Stem split probe for Hopper (sm_90a): variants of the fused eval stem
// (kernel A, csrc/stem_eval.cu) that drop or overlap one of its phases, so
// that their times split kernel A's time into tile load, conv and pool tree.
// "Kernel A" below is its first design (one CTA a tile, the conv as f32
// FMAs on the CUDA cores), which these variants keep; kernel A itself now
// sums its conv on the tensor cores (csrc/stem_core.cuh), so dblbuf and pipe
// agree with it in the v4 class and bit for bit with each other.
//
// Replaces the TPU probe kernels of tools/stem_split_probe.py: make_kernel
// (variants dots, vpu, dblbuf) and pipe_kernel (variant pipe), called by
// `call`.  The probe's `full` variant is kernel A itself (stem_eval_bf16);
// this file holds the other four:
//   conv   (JAX `dots`): load + conv + bf16 round; writes the conv value at
//          conv position (2i, 2j) of each pooled pixel (i, j), no pool tree,
//          no ReLU.
//   pool   (JAX `vpu`): load + pool tree + ReLU + stores, with the 27x16 FMAs
//          of each conv position replaced by the centre tap's three channels
//          and the bias, bf16(((c0 + c1) + c2) + bias[co]) in f32, which keeps
//          the whole tile load and the tree live.  (The JAX `vpu` value is an
//          iota construct for the TPU compiler's layout pass and has no
//          meaning here.)
//   dblbuf (JAX `dblbuf`): kernel A with a persistent grid; each CTA walks a
//          list of tiles and copies the next tile's canvas into a second
//          shared-memory buffer with cp.async while the current tile runs
//          conv and pool.  Bit-identical to pipe.
//   pipe   (JAX `pipe`): kernel A software-pipelined by warp specialisation:
//          warps 0-3 load and convolve tile k+1 into one of two conv slots
//          while warps 4-7 pool tile k from the other, ordered by named
//          barriers (bar.sync / bar.arrive).  Bit-identical to dblbuf.
//
// All four keep kernel A's tile geometry (8x16 pooled pixels per tile, 256
// threads), its conv arithmetic (f32 FMAs in the same order, so the conv
// values are bit-identical) and its pool code; only the phase a variant
// drops or overlaps changes.  Inputs and outputs are kernel A's, so the
// bytes moved are the same in every variant (pool alone reads no weights):
//   canvas (B, 3, H+2, W+2) bf16, weight (16, 3, 3, 3) bf16, bias (16,) f32
//   out    (B, H/2, W/2, 16) bf16 NHWC; H, W even.
// Each variant's bound: tools/stem_split_probe.py::variant_bound.
//
// Staging.  conv and pool stage the canvas tile as f32, as kernel A does
// (s_in[3][19][35], 7,980 B).  cp.async copies raw bytes, so dblbuf and pipe
// stage bf16 and convert at use.  The tile's first canvas column
// x0 = 2*pc0 - 1 is odd and canvas rows are W+2 elements long, so only
// 4-byte copies are aligned: each staged row starts at the even column
// x0 - 1 (36 columns, 18 four-byte copies) and is read shifted by one.
// Halo pairs outside the canvas are zero-filled (src-size 0).
// Shared memory per CTA: conv 27,724 B (pool 25,996 B: it never reads the
// weights); dblbuf 27,952 B (two bf16 input buffers, 8,208 B); pipe 45,904 B
// (two input buffers and two conv slots).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CO = 16;          // stem output channels (phi='n')
constexpr int TH = 8;           // pooled rows per tile
constexpr int TW = 16;          // pooled cols per tile
constexpr int CR = 2 * TH + 1;  // conv rows under the tile's pool windows
constexpr int CC = 2 * TW + 1;  // conv cols
constexpr int IR = CR + 2;      // canvas rows incl. the 3x3 halo
constexpr int IC = CC + 2;      // canvas cols
constexpr int ICB = IC + 1;     // bf16-staged cols, from the even column x0 - 1
constexpr int WORDS = ICB / 2;  // 4-byte copies per staged row
constexpr int THREADS = 256;
constexpr int HALF = THREADS / 2;
static_assert(TH * TW * 2 == THREADS, "one pool item per (pooled pixel, 8 channels)");

// named barriers of the pipe kernel (0 is __syncthreads)
constexpr int BAR_CONV = 1;   // the 128 conv threads among themselves
constexpr int BAR_FULL = 2;   // +slot: a conv slot is written (conv -> pool)
constexpr int BAR_EMPTY = 4;  // +slot: a conv slot is read (pool -> conv)

enum Variant { kConv = 1, kPool = 2, kDblbuf = 3, kPipe = 4 };

typedef __nv_bfloat16 bf16;
typedef bf16 ConvTile[CR * CC][CO];
typedef bf16 StageBuf[3][IR][ICB];

struct Tile {
  int b, pr0, pc0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_x, int tiles_y) {
  const int per_img = tiles_x * tiles_y;
  const int rem = t % per_img;
  return Tile{t / per_img, (rem / tiles_x) * TH, (rem % tiles_x) * TW};
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void load_weights(const bf16* __restrict__ weight,
                                             const float* __restrict__ bias,
                                             float (*s_w)[CO], float* s_b, int tid) {
  for (int i = tid; i < CO * 27; i += THREADS) {
    s_w[i % 27][i / 27] = __bfloat162float(weight[i]);  // (co, ci, dy, dx)
  }
  if (tid < CO) s_b[tid] = bias[tid];
}

// kernel A's staging: the tile plus halo as f32, zeros outside the canvas
__device__ __forceinline__ void load_tile_f32(const bf16* __restrict__ img,
                                              float (*s_in)[IR][IC], int y0, int x0,
                                              int H2, int W2, int tid) {
  for (int i = tid; i < 3 * IR * IC; i += THREADS) {
    const int ci = i / (IR * IC), r = (i / IC) % IR, c = i % IC;
    const int gy = y0 + r, gx = x0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2)
      v = __bfloat162float(img[((size_t)ci * H2 + gy) * W2 + gx]);
    s_in[ci][r][c] = v;
  }
}

// bf16 staging by cp.async: row r holds canvas columns x0-1 .. x0+34
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ img, StageBuf& dst,
                                           int y0, int x0, int H2, int W2, int t0,
                                           int nt) {
  const int xs = x0 - 1;  // even, so each copy is 4-byte aligned
  for (int i = t0; i < 3 * IR * WORDS; i += nt) {
    const int ci = i / (IR * WORDS), r = (i / WORDS) % IR, w = i % WORDS;
    const int gy = y0 + r, gx = xs + 2 * w;
    // gx and W2 are even: the pair (gx, gx+1) is wholly inside or outside
    const bool ok = gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
    const bf16* src = ok ? img + ((size_t)ci * H2 + gy) * W2 + gx : img;
    cp_async4(&dst[ci][r][2 * w], src, ok);
  }
}

struct F32Src {
  const float (*s)[IR][IC];
  __device__ __forceinline__ float operator()(int ci, int r, int c) const {
    return s[ci][r][c];
  }
};

struct Bf16Src {
  const StageBuf* s;
  __device__ __forceinline__ float operator()(int ci, int r, int c) const {
    return __bfloat162float((*s)[ci][r][c + 1]);
  }
};

// kernel A's first conv tile: one thread per conv position,
// all 16 channels; positions outside the image are the pool's -inf padding
template <class Src>
__device__ __forceinline__ void conv_tile(const Src& src, const float (*s_w)[CO],
                                          const float* s_b, ConvTile& s_conv, int y0,
                                          int x0, int H, int W, int t0, int nt) {
  for (int p = t0; p < CR * CC; p += nt) {
    const int r = p / CC, c = p % CC;
    const int y = y0 + r, x = x0 + c;
    bf16* dst = s_conv[p];
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
        for (int dx = 0; dx < 3; ++dx) in[ci * 9 + dy * 3 + dx] = src(ci, r + dy, c + dx);
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 27; ++k) acc = fmaf(in[k], s_w[k][co], acc);
      dst[co] = __float2bfloat16_rn(acc + s_b[co]);
    }
  }
}

// the pool variant's stand-in for the conv: the centre tap's three input
// channels and the bias, added in a fixed order
template <class Src>
__device__ __forceinline__ void bias_tile(const Src& src, const float* s_b,
                                          ConvTile& s_conv, int y0, int x0, int H, int W,
                                          int t0, int nt) {
  for (int p = t0; p < CR * CC; p += nt) {
    const int r = p / CC, c = p % CC;
    const int y = y0 + r, x = x0 + c;
    bf16* dst = s_conv[p];
    if (y < 0 || y >= H || x < 0 || x >= W) {
#pragma unroll
      for (int co = 0; co < CO; ++co) dst[co] = __float2bfloat16_rn(-INFINITY);
      continue;
    }
    const float v = (src(0, r + 1, c + 1) + src(1, r + 1, c + 1)) + src(2, r + 1, c + 1);
#pragma unroll
    for (int co = 0; co < CO; ++co) dst[co] = __float2bfloat16_rn(v + s_b[co]);
  }
}

// kernel A's pool tree and store for one item =
// (pooled pixel, half of the channels)
__device__ __forceinline__ void pool_store(const ConvTile& s_conv,
                                           bf16* __restrict__ out, const Tile& t,
                                           int Hp, int Wp, int item) {
  const int pix = item >> 1, half = item & 1;
  const int lr = pix / TW, lc = pix % TW;
  const int pr = t.pr0 + lr, pc = t.pc0 + lc;
  if (pr >= Hp || pc >= Wp) return;
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = -INFINITY;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const bf16* src = s_conv[(2 * lr + dy) * CC + 2 * lc + dx] + half * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = fmaxf(m[j], __bfloat162float(src[j]));
    }
  __align__(16) bf16 res[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) res[j] = __float2bfloat16_rn(fmaxf(m[j], 0.f));
  uint4* dst = reinterpret_cast<uint4*>(out + (((size_t)t.b * Hp + pr) * Wp + pc) * CO +
                                        half * 8);
  *dst = *reinterpret_cast<const uint4*>(res);
}

// the conv variant's store: conv position (2*pr, 2*pc), the centre of the
// pooled pixel's window, as it is (no max, no ReLU)
__device__ __forceinline__ void sample_store(const ConvTile& s_conv,
                                             bf16* __restrict__ out, const Tile& t,
                                             int Hp, int Wp, int item) {
  const int pix = item >> 1, half = item & 1;
  const int lr = pix / TW, lc = pix % TW;
  const int pr = t.pr0 + lr, pc = t.pc0 + lc;
  if (pr >= Hp || pc >= Wp) return;
  const uint4 v = *reinterpret_cast<const uint4*>(
      s_conv[(2 * lr + 1) * CC + 2 * lc + 1] + half * 8);
  *reinterpret_cast<uint4*>(out + (((size_t)t.b * Hp + pr) * Wp + pc) * CO +
                            half * 8) = v;
}

// conv and pool: kernel A with one phase dropped (one tile per CTA)
template <int V>
__global__ void __launch_bounds__(THREADS)
probe_single_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__ weight,
                    const float* __restrict__ bias, bf16* __restrict__ out, int H,
                    int W) {
  __shared__ float s_in[3][IR][IC];
  __shared__ float s_w[27][CO];
  __shared__ float s_b[CO];
  __shared__ __align__(16) ConvTile s_conv;

  const int tid = threadIdx.x;
  const Tile t{static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.y) * TH,
               static_cast<int>(blockIdx.x) * TW};
  const int H2 = H + 2, W2 = W + 2;
  const int y0 = 2 * t.pr0 - 1, x0 = 2 * t.pc0 - 1;
  load_weights(weight, bias, s_w, s_b, tid);
  load_tile_f32(canvas + (size_t)t.b * 3 * H2 * W2, s_in, y0, x0, H2, W2, tid);
  __syncthreads();
  const F32Src src{s_in};
  if (V == kConv)
    conv_tile(src, s_w, s_b, s_conv, y0, x0, H, W, tid, THREADS);
  else
    bias_tile(src, s_b, s_conv, y0, x0, H, W, tid, THREADS);
  __syncthreads();
  if (V == kConv)
    sample_store(s_conv, out, t, H / 2, W / 2, tid);
  else
    pool_store(s_conv, out, t, H / 2, W / 2, tid);
}

// dblbuf: persistent CTAs, the next tile's canvas in flight during this one
__global__ void __launch_bounds__(THREADS, 1)
probe_dblbuf_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__ weight,
                    const float* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                    int tiles_x, int tiles_y, int n_tiles) {
  __shared__ __align__(16) StageBuf s_stage[2];
  __shared__ float s_w[27][CO];
  __shared__ float s_b[CO];
  __shared__ __align__(16) ConvTile s_conv;

  const int tid = threadIdx.x;
  const int H2 = H + 2, W2 = W + 2;
  const size_t img_elems = (size_t)3 * H2 * W2;
  load_weights(weight, bias, s_w, s_b, tid);
  int tile = blockIdx.x;
  if (tile < n_tiles) {
    const Tile t = tile_of(tile, tiles_x, tiles_y);
    stage_tile(canvas + t.b * img_elems, s_stage[0], 2 * t.pr0 - 1, 2 * t.pc0 - 1, H2,
               W2, tid, THREADS);
  }
  cp_async_commit();
  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      const Tile tn = tile_of(next, tiles_x, tiles_y);
      stage_tile(canvas + tn.b * img_elems, s_stage[buf ^ 1], 2 * tn.pr0 - 1,
                 2 * tn.pc0 - 1, H2, W2, tid, THREADS);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this tile's canvas is in; the last pool is done with s_conv
    const Tile t = tile_of(tile, tiles_x, tiles_y);
    conv_tile(Bf16Src{&s_stage[buf]}, s_w, s_b, s_conv, 2 * t.pr0 - 1, 2 * t.pc0 - 1, H,
              W, tid, THREADS);
    __syncthreads();  // s_conv is written; s_stage[buf] may be refilled
    pool_store(s_conv, out, t, H / 2, W / 2, tid);
  }
}

// pipe: warps 0-3 load and convolve tile k+1 while warps 4-7 pool tile k
__global__ void __launch_bounds__(THREADS, 1)
probe_pipe_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__ weight,
                  const float* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                  int tiles_x, int tiles_y, int n_tiles) {
  __shared__ __align__(16) StageBuf s_stage[2];
  __shared__ __align__(16) ConvTile s_conv[2];
  __shared__ float s_w[27][CO];
  __shared__ float s_b[CO];

  const int tid = threadIdx.x;
  const int lt = tid % HALF;
  const int H2 = H + 2, W2 = W + 2;
  const size_t img_elems = (size_t)3 * H2 * W2;
  // this CTA's tiles: blockIdx.x + k * gridDim.x for k < n_local
  const int n_local = static_cast<int>(blockIdx.x) < n_tiles
                          ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                          : 0;
  load_weights(weight, bias, s_w, s_b, tid);
  __syncthreads();

  if (tid < HALF) {  // conv warps
    if (n_local > 0) {
      const Tile t = tile_of(blockIdx.x, tiles_x, tiles_y);
      stage_tile(canvas + t.b * img_elems, s_stage[0], 2 * t.pr0 - 1, 2 * t.pc0 - 1,
                 H2, W2, lt, HALF);
    }
    cp_async_commit();
    for (int k = 0; k < n_local; ++k) {
      if (k + 1 < n_local) {
        const Tile tn = tile_of(blockIdx.x + (k + 1) * gridDim.x, tiles_x, tiles_y);
        stage_tile(canvas + tn.b * img_elems, s_stage[(k + 1) & 1], 2 * tn.pr0 - 1,
                   2 * tn.pc0 - 1, H2, W2, lt, HALF);
      }
      cp_async_commit();
      cp_async_wait_prev();
      bar_sync(BAR_CONV, HALF);  // tile k's canvas is in, for every conv thread
      const int slot = k & 1;
      if (k >= 2) bar_sync(BAR_EMPTY + slot, THREADS);  // pool is done with tile k-2
      const Tile t = tile_of(blockIdx.x + k * gridDim.x, tiles_x, tiles_y);
      conv_tile(Bf16Src{&s_stage[k & 1]}, s_w, s_b, s_conv[slot], 2 * t.pr0 - 1,
                2 * t.pc0 - 1, H, W, lt, HALF);
      bar_arrive(BAR_FULL + slot, THREADS);
      bar_sync(BAR_CONV, HALF);  // s_stage[k & 1] is read; it is refilled for k+2
    }
  } else {  // pool warps
    for (int k = 0; k < n_local; ++k) {
      const int slot = k & 1;
      bar_sync(BAR_FULL + slot, THREADS);
      const Tile t = tile_of(blockIdx.x + k * gridDim.x, tiles_x, tiles_y);
      for (int item = lt; item < THREADS; item += HALF)
        pool_store(s_conv[slot], out, t, H / 2, W / 2, item);
      if (k + 2 < n_local) bar_arrive(BAR_EMPTY + slot, THREADS);
    }
  }
}

template <class K>
int persistent_grid(K kernel, int n_tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const int g = sms * (per_sm > 0 ? per_sm : 1);
  return g < n_tiles ? g : n_tiles;
}

}  // namespace

// One entry for the four variants (1 conv, 2 pool, 3 dblbuf, 4 pipe); returns
// the launch's CUDA error code.
extern "C" int stem_probe_bf16(int variant, const void* canvas, const void* weight,
                               const void* bias, void* out, int B, int H, int W,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(canvas);
  const bf16* w = static_cast<const bf16*>(weight);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  const int tiles_x = (W / 2 + TW - 1) / TW, tiles_y = (H / 2 + TH - 1) / TH;
  const int n_tiles = B * tiles_x * tiles_y;
  switch (variant) {
    case kConv:
      probe_single_kernel<kConv><<<dim3(tiles_x, tiles_y, B), THREADS, 0, s>>>(x, w, b, o,
                                                                               H, W);
      break;
    case kPool:
      probe_single_kernel<kPool><<<dim3(tiles_x, tiles_y, B), THREADS, 0, s>>>(x, w, b, o,
                                                                               H, W);
      break;
    case kDblbuf:
      probe_dblbuf_kernel<<<persistent_grid(probe_dblbuf_kernel, n_tiles), THREADS, 0,
                            s>>>(x, w, b, o, H, W, tiles_x, tiles_y, n_tiles);
      break;
    case kPipe:
      probe_pipe_kernel<<<persistent_grid(probe_pipe_kernel, n_tiles), THREADS, 0, s>>>(
          x, w, b, o, H, W, tiles_x, tiles_y, n_tiles);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
