// Stem split probe for Hopper (sm_90a): variants of the fused eval stem
// (kernel A, csrc/stem_eval.cu) that drop or overlap one of its phases, so
// that their times split kernel A's time into tile load, conv and pool tree.
//
// Replaces the TPU probe kernels of tools/stem_split_probe.py: make_kernel
// (variants dots, vpu, dblbuf) and pipe_kernel (variant pipe), called by
// `call`.  The probe's `full` variant is kernel A itself (stem_eval_bf16);
// this file holds the other four.
//
// On kernel A's core (stem_core.cuh::eval_walk: the persistent grid, the
// cp.async double buffer, the tensor-core conv with the bias in K row 27,
// one barrier a tile; A's arithmetic, so A's conv values bit for bit):
//   conv   (JAX `dots`): load + conv + bf16 round of the whole 17x33 conv
//          tile, as A convolves it; its finish writes, for each pooled pixel
//          (i, j) inside the image, the 16 channels of conv position
//          (2i, 2j) (tile position (2(i - pr0) + 1, 2(j - pc0) + 1), the
//          centre of the pixel's pool window, always inside the image) as
//          32 contiguous bytes: no pool tree, no ReLU.  So relu(conv) <=
//          full exactly.
//   dblbuf (JAX `dblbuf`): kernel A itself as its own launch.  On Hopper the
//          double buffer that JAX dblbuf adds to `full` is A's own schedule
//          (two stage buffers, two conv tiles), so dblbuf is bit-identical
//          to full and takes A's time.
// Kernel A's first design (one CTA a tile, the conv as f32 FMAs on the CUDA
// cores, reading the weights from shared memory), kept until they are
// rebuilt on the core:
//   pool   (JAX `vpu`): load + pool tree + ReLU + stores, with the 27x16 FMAs
//          of each conv position replaced by the centre tap's three channels
//          and the bias, bf16(((c0 + c1) + c2) + bias[co]) in f32, which keeps
//          the whole tile load and the tree live.  (The JAX `vpu` value is an
//          iota construct for the TPU compiler's layout pass and has no
//          meaning here.)
//   pipe   (JAX `pipe`): the first design software-pipelined by warp
//          specialisation: warps 0-3 load and convolve tile k+1 into one of
//          two conv slots while warps 4-7 pool tile k from the other, ordered
//          by named barriers (bar.sync / bar.arrive).  It sums in the first
//          design's fmaf order, so it agrees with full in the v4 class.
//
// Inputs and outputs are kernel A's, so the bytes moved are the same in
// every variant (pool alone reads no weights):
//   canvas (B, 3, H+2, W+2) bf16, weight (16, 3, 3, 3) bf16, bias (16,) f32
//   out    (B, H/2, W/2, 16) bf16 NHWC; H, W even.
// Each variant's bound: tools/stem_split_probe.py::variant_bound.
//
// Staging of the first design.  pool stages the canvas tile as f32
// (s_in[3][19][35], 7,980 B); pipe stages bf16 by cp.async and converts at
// use, each staged row starting at the even column x0 - 1 as kernel A's
// does.  Shared memory per CTA: pool 26,000 B; pipe 45,904 B (two input
// buffers and two conv slots); conv and dblbuf A's EvalSmem (dynamic).

#include "stem_core.cuh"

namespace {

using namespace stem;

constexpr int HALF = THREADS / 2;

// named barriers of the pipe kernel (0 is __syncthreads)
constexpr int BAR_CONV = 1;   // the 128 conv threads among themselves
constexpr int BAR_FULL = 2;   // +slot: a conv slot is written (conv -> pool)
constexpr int BAR_EMPTY = 4;  // +slot: a conv slot is read (pool -> conv)

enum Variant { kConv = 1, kPool = 2, kDblbuf = 3, kPipe = 4 };

typedef bf16 ConvTile[CR * CC][CO];
typedef bf16 StageBuf[3][IR][ICB];

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

// the first design's staging: the tile plus halo as f32, zeros outside the canvas
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
    cp_async<4>(&dst[ci][r][2 * w], src, ok);
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

// the first design's conv tile: one thread per conv position, all 16
// channels; positions outside the image are the pool's -inf padding
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

// the first design's pool tree and store for one item = (pooled pixel,
// half of the channels)
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

// conv: kernel A's walk, finished by a centre sample in place of the pool
// tree.  Conv position (2*pr, 2*pc), tile position (2*lr + 1, 2*lc + 1), is
// inside the image (2*pr < H, 2*pc < W), so it is never the -inf padding;
// the two halves of a pixel write its 32 contiguous bytes.
__global__ void __launch_bounds__(THREADS, 3)
probe_conv_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__ weight,
                  const float* __restrict__ bias, bf16* __restrict__ out, int B, int H,
                  int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Hp = H / 2, Wp = W / 2;
  eval_walk(canvas, weight, bias, B, H, W, *reinterpret_cast<EvalSmem*>(smem_raw),
            [&](const Tile& t, const bf16* conv) {
              const PoolItem it(t);
              if (it.pr >= Hp || it.pc >= Wp) return;
              Pack8<bf16> v;
              v.load(conv + it.at<EVAL_SCS, bf16>(1, 1));
              v.store(out + it.out_index<bf16>(t.b, Hp, Wp));
            });
}

// dblbuf: kernel A as a launch of its own
__global__ void __launch_bounds__(THREADS, 3)
probe_dblbuf_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__ weight,
                    const float* __restrict__ bias, bf16* __restrict__ out, int B, int H,
                    int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  eval_walk(canvas, weight, bias, B, H, W, *reinterpret_cast<EvalSmem*>(smem_raw),
            [&](const Tile& t, const bf16* conv) {
              pool_max_relu<EVAL_SCS>(conv, out, t, H / 2, W / 2);
            });
}

// pool: the first design with the conv replaced (one tile per CTA)
__global__ void __launch_bounds__(THREADS)
probe_pool_kernel(const bf16* __restrict__ canvas, const float* __restrict__ bias,
                  bf16* __restrict__ out, int H, int W) {
  __shared__ float s_in[3][IR][IC];
  __shared__ float s_b[CO];
  __shared__ __align__(16) ConvTile s_conv;

  const int tid = threadIdx.x;
  const Tile t{static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.y) * TH,
               static_cast<int>(blockIdx.x) * TW};
  const int H2 = H + 2, W2 = W + 2;
  const int y0 = 2 * t.pr0 - 1, x0 = 2 * t.pc0 - 1;
  if (tid < CO) s_b[tid] = bias[tid];
  load_tile_f32(canvas + (size_t)t.b * 3 * H2 * W2, s_in, y0, x0, H2, W2, tid);
  __syncthreads();
  bias_tile(F32Src{s_in}, s_b, s_conv, y0, x0, H, W, tid, THREADS);
  __syncthreads();
  pool_store(s_conv, out, t, H / 2, W / 2, tid);
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

// info[5] of the conv (1) or dblbuf (3) kernel, the two on kernel A's walk:
// registers, stack bytes, static and dynamic shared memory, resident CTAs on
// the current device; returns a CUDA error code.
extern "C" int stem_probe_info(int variant, int* info) {
  const int smem = static_cast<int>(sizeof(EvalSmem));
  switch (variant) {
    case kConv:
      return kernel_info(probe_conv_kernel, smem, info);
    case kDblbuf:
      return kernel_info(probe_dblbuf_kernel, smem, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One entry for the four variants (1 conv, 2 pool, 3 dblbuf, 4 pipe); returns
// the launch's CUDA error code.  n_cta is the persistent grid of conv and
// dblbuf (1 <= n_cta <= tiles, ops/stem_core.py::num_ctas from
// stem_probe_info's resident count); pool and pipe size their own grids.
extern "C" int stem_probe_bf16(int variant, const void* canvas, const void* weight,
                               const void* bias, void* out, int B, int H, int W, int n_cta,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(canvas);
  const bf16* w = static_cast<const bf16*>(weight);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  const int tiles_x = tiles_x_of(W), tiles_y = tiles_y_of(H);
  const int n_tiles = B * tiles_x * tiles_y;
  switch (variant) {
    case kConv:
      return launch_eval(probe_conv_kernel, canvas, weight, bias, out, B, H, W, n_cta, stream);
    case kDblbuf:
      return launch_eval(probe_dblbuf_kernel, canvas, weight, bias, out, B, H, W, n_cta,
                         stream);
    case kPool:
      probe_pool_kernel<<<dim3(tiles_x, tiles_y, B), THREADS, 0, s>>>(x, b, o, H, W);
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
