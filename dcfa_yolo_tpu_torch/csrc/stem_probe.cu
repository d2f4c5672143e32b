// Stem split probe for Hopper (sm_90a): variants of the fused eval stem
// (kernel A, csrc/stem_eval.cu) that drop or overlap one of its phases, so
// that their times split kernel A's time into tile load, conv and pool tree.
//
// Replaces the TPU probe kernels of tools/stem_split_probe.py: make_kernel
// (variants dots, vpu, dblbuf) and pipe_kernel (variant pipe), called by
// `call`.  The probe's `full` variant is kernel A itself (stem_eval_bf16);
// this file holds the other four.
//
// All four run on kernel A's core (stem_core.cuh): the persistent grid, A's
// canvas staging (stage_canvas, 4-byte cp.async into two stage buffers), A's
// shared memory (EvalSmem: two stage buffers, two conv tiles) and A's pool
// tree and store (pool_max_relu).  Each differs from A in one step:
//   conv   (JAX `dots`): A's walk and conv step (EvalConvMma: the tensor
//          cores, the bias in K row 27, the bf16 round, so A's conv values
//          bit for bit); its finish writes, for each pooled pixel (i, j)
//          inside the image, the 16 channels of conv position (2i, 2j)
//          (tile position (2(i - pr0) + 1, 2(j - pc0) + 1), the centre of
//          the pixel's pool window, always inside the image) as 32
//          contiguous bytes: no pool tree, no ReLU.  So relu(conv) <= full
//          exactly.
//   pool   (JAX `vpu`): A's walk and finish with the GEMM swapped for three
//          adds: at each conv position bf16(((c0 + c1) + c2) + bias[co]) in
//          f32, c the canvas channels at the centre tap, which keeps the
//          whole tile load, the conv tile's stores and the tree live.  It
//          reads no weight.  (The JAX `vpu` value is an iota construct for
//          the TPU compiler's layout pass and has no meaning here.)
//   dblbuf (JAX `dblbuf`): kernel A itself as its own launch.  On Hopper the
//          double buffer that JAX dblbuf adds to `full` is A's own schedule
//          (two stage buffers, two conv tiles), so dblbuf is bit-identical
//          to full and takes A's time.
//   pipe   (JAX `pipe`): A's stages split by warp role (pipe_walk): warps
//          0-7 stage and convolve tile k+1 with A's conv step while warps
//          8-11 pool tile k, over two conv slots ordered by named barriers
//          (bar.sync / bar.arrive).  A conv position's value does not depend
//          on the warp that computes it, so pipe is bit-identical to full.
//
// Inputs and outputs are kernel A's, so the bytes moved are the same in
// every variant (pool alone reads no weights):
//   canvas (B, 3, H+2, W+2) bf16, weight (16, 3, 3, 3) bf16, bias (16,) f32
//   out    (B, H/2, W/2, 16) bf16 NHWC; H, W even.
// Each variant's bound: tools/stem_split_probe.py::variant_bound.  Grids:
// n_cta from ops/stem_core.py::num_ctas and the kernel's resident CTAs
// (stem_probe_info); conv, pool and dblbuf fit 3 CTAs of 256 threads an SM,
// pipe 2 of 384.

#include "stem_core.cuh"

namespace {

using namespace stem;

enum Variant { kConv = 1, kPool = 2, kDblbuf = 3, kPipe = 4 };

// ---- pool's conv step ------------------------------------------------------

// The stand-in for A's GEMM: threads stride over the tile's conv positions;
// position p = (r, c) reads the centre tap (ci, r + 1, c + 1) of the three
// channels from the stage buffer (EvalLayout: the +1 column shift of rows
// staged from the even column x0 - 1 is in EvalLayout::base) and writes
// bf16_rn(((c0 + c1) + c2) + bias[co]) for the 16 channels as two 16-byte
// stores, or -inf outside the image (A's epilogue test).  The bias is read
// once a CTA, into registers.
struct CentreTapStep {
  float bias[CO];
  int H, W;
  __device__ __forceinline__ CentreTapStep(const float* __restrict__ b, int H_, int W_)
      : H(H_), W(W_) {
#pragma unroll
    for (int co = 0; co < CO; ++co) bias[co] = __ldg(b + co);
  }
  __device__ __forceinline__ void operator()(const Tile& t, const bf16* stage,
                                             bf16* conv) const {
    const int y0 = 2 * t.pr0 - 1, x0 = 2 * t.pc0 - 1;
    for (int p = threadIdx.x; p < NPOS; p += THREADS) {
      uint4* dst = reinterpret_cast<uint4*>(conv + p * EVAL_SCS);
      if (!in_image(y0, x0, p, H, W)) {
        const uint4 pad = make_uint4(BF16_NEG_INF2, BF16_NEG_INF2, BF16_NEG_INF2, BF16_NEG_INF2);
        dst[0] = pad;
        dst[1] = pad;
        continue;
      }
      const bf16* c = stage + EvalLayout::base(p);
      const float v = (__bfloat162float(c[EvalLayout::tap(4)]) +
                       __bfloat162float(c[EvalLayout::tap(13)])) +
                      __bfloat162float(c[EvalLayout::tap(22)]);
      uint32_t w[CO / 2];
#pragma unroll
      for (int j = 0; j < CO / 2; ++j) w[j] = pack2(v + bias[2 * j], v + bias[2 * j + 1]);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
};

// ---- pipe's split-role walk ------------------------------------------------

constexpr int PIPE_CONV = THREADS;                  // warps 0-7: stage and convolve
constexpr int PIPE_POOL = 128;                      // warps 8-11: pool
constexpr int PIPE_THREADS = PIPE_CONV + PIPE_POOL;
constexpr int POOL_ITEMS = 2 * TH * TW;             // pool items a tile
static_assert(POOL_ITEMS % PIPE_POOL == 0, "every pool thread takes the same item count");

// named barriers (0 is __syncthreads, which pipe never uses)
constexpr int BAR_CONV = 1;   // the conv threads among themselves
constexpr int BAR_FULL = 2;   // +slot: conv slot written (conv arrives, pool syncs)
constexpr int BAR_EMPTY = 4;  // +slot: conv slot read (pool arrives, conv syncs)

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// CTA blockIdx.x's n tiles (blockIdx.x, + gridDim.x, ...; n >= 1 for a grid
// of at most the tiles), tile k in conv slot k & 1 and stage buffer k & 1.
//   conv role, step k: wait for its own copies of tile k, then BAR_CONV: tile
//     k's input is in for every conv thread, and every conv thread is done
//     with step k-1's reads of stage buffer (k+1) & 1, which it refills with
//     tile k+1; from k = 2 on, BAR_EMPTY + slot (the pool role released tile
//     k-2); tile k's conv into the slot; arrive BAR_FULL + slot.
//   pool role, step k: BAR_FULL + slot; pool tile k from the slot; arrive
//     BAR_EMPTY + slot only if tile k+2 exists, so every arrive has its sync
//     whatever n is.
// A barrier's next phase cannot begin before its last one ends: conv
// arrives FULL + slot for tile k+2 only after syncing EMPTY + slot for tile
// k, which pool arrives after its FULL + slot sync for tile k; the same
// chain orders EMPTY's phases.  Pool runs about a tile behind conv, so conv
// waits on EMPTY only when the pool role is slower than the conv role.
template <class Conv, class Finish>
__device__ __forceinline__ void pipe_walk(const bf16* __restrict__ canvas, int B, int H, int W,
                                          EvalSmem& sm, Conv&& make_conv, Finish&& finish) {
  const int tiles_x = tiles_x_of(W), tiles_y = tiles_y_of(H);
  const int H2 = H + 2, W2 = W + 2;
  const size_t img_elems = (size_t)3 * H2 * W2;
  const int n = (B * tiles_x * tiles_y - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const TileIndex step(gridDim.x, tiles_x, tiles_y);
  TileIndex cur(blockIdx.x, tiles_x, tiles_y);
  if (threadIdx.x < PIPE_CONV) {
    const auto conv = make_conv();  // only the conv role reads the weights
    auto stage = [&](const Tile& t, int buf) {
      stage_canvas(canvas + t.b * img_elems, sm.stage[buf], 2 * t.pr0 - 1, 2 * t.pc0 - 1, H2,
                   W2);
    };
    stage(cur.tile(), 0);
    cp_async_commit();
    for (int k = 0; k < n; ++k) {
      const int slot = k & 1;
      cp_async_wait_all();
      bar_sync(BAR_CONV, PIPE_CONV);
      TileIndex next = cur;
      next.advance(step, tiles_x, tiles_y);
      if (k + 1 < n) stage(next.tile(), slot ^ 1);
      cp_async_commit();
      if (k >= 2) bar_sync(BAR_EMPTY + slot, PIPE_THREADS);
      conv(cur.tile(), sm.stage[slot], sm.conv[slot]);
      bar_arrive(BAR_FULL + slot, PIPE_THREADS);
      cur = next;
    }
  } else {
    const int item = threadIdx.x - PIPE_CONV;
    for (int k = 0; k < n; ++k) {
      const int slot = k & 1;
      bar_sync(BAR_FULL + slot, PIPE_THREADS);
      const Tile t = cur.tile();
#pragma unroll
      for (int j = 0; j < POOL_ITEMS / PIPE_POOL; ++j)
        finish(t, sm.conv[slot], item + j * PIPE_POOL);
      if (k + 2 < n) bar_arrive(BAR_EMPTY + slot, PIPE_THREADS);
      cur.advance(step, tiles_x, tiles_y);
    }
  }
}

// ---- the kernels -------------------------------------------------------------

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
  eval_walk(canvas, B, H, W, *reinterpret_cast<EvalSmem*>(smem_raw),
            EvalConvMma(weight, bias, H, W), [&](const Tile& t, const bf16* conv) {
              const PoolItem it(t);
              if (it.pr >= Hp || it.pc >= Wp) return;
              Pack8<bf16> v;
              v.load(conv + it.at<EVAL_SCS, bf16>(1, 1));
              v.store(out + it.out_index<bf16>(t.b, Hp, Wp));
            });
}

// pool: kernel A with its conv step swapped for the centre tap's three adds;
// the weight argument is not read
__global__ void __launch_bounds__(THREADS, 3)
probe_pool_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__,
                  const float* __restrict__ bias, bf16* __restrict__ out, int B, int H,
                  int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  eval_walk(canvas, B, H, W, *reinterpret_cast<EvalSmem*>(smem_raw),
            CentreTapStep(bias, H, W), [&](const Tile& t, const bf16* conv) {
              pool_max_relu<EVAL_SCS>(conv, out, t, H / 2, W / 2);
            });
}

// dblbuf: kernel A as a launch of its own
__global__ void __launch_bounds__(THREADS, 3)
probe_dblbuf_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__ weight,
                    const float* __restrict__ bias, bf16* __restrict__ out, int B, int H,
                    int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  eval_walk(canvas, B, H, W, *reinterpret_cast<EvalSmem*>(smem_raw),
            EvalConvMma(weight, bias, H, W), [&](const Tile& t, const bf16* conv) {
              pool_max_relu<EVAL_SCS>(conv, out, t, H / 2, W / 2);
            });
}

// pipe: A's conv step and pool on the split-role walk
__global__ void __launch_bounds__(PIPE_THREADS, 2)
probe_pipe_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__ weight,
                  const float* __restrict__ bias, bf16* __restrict__ out, int B, int H,
                  int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  pipe_walk(
      canvas, B, H, W, *reinterpret_cast<EvalSmem*>(smem_raw),
      [&] { return EvalConvMma(weight, bias, H, W); },
      [&](const Tile& t, const bf16* conv, int item) {
        pool_max_relu<EVAL_SCS>(conv, out, t, H / 2, W / 2, item);
      });
}

}  // namespace

// info[5] of a variant's kernel (1 conv, 2 pool, 3 dblbuf, 4 pipe):
// registers, stack bytes, static and dynamic shared memory, resident CTAs on
// the current device; returns a CUDA error code.
extern "C" int stem_probe_info(int variant, int* info) {
  const int smem = static_cast<int>(sizeof(EvalSmem));
  switch (variant) {
    case kConv:
      return kernel_info(probe_conv_kernel, smem, info);
    case kPool:
      return kernel_info(probe_pool_kernel, smem, info);
    case kDblbuf:
      return kernel_info(probe_dblbuf_kernel, smem, info);
    case kPipe:
      return kernel_info(probe_pipe_kernel, smem, info, PIPE_THREADS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One entry for the four variants (1 conv, 2 pool, 3 dblbuf, 4 pipe) on the
// persistent grid of n_cta CTAs (1 <= n_cta <= tiles, ops/stem_core.py::
// num_ctas from stem_probe_info's resident count); returns the launch's CUDA
// error code.
extern "C" int stem_probe_bf16(int variant, const void* canvas, const void* weight,
                               const void* bias, void* out, int B, int H, int W, int n_cta,
                               void* stream) {
  switch (variant) {
    case kConv:
      return launch_eval(probe_conv_kernel, canvas, weight, bias, out, B, H, W, n_cta, stream);
    case kPool:
      return launch_eval(probe_pool_kernel, canvas, weight, bias, out, B, H, W, n_cta, stream);
    case kDblbuf:
      return launch_eval(probe_dblbuf_kernel, canvas, weight, bias, out, B, H, W, n_cta,
                         stream);
    case kPipe:
      return launch_eval(probe_pipe_kernel, canvas, weight, bias, out, B, H, W, n_cta, stream,
                         PIPE_THREADS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
