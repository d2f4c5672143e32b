// Fused train stem for Hopper (sm_90a), kernel C: conv3x3 s1 pad 1 (3 -> 16)
// without any BN fold, the conv value c^ (rounded to bf16 in the bf16
// instantiation, kept in float32 in the float32 one), then from c^ in one
// pass: maxpool3x3 s2 pad 1, minpool3x3 s2 pad 1, and the per-channel sums
// of c^ and c^^2 over the batch.  The full-resolution conv output never
// reaches device memory.  Train-BN needs the batch statistics before it can
// normalize; the pool commutes with the per-channel affine a*c+b up to the
// sign of a, so the wrapper (ops/cuda_stem_train.py) applies BN and ReLU at
// pool resolution, picking the max or the min pool by sign(gamma).
//
// Replaces the TPU kernel dcfa_yolo_tpu/ops/pallas_stem_train.py:
//   fused_train_stem -> _fused_fwd_impl -> _stem_pool_stats ->
//   _train_stem_kernel (same function, not a block-by-block carry-over), at
//   both of its compute dtypes: bf16 rounds the conv output
//   (pallas_stem_train.py:116-120), float32 skips that rounding.
//
// Contract (T = __nv_bfloat16 or float; one template, two C entries)
//   x        (B, H, W, 3) T NHWC (the model's input; the zero halo comes
//            from the copies' zero fill, so there is no pad or transpose pass)
//   weight   (16, 3, 3, 3) T, the conv kernel OIHW
//   pmax     (B, H/2, W/2, 16) T NHWC,  pmin likewise
//   partials (n_cta, 16, 2) float64: per-CTA [sum c^, sum c^^2] per
//            channel; the wrapper adds them in float64.  H and W even.
//   n_cta    the persistent grid, 1 <= n_cta <= tiles (ops/stem_core.py)
//
// Numerics.  bf16: the conv runs on the tensor cores (stem_core.cuh: K rows
// 0-26 the taps, 27-31 zero); bf16 products are exact in f32, so only the
// f32 summation order differs from the plain version, and c^ is rounded to
// bf16 BEFORE both pools and both sums.  float32: the conv stays on the CUDA
// cores, one fmaf a tap in the fixed order k = ci*9 + dy*3 + dx (TF32 would
// break its tolerance), so its conv values are those of the first version.
// Pool padding is skipped by bounds checks.  The sums are deterministic and,
// in bf16, exact: each thread keeps register sums for its channels across
// all its CTA's tiles, a fixed shuffle tree and a fixed order over the warps
// give one (16, 2) double partial per CTA, and the wrapper adds those in
// float64; no atomics.  Each conv pixel is counted once (ownership rule in
// stem_core.cuh, "C's sums").
//
// Bound at b16 640^2, one modality, bf16: 39.3 MB of input + 104.9 MB of
// pooled maps = 144.2 MB, 43.0 us at 3.35 TB/s; 5.66 GFLOP, 5.7 us at 989
// TFLOP/s bf16.  float32: 78.6 MB + 209.7 MB = 288.4 MB, 86.1 us; 5.66 GFLOP
// on the CUDA cores at 67 TFLOP/s, 84.5 us: bytes-bound, barely.  The first
// version ran one CTA per tile, load -> sync -> conv -> sums -> sync -> pool
// in series, and took the same time in float32 as in bf16 on twice the
// bytes: bound by latency and instruction issue.  This design
// (stem_core.cuh): a persistent grid of three CTAs an SM (at most 80
// registers a thread); in each step a CTA copies tile k+1's NHWC rows by
// cp.async (4 bytes a copy in bf16, 8 in float32) while it convolves and
// pools.  bf16: the conv on the tensor cores, the sums in its epilogue, and
// two conv tiles, so that the pools of tile k-1 run beside the conv of tile
// k behind one barrier a tile.  float32: the weights come from constant
// memory through uniform registers (off the shared-memory pipe), the sums
// ride in the pool, and one conv tile (80 B a position) keeps the CTA at 63
// KB.  Shared memory a CTA: bf16 64 KB, float32 63 KB (dynamic, above the
// 48 KB static limit).

#include <type_traits>

#include "stem_core.cuh"

namespace {

using namespace stem;

constexpr int ROWE = 106;  // staged elements per input row: 35 pixels x 3, even

// The float32 instantiation's weights, (co, ci, dy, dx) as given, copied here
// on the launch's stream just before the launch (ops/cuda_stem_train.py
// orders launches from different streams, which share this buffer)
__constant__ float c_weight[CO * 27];

// stage value (ci, r, c) of the tile (input row y0 - 1 + r, col x0 - 1 + c)
// sits at r*ROWE + c*3 + ci: NHWC rows as they are in device memory
typedef StageLayout<1, ROWE, 3, 0> TrainLayout;

template <typename T>
struct TrainSmem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // conv tile elements per position: 48 B in bf16, 80 B in float32, so that
  // the pool's 16-byte reads of neighbouring windows and the float32
  // epilogue's stores spread over the banks
  static constexpr int SCS = kF32 ? 20 : 24;
  static constexpr int kConvTiles = kF32 ? 1 : 2;  // stem_core.cuh::walk_tiles
  alignas(16) T conv[kConvTiles][NPOS * SCS];
  alignas(16) T stage[2][IR * ROWE];
  alignas(16) double red[WARPS * 2 * CO];
};

// The tile's input rows y0 - 1 .. y0 + IR - 2, pixels x0 - 1 .. x0 + IC - 2,
// as element pairs (4 bytes in bf16, 8 in float32; the pixel x0 - 1 is even
// and W is even, so every pair is aligned and lies wholly inside or outside
// the image).  Pairs outside are zero-filled: the conv's pad-1 halo.  Thread
// tid < 4 * PAIRS copies pair tid % PAIRS of rows tid / PAIRS, + 4, + 8, ...:
// its column, and so whether that lies inside the image, is the same in
// every row.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ img, T* dst, int y0, int x0,
                                           int H, int W) {
  constexpr int PAIRS = ROWE / 2, GROUPS = THREADS / PAIRS;
  if (threadIdx.x >= GROUPS * PAIRS) return;
  const int e = 2 * (threadIdx.x % PAIRS), r0 = threadIdx.x / PAIRS;
  const int xs = x0 - 1;
  const bool col_ok = xs + e / 3 >= 0 && xs + (e + 1) / 3 < W;
  long long off = ((long long)(y0 - 1 + r0) * W + xs) * 3 + e;  // element of row r0
  for (int r = r0; r < IR; r += GROUPS, off += (long long)GROUPS * W * 3) {
    const int gy = y0 - 1 + r;
    const bool ok = col_ok && gy >= 0 && gy < H;
    cp_async<static_cast<int>(2 * sizeof(T))>(dst + r * ROWE + e, ok ? img + off : img, ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
stem_train_kernel(const T* __restrict__ x, const T* __restrict__ weight, T* __restrict__ pmax,
                  T* __restrict__ pmin, double* __restrict__ partials, int B, int H, int W) {
  typedef TrainSmem<T> Smem;
  constexpr bool kF32 = Smem::kF32;
  constexpr int SCS = Smem::SCS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tiles_x = tiles_x_of(W), tiles_y = tiles_y_of(H);
  const size_t img_elems = (size_t)H * W * 3;

  MmaOperands ops;
  if constexpr (!kF32) mma_operands<TrainLayout>(weight, nullptr, ops);
  // the sums (stem_core.cuh, "C's sums"): in bf16 lane % 4 = t holds
  // channels 2t, 2t + 1, 8 + 2t, 9 + 2t of the conv epilogue; in float32 the
  // pool item's half h holds channels 4h .. 4h + 3 and 8 + 4h .. 11 + 4h
  typedef typename std::conditional<kF32, float, double>::type Acc;
  constexpr int NS = kF32 ? 8 : 4;
  int ch[NS];
  if constexpr (kF32) {
    const int h = threadIdx.x & 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) ch[j] = 4 * h + j, ch[4 + j] = 8 + 4 * h + j;
  } else {
    const int t = threadIdx.x & 3;
    ch[0] = 2 * t, ch[1] = 2 * t + 1, ch[2] = 8 + 2 * t, ch[3] = 9 + 2 * t;
  }
  Acc sum[NS], sq[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) sum[j] = sq[j] = 0;

  walk_tiles<Smem::kConvTiles>(
      B, tiles_x, tiles_y,
      [&](const Tile& t, int buf) {
        stage_tile(x + t.b * img_elems, sm.stage[buf], 2 * t.pr0 - 1, 2 * t.pc0 - 1, H, W);
      },
      [&](const Tile& t, int sbuf, int cbuf) {
        T* conv = sm.conv[cbuf];
        if constexpr (kF32) {
          conv_tile_fma<TrainLayout>(
              sm.stage[sbuf], [](int co, int k) { return c_weight[co * 27 + k]; },
              [&](int p, int g, float a0, float a1, float a2, float a3) {
                *reinterpret_cast<float4*>(conv + p * SCS + 4 * g) = make_float4(a0, a1, a2, a3);
              });
        } else {  // c^ rounded to bf16, summed where the tile owns it
          conv_tile_mma<TrainLayout>(
              sm.stage[sbuf], ops, [&](int p, int c, float v0, float v1, float v2, float v3) {
                const uint32_t lo = pack2(v0, v1), hi = pack2(v2, v3);
                uint32_t* dst = reinterpret_cast<uint32_t*>(conv + p * SCS);
                dst[c / 2] = lo;
                dst[c / 2 + 4] = hi;
                if (owns(p, t, H, W)) {
                  const float2 a = unpack2(lo), b = unpack2(hi);
                  sums_add<4>({a.x, a.y, b.x, b.y}, sum, sq);
                }
              });
        }
      },
      [&](const Tile& t, int buf) {
        pool_max_min<SCS>(sm.conv[buf], pmax, pmin, t, H, W, [&](const Pack8<T>& v) {
          if constexpr (kF32) sums_add<8>(v.v, sum, sq);
        });
      });
  sums_write<kF32 ? 2 : 4>(sum, sq, ch, sm.red, partials + (size_t)blockIdx.x * 2 * CO);
}

template <typename T>
int info(int* out) {
  return kernel_info(stem_train_kernel<T>, static_cast<int>(sizeof(TrainSmem<T>)), out);
}

template <typename T>
int launch(const void* x, const void* weight, void* pmax, void* pmin, void* partials, int B,
           int H, int W, int n_cta, void* stream) {
  if (!grid_ok(n_cta, B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(TrainSmem<T>));
  cudaError_t e = cudaFuncSetAttribute(stem_train_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (std::is_same<T, float>::value) {
    e = cudaMemcpyToSymbolAsync(c_weight, weight, sizeof(c_weight), 0,
                                cudaMemcpyDeviceToDevice, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  stem_train_kernel<T><<<n_cta, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), static_cast<T*>(pmax),
      static_cast<T*>(pmin), static_cast<double*>(partials), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// info[5]: registers, stack bytes, static and dynamic shared memory, resident
// CTAs on the current device, of the bf16 (f32 == 0) or float32 kernel;
// returns a CUDA error code.
extern "C" int stem_train_info(int f32, int* out) {
  return f32 ? info<float>(out) : info<__nv_bfloat16>(out);
}

extern "C" int stem_train_bf16(const void* x, const void* weight, void* pmax, void* pmin,
                               void* partials, int B, int H, int W, int n_cta, void* stream) {
  return launch<__nv_bfloat16>(x, weight, pmax, pmin, partials, B, H, W, n_cta, stream);
}

extern "C" int stem_train_f32(const void* x, const void* weight, void* pmax, void* pmin,
                              void* partials, int B, int H, int W, int n_cta, void* stream) {
  return launch<float>(x, weight, pmax, pmin, partials, B, H, W, n_cta, stream);
}
