// Fused eval stem for Hopper (sm_90a), kernel A: conv3x3 s1 (3 -> 16) with
// eval-BN and the /255 input scale folded into the weights, then maxpool 3x3
// s2 pad 1, then ReLU.  Only the pooled map is written to device memory.
//
// Replaces the TPU kernels of dcfa_yolo_tpu/ops/pallas_stem.py:
//   pallas_stem (_stem_kernel, v2), pallas_stem_d (_stem_kernel_d, v3),
//   pallas_stem_e (_stem_kernel_e, v4) and pallas_stem_f (_stem_kernel_f, v5).
// The four compute one function over four TPU canvas layouts; this kernel
// computes it over the plain zero-bordered canvas and follows the v4 weight
// contract (fold_stem_params_e): bf16 weights, a bf16-rounded bias, f32
// accumulation, the conv value rounded to bf16 BEFORE the max tree
// (pallas_stem.py:260-264), ReLU after the pool (it absorbs the pad:
// relu(max(S u {pad})) == relu(max(S))).  As in v4 (pallas_stem.py:174-196)
// the bias rides in K row 27 of the conv GEMM against an operand column
// fixed at 1.0; 1.0, the raw 0..255 pixels and their products with bf16
// weights are exact, so only the f32 summation order differs from the plain
// version (the v4 class).
//
// Contract
//   canvas (B, 3, H+2, W+2) bf16: raw 0..255 pixels, 1-px zero border
//   weight (16, 3, 3, 3) bf16, bias (16,) f32
//   out    (B, H/2, W/2, 16) bf16 (NHWC == NCHW in channels_last); H, W even
//   n_cta  the persistent grid, 1 <= n_cta <= tiles (ops/stem_core.py)
//
// Bound (640^2, per image and modality): 3 * 642 * 642 * 2 B = 2.47 MB in,
// 320 * 320 * 16 * 2 B = 3.28 MB out, 640 * 640 * 16 * 27 * 2 = 354 MFLOP.
// max(5.75 MB / 3.35 TB/s, 354 MFLOP / 989 TFLOP/s) = 1.7 us: bytes bound it
// by a wide margin.  The first version (one CTA a tile, a 16 x 27 f32 FMA
// loop per conv position reading its weights from shared memory) took 255
// registers and 928 B of stack, so one CTA fitted an SM and its load, conv
// and pool ran one after the other with nothing to hide their latency.  This
// design (stem_core.cuh): the conv on the tensor cores (four mma.sync per
// 16 positions, the B fragments in 8 registers), which frees the registers
// for three CTAs an SM (at most 80 registers a thread); a persistent grid
// whose CTAs copy tile k+1's canvas by cp.async and pool tile k-1 while
// they convolve tile k, one barrier a tile; the conv tiles in shared memory
// at a 48-byte position stride, so that the pool's 16-byte reads of
// neighbouring windows fall in distinct banks.  62 KB of shared memory a
// CTA (dynamic).

#include "stem_core.cuh"

namespace {

using namespace stem;

constexpr int ICB = IC + 1;  // staged canvas cols, from the even column x0 - 1
constexpr int WORDS = ICB / 2;  // 4-byte copies per staged row
constexpr int SCS = 24;      // conv tile: bf16 elements per position (16 used)

// stage value (ci, r, c) of the tile (canvas row y0 + r, col x0 + c) sits at
// ci*IR*ICB + r*ICB + c + 1: row r starts at the even column x0 - 1
typedef StageLayout<IR * ICB, ICB, 1, 1> EvalLayout;

struct EvalSmem {
  alignas(16) bf16 conv[2][NPOS * SCS];
  alignas(16) bf16 stage[2][3 * IR * ICB];
};

// The tile's canvas rows y0 .. y0 + IR - 1, cols x0 - 1 .. x0 + IC - 1, by
// 4-byte cp.async (canvas rows are W + 2 elements: only 4 bytes align).
// Pairs outside the canvas are zero-filled; gx and W + 2 are even, so a pair
// lies wholly inside or outside.  Thread tid < 14 * WORDS copies word
// tid % WORDS of staged rows (ci, r) = tid / WORDS, + 14, ... (3 * IR rows).
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ img, bf16* dst, int y0,
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

__global__ void __launch_bounds__(THREADS, 3)
stem_eval_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__ weight,
                 const float* __restrict__ bias, bf16* __restrict__ out, int B, int H,
                 int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  EvalSmem& sm = *reinterpret_cast<EvalSmem*>(smem_raw);
  const int tiles_x = tiles_x_of(W), tiles_y = tiles_y_of(H);
  const int H2 = H + 2, W2 = W + 2;
  const size_t img_elems = (size_t)3 * H2 * W2;

  MmaOperands ops;
  mma_operands<EvalLayout>(weight, bias, ops);

  walk_tiles<2>(
      B, tiles_x, tiles_y,
      [&](const Tile& t, int buf) {
        stage_tile(canvas + t.b * img_elems, sm.stage[buf], 2 * t.pr0 - 1, 2 * t.pc0 - 1, H2,
                   W2);
      },
      [&](const Tile& t, int sbuf, int cbuf) {
        // conv positions outside the image are the pool's padding: -inf
        const int y0 = 2 * t.pr0 - 1, x0 = 2 * t.pc0 - 1;
        bf16* conv = sm.conv[cbuf];
        conv_tile_mma<EvalLayout>(
            sm.stage[sbuf], ops, [&](int p, int ch, float v0, float v1, float v2, float v3) {
              const int y = y0 + p / CC, x = x0 + p % CC;
              const bool in = y >= 0 && y < H && x >= 0 && x < W;
              uint32_t* dst = reinterpret_cast<uint32_t*>(conv + p * SCS);
              dst[ch / 2] = in ? pack2(v0, v1) : BF16_NEG_INF2;
              dst[ch / 2 + 4] = in ? pack2(v2, v3) : BF16_NEG_INF2;
            });
      },
      [&](const Tile& t, int buf) { pool_max_relu<SCS>(sm.conv[buf], out, t, H / 2, W / 2); });
}

}  // namespace

// info[5]: registers, stack bytes, static and dynamic shared memory, resident
// CTAs on the current device; returns a CUDA error code.
extern "C" int stem_eval_info(int* info) {
  return kernel_info(stem_eval_kernel, static_cast<int>(sizeof(EvalSmem)), info);
}

extern "C" int stem_eval_bf16(const void* canvas, const void* weight, const void* bias,
                              void* out, int B, int H, int W, int n_cta, void* stream) {
  if (!grid_ok(n_cta, B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(EvalSmem));
  cudaError_t e = cudaFuncSetAttribute(stem_eval_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  stem_eval_kernel<<<n_cta, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(canvas), static_cast<const bf16*>(weight),
      static_cast<const float*>(bias), static_cast<bf16*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dcfa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
