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
// CTA (dynamic).  The walk (staging, smem layout) is eval_walk in
// stem_core.cuh and the conv step EvalConvMma, which the stem split probe's
// kernels share.

#include "stem_core.cuh"

namespace {

using namespace stem;

__global__ void __launch_bounds__(THREADS, 3)
stem_eval_kernel(const bf16* __restrict__ canvas, const bf16* __restrict__ weight,
                 const float* __restrict__ bias, bf16* __restrict__ out, int B, int H,
                 int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  eval_walk(canvas, B, H, W, *reinterpret_cast<EvalSmem*>(smem_raw),
            EvalConvMma(weight, bias, H, W), [&](const Tile& t, const bf16* conv) {
              pool_max_relu<EVAL_SCS>(conv, out, t, H / 2, W / 2);
            });
}

}  // namespace

// info[5]: registers, stack bytes, static and dynamic shared memory, resident
// CTAs on the current device; returns a CUDA error code.
extern "C" int stem_eval_info(int* info) {
  return kernel_info(stem_eval_kernel, static_cast<int>(sizeof(EvalSmem)), info);
}

extern "C" int stem_eval_bf16(const void* canvas, const void* weight, const void* bias,
                              void* out, int B, int H, int W, int n_cta, void* stream) {
  return launch_eval(stem_eval_kernel, canvas, weight, bias, out, B, H, W, n_cta, stream);
}

extern "C" const char* dcfa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
