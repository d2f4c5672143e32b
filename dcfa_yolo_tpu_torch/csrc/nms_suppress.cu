// Greedy NMS suppression for Hopper (sm_90a): the keep mask over score-sorted,
// class-offset candidates.  Candidate i is kept if it is still alive; it then
// suppresses every later j with IoU(i, j) > thr (strict, f32).
//
// Replaces the TPU kernels of dcfa_yolo_tpu/ops/pallas_nms.py:
//   pallas_greedy_suppress -> _suppress_planes -> _nms_kernel (per image) and
//   _suppress_planes_batched -> _nms_kernel_batched (images on lanes).
// Both compute one function in two TPU tilings; on the GPU one CTA per image
// covers every batch size.
//
// Contract
//   boxes (B, K, 4) f32 xyxy, score-sorted per image; alive (B, K) bool
//   keep  (B, K) bool;  K <= 1024
//
// Numerics: the IoU keeps the Pallas expression order exactly,
// inter / (area_j + area_i - inter + 1e-7) (pallas_nms.py:86-90), with
// round-to-nearest f32 ops.  The source is compiled with -fmad=false so no
// multiply-add is contracted into an FMA: an IoU right at the threshold
// rounds as in the JAX package and does not flip.
//
// Bound: B*K*18 bytes (16 B of box + 1 B alive in, 1 B keep out) - 18 KB at
// B=1, K=1024, about 6 ns of memory time.  What sets the time is the serial
// chain: one pass per candidate up to the last alive one, each kept
// candidate a block-wide IoU row and a __syncthreads().  The design keeps
// that chain short: boxes, areas and alive flags live in shared memory
// (20 KB), the loop stops at the last alive index + 1, a suppressed
// candidate costs one shared-memory read and no barrier, and each kept row
// only visits the candidates after it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 1024;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
nms_suppress_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ alive,
                    uint8_t* __restrict__ keep, int K, float thr) {
  __shared__ float sx1[MAX_K], sy1[MAX_K], sx2[MAX_K], sy2[MAX_K], sar[MAX_K];
  __shared__ uint8_t sal[MAX_K];
  __shared__ int s_n;

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * K;
  if (tid == 0) s_n = 0;
  __syncthreads();

  int last = 0;
  for (int j = tid; j < K; j += THREADS) {
    const float4 bx = boxes[base + j];
    sx1[j] = bx.x;
    sy1[j] = bx.y;
    sx2[j] = bx.z;
    sy2[j] = bx.w;
    sar[j] = __fmul_rn(__fsub_rn(bx.z, bx.x), __fsub_rn(bx.w, bx.y));
    const uint8_t a = alive[base + j] ? 1 : 0;
    sal[j] = a;
    if (a) last = j + 1;
  }
  atomicMax(&s_n, last);
  __syncthreads();
  const int n = s_n;  // candidates past the last alive one are no-ops

  for (int i = 0; i < n; ++i) {
    // uniform across the block: every write to sal[] from earlier rows has
    // passed the barrier that closed that row
    if (!sal[i]) continue;
    const float bx1 = sx1[i], by1 = sy1[i], bx2 = sx2[i], by2 = sy2[i];
    const float ba = sar[i];
    for (int j = i + 1 + tid; j < n; j += THREADS) {
      if (!sal[j]) continue;
      const float iw = fmaxf(__fsub_rn(fminf(sx2[j], bx2), fmaxf(sx1[j], bx1)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(sy2[j], by2), fmaxf(sy1[j], by1)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float den = __fadd_rn(__fsub_rn(__fadd_rn(sar[j], ba), inter), 1e-7f);
      if (__fdiv_rn(inter, den) > thr) sal[j] = 0;
    }
    __syncthreads();
  }

  for (int j = tid; j < K; j += THREADS) keep[base + j] = sal[j];
}

}  // namespace

extern "C" int nms_suppress(const void* boxes, const void* alive, void* keep,
                            int B, int K, float thr, void* stream) {
  if (B > 0) {
    nms_suppress_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(boxes), static_cast<const uint8_t*>(alive),
        static_cast<uint8_t*>(keep), K, thr);
  }
  return static_cast<int>(cudaGetLastError());
}
