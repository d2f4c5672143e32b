// Greedy NMS suppression for Hopper (sm_90a): the keep mask over score-sorted,
// class-offset candidates.  Candidate i is kept if it is still alive; it then
// suppresses every later j with IoU(i, j) > thr (strict, f32).
//
// Replaces the TPU kernels of dcfa_yolo_tpu/ops/pallas_nms.py:
//   pallas_greedy_suppress -> _suppress_planes -> _nms_kernel (per image) and
//   _suppress_planes_batched -> _nms_kernel_batched (images on lanes).
// Both compute one function in two TPU tilings; here one pair of kernels
// covers every batch size.
//
// Contract
//   boxes (B, K, 4) f32 xyxy, score-sorted per image; alive (B, K) bool
//   keep  (B, K) bool; any K whose scratch fits device memory
//   scratch: B images of (Kp + 1) rows of W u32 words, from the caller
//     NW = ceil(K/32) words hold a row's K bits, W = NW rounded up to a
//     multiple of 4 (16-byte rows), Kp = 32*NW rows.  Row i of image b is
//     mask[b][i][w]: bit t of word w is column j = 32w + t, set when
//     i < j < K and IoU(i, j) > thr.  Row Kp holds the alive bits.
//
// Numerics: the IoU keeps the Pallas expression order exactly,
// inter / (area_j + area_i - inter + 1e-7) (pallas_nms.py:86-90), with
// round-to-nearest f32 ops.  The source is compiled with -fmad=false so no
// multiply-add is contracted into an FMA: an IoU right at the threshold
// rounds as in the JAX package and does not flip.
//
// Bound: B*K*18 bytes in and out, and 12 f32 ops for each IoU pair the
// greedy pass needs.  What sets the time is the serial chain of greedy
// decisions.  The first port (one CTA per image, one block barrier per kept
// row) carried the IoU arithmetic and a __syncthreads in every step of it.
// This design splits the parallel work from the serial work:
//
//   Phase 1, nms_mask_kernel (parallel): the IoU relation as a bitmask.  A
//   CTA owns a 64 x 64 tile of the upper triangle (row group g, column group
//   q >= g, one image), stages the column boxes in shared memory, and each
//   thread computes one row's 64 bits and stores them as two words.  Rows
//   that are not alive are not written: the scan reads only rows it keeps.
//   Bits j <= i are written as 0.  The diagonal tiles also write the image's
//   alive bits (row Kp).  It evaluates every alive upper-triangle pair, more
//   than the greedy pass needs, but on every SM at once.
//
//   Phase 2, nms_scan_kernel (serial, one warp per image, no block
//   barrier): removed = ~alive in shared memory; the candidates are walked
//   in blocks of 32 up to the last alive one.  For block c every lane reads
//   the 32 diagonal words mask[32c + t][c] (broadcast loads) and resolves
//   the 32 decisions in registers; then each lane ORs the kept rows' words
//   w > c, four rows a round, into its words of removed.  The blocks' rows
//   reach shared memory by cp.async.bulk (TMA, 1-D, completion on an
//   mbarrier a stage): a ring of up to 32 stages, all issued at the start
//   where they fit (K <= 1024 fits whole), each refilled as soon as it is
//   read, so the chain waits on shared memory, not on L2.  The scan is a
//   programmatic dependent launch of phase 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 64;        // phase 1: rows and columns of a tile
constexpr int CHUNK_W = 128;    // phase 2: words of a row a partial chunk stages
constexpr int MAX_STAGES = 32;  // phase 2: chunks in flight at most
constexpr int MAX_STATIC_SMEM = 48 * 1024;
constexpr int MAX_SMEM = 232448;          // a block's opt-in limit on sm_90
constexpr int MAX_DEVICES = 64;

// the tile (g, q), q >= g, of linear index t in the upper triangle of an
// N x N grid, row by row: row g starts at S(g) = g*N - g*(g-1)/2
__device__ __forceinline__ void triangle_tile(long long t, int N, int& g, int& q) {
  const double a = 2.0 * N + 1.0;
  int r = static_cast<int>((a - sqrt(a * a - 8.0 * static_cast<double>(t))) * 0.5);
  auto start = [N](long long row) { return row * N - row * (row - 1) / 2; };
  r = r < 0 ? 0 : (r > N - 1 ? N - 1 : r);
  while (r > 0 && start(r) > t) --r;
  while (r < N - 1 && start(r + 1) <= t) ++r;
  g = r;
  q = r + static_cast<int>(t - start(r));
}

__global__ void __launch_bounds__(TILE)
nms_mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ alive,
                uint32_t* __restrict__ scratch, int K, int N, int W, int Kp,
                float thr) {
  __shared__ float4 sbox[TILE];
  __shared__ float sar[TILE];
  int g, q;
  triangle_tile(blockIdx.x, N, g, q);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = g * TILE + tid;
  const size_t base = static_cast<size_t>(b) * K;
  uint32_t* img = scratch + static_cast<size_t>(b) * (Kp + 1) * W;
  // every global load of the CTA goes out at once
  const int jt = q * TILE + tid;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool al = i < K && alive[base + i];
  const float4 bj = jt < K ? boxes[base + jt] : zero;
  const float4 bi = i < K ? boxes[base + i] : zero;
  if (q == g) {  // the image's alive bits: words 2g, 2g + 1 of row Kp
    const unsigned bits = __ballot_sync(FULL, al);
    if ((tid & 31) == 0) img[static_cast<size_t>(Kp) * W + 2 * g + (tid >> 5)] = bits;
  }
  sbox[tid] = bj;
  sar[tid] = __fmul_rn(__fsub_rn(bj.z, bj.x), __fsub_rn(bj.w, bj.y));
  if (!__syncthreads_or(al) || !al) return;  // rows that are not alive are never read

  const float ai = __fmul_rn(__fsub_rn(bi.z, bi.x), __fsub_rn(bi.w, bi.y));
  // inter is never negative, so inter / den is +-0 or NaN where inter == 0:
  // above thr only for thr < 0 and a den that is neither 0 nor NaN.  Those
  // pairs skip the division, whose range check sends a zero numerator down
  // its slow path.
  const bool zero_passes = thr < 0.f;
  uint32_t word[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the word's bits j with i < j < K (j = q*TILE + 32h + t)
    const int j0 = q * TILE + 32 * h;
    const int lo = i - j0, hi = K - j0;
    uint32_t valid = lo >= 31 ? 0u : (lo < 0 ? FULL : ~((2u << lo) - 1u));
    if (hi < 32) valid &= hi <= 0 ? 0u : (1u << hi) - 1u;
    uint32_t bits = 0;
#pragma unroll 8
    for (int t = 0; t < 32; ++t) {
      const float4 bc = sbox[32 * h + t];
      const float ac = sar[32 * h + t];
      const float iw = fmaxf(__fsub_rn(fminf(bc.z, bi.z), fmaxf(bc.x, bi.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(bc.w, bi.w), fmaxf(bc.y, bi.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float den = __fadd_rn(__fsub_rn(__fadd_rn(ac, ai), inter), 1e-7f);
      const bool nz = inter != 0.f;
      const float quot = __fdiv_rn(nz ? inter : 1.f, den);
      const bool hit = nz ? quot > thr : zero_passes && den == den && den != 0.f;
      bits |= static_cast<uint32_t>(hit) << t;
    }
    word[h] = bits & valid;
  }
  *reinterpret_cast<uint2*>(img + static_cast<size_t>(i) * W + 2 * q) =
      make_uint2(word[0], word[1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// Phase 2's chunks, in the order the scan reads them.  A chunk is block c's
// 32 rows, words [s, s + len).  Where two whole row blocks fit in shared
// memory (cw == W, K up to about 28,000) a chunk is the whole block: 32*W
// contiguous words, one bulk copy.  Past that a block is cut into chunks of
// cw = CHUNK_W words from s = (c & ~3), one bulk copy per row (16-byte
// aligned, since s and W are multiples of 4).
__device__ __forceinline__ int chunks_of(int c, int W, int cw) {
  return cw == W ? 1 : (W - (c & ~3) + cw - 1) / cw;
}

__device__ __forceinline__ int chunk_start(int c, int k, int W, int cw) {
  return cw == W ? 0 : (c & ~3) + k * cw;
}

// Copy block c (32 rows of W words, contiguous) into `buf`, completing on
// `bar`: one bulk copy by the calling thread.
__device__ __forceinline__ void issue_block(const uint32_t* img, int c, int W, uint32_t* buf,
                                            uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(32 * W * 4)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(buf)),
      "l"(img + static_cast<size_t>(32 * c) * W), "r"(32 * W * 4), "r"(bar)
      : "memory");
}

// Copy chunk (c, k) into `buf` (row stride `sp` words), completing on
// `bar`; every lane of the warp calls it.  The caller's __syncwarp orders
// it after the reads of the stage's previous chunk (the stages are written
// only by these copies).
__device__ __forceinline__ void issue_chunk(const uint32_t* img, int c, int k, int W,
                                            int cw, uint32_t* buf, int sp, uint32_t bar,
                                            int lane) {
  if (cw == W) {
    if (lane == 0) issue_block(img, c, W, buf, bar);
    return;
  }
  const int s = chunk_start(c, k, W, cw);
  const int len = min(cw, W - s);
  if (lane == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(32 * len * 4)
                 : "memory");
  }
  __syncwarp();
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(buf + lane * sp)),
      "l"(img + static_cast<size_t>(32 * c + lane) * W + s), "r"(len * 4), "r"(bar)
      : "memory");
}

// Shared memory of the scan: `stages` mbarriers (16-byte padded), then the
// stages' rows (32 x sp words each), then removed (W words).
__host__ __device__ __forceinline__ int scan_bar_bytes(int stages) {
  return (8 * stages + 15) / 16 * 16;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const uint32_t* __restrict__ scratch, uint8_t* __restrict__ keep, int K,
                int W, int Kp, int cw, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  const int sp = cw == W ? W : cw + 4;  // staged row stride in words (16-byte rows)
  uint32_t* bufs = reinterpret_cast<uint32_t*>(smem_raw + scan_bar_bytes(stages));
  uint32_t* removed = bufs + stages * 32 * sp;

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int NW = (K + 31) / 32;
  const uint32_t* img = scratch + static_cast<size_t>(b) * (Kp + 1) * W;
  const uint32_t* alive_bits = img + static_cast<size_t>(Kp) * W;
  for (int st = lane; st < stages; st += 32)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + st))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();
  // launched as a programmatic dependent of phase 1: wait here for its
  // writes (a no-op in a plain launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // the producer's next chunk (pc, pk): up to `stages` chunks are in flight
  // ahead of the one being read, each stage refilled as soon as it is read.
  // The first ones go out before n is known (every block below NW exists);
  // whole blocks one a lane, all at once.
  int pc = 0, pk = 0, issued = 0;
  auto issue_next = [&](int st) {
    issue_chunk(img, pc, pk, W, cw, bufs + st * 32 * sp, sp, smem_addr(bars + st), lane);
    ++issued;
    if (++pk == chunks_of(pc, W, cw)) { ++pc; pk = 0; }
  };
  if (cw == W) {
    pc = issued = min(stages, NW);
    for (int c = lane; c < pc; c += 32)
      issue_block(img, c, W, bufs + c * 32 * sp, smem_addr(bars + c));
  } else {
    for (int st = 0; st < stages && pc < NW; ++st) issue_next(st);
  }

  // removed = ~alive; n = last alive index + 1 (a warp-uniform bound)
  int n = 0;
  for (int w = lane; w < NW; w += 32) {
    const uint32_t a = alive_bits[w];
    removed[w] = ~a;
    if (a) n = 32 * w + 32 - __clz(a);
  }
  n = __reduce_max_sync(FULL, n);
  __syncwarp();
  const int NB = (n + 31) / 32;

  int st = 0, parity = 0, consumed = 0;  // the stage being read, its phase
  auto next_stage = [&]() {
    ++consumed;
    if (++st == stages) { st = 0; parity ^= 1; }
  };
  for (int c = 0; c < NB; ++c) {
    const int nk = chunks_of(c, W, cw);
    unsigned kept = 0;
    for (int k = 0; k < nk; ++k) {
      mbar_wait(smem_addr(bars + st), parity);
      const uint32_t* ch = bufs + st * 32 * sp;
      const int cs = chunk_start(c, k, W, cw);
      if (k == 0) {
        // resolve the block's 32 decisions: row 32c + t is kept unless it is
        // removed by then, and a kept row removes the later ones it covers
        uint32_t d[32];  // the rows' diagonal words, read by every lane at once
#pragma unroll
        for (int t = 0; t < 32; ++t) d[t] = ch[t * sp + (c - cs)];
        uint32_t rw = removed[c];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          if (!(rw & (1u << t))) rw |= d[t];
        }
        kept = ~rw;
        __syncwarp();
        if (lane == 0) removed[c] = rw;
      }
      const int ce = min(cs + cw, NW);
      for (unsigned m = kept; m;) {
        // four kept rows a round (the first again where fewer are left), so
        // that their loads are in flight together
        const int t0 = __ffs(m) - 1;
        m &= m - 1;
        const int t1 = m ? __ffs(m) - 1 : t0;
        m &= m - 1;
        const int t2 = m ? __ffs(m) - 1 : t0;
        m &= m - 1;
        const int t3 = m ? __ffs(m) - 1 : t0;
        m &= m - 1;
        const int o0 = t0 * sp - cs, o1 = t1 * sp - cs, o2 = t2 * sp - cs, o3 = t3 * sp - cs;
#pragma unroll 2
        for (int w = max(cs, c + 1) + lane; w < ce; w += 32)
          removed[w] |= ch[o0 + w] | ch[o1 + w] | ch[o2 + w] | ch[o3 + w];
      }
      __syncwarp();
      if (pc < NB) issue_next(st);
      next_stage();
    }
  }
  // chunks issued ahead for blocks past the last alive one: let them land
  // before the CTA exits
  while (consumed < issued) {
    mbar_wait(smem_addr(bars + st), parity);
    next_stage();
  }
  uint8_t* out = keep + static_cast<size_t>(b) * K;
#pragma unroll 4
  for (int j = lane; j < K; j += 32) out[j] = !((removed[j >> 5] >> (j & 31)) & 1u);
}

// The scan's staging for rows of W words: whole row blocks as chunks where
// two fit beside removed (cw = W), else CHUNK_W words of each row; then as
// many stages as fit, up to MAX_STAGES, so that enough chunks are in flight
// to cover a bulk copy's latency.  False where fewer than two stages of
// CHUNK_W fit: past K ~ 1.5e6, whose scratch no card holds.
bool scan_plan(int W, int* cw, int* stages, int* smem) {
  const int room = MAX_SMEM - scan_bar_bytes(MAX_STAGES) - W * 4;
  *cw = room / (32 * W * 4) >= 2 ? W : CHUNK_W;
  const int stage_bytes = 32 * (*cw == W ? W : *cw + 4) * 4;
  *stages = min(MAX_STAGES, room / stage_bytes);
  *smem = scan_bar_bytes(*stages) + *stages * stage_bytes + W * 4;
  return *stages >= 2;
}

}  // namespace

// Dynamic shared memory of the scan for K candidates, in bytes (0 past the
// largest K it takes).
extern "C" int nms_scan_smem(int K) {
  const int W = ((K + 31) / 32 + 3) / 4 * 4;
  int cw, stages, smem;
  return scan_plan(W, &cw, &stages, &smem) ? smem : 0;
}

extern "C" int nms_suppress(const void* boxes, const void* alive, void* scratch,
                            int W, void* keep, int B, int K, float thr, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int NW = (K + 31) / 32;
  if (W % 4 || W < NW) return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = 32 * NW;
  const int N = (K + TILE - 1) / TILE;
  const long long tiles = static_cast<long long>(N) * (N + 1) / 2;
  if (tiles > 0x7fffffffLL || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int cw, stages, smem;
  if (!scan_plan(W, &cw, &stages, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(static_cast<unsigned>(tiles), B), TILE, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(alive),
      static_cast<uint32_t*>(scratch), K, N, W, Kp, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > MAX_STATIC_SMEM) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    static int opted_in[MAX_DEVICES] = {};
    if (dev >= MAX_DEVICES || smem > opted_in[dev]) {
      err = cudaFuncSetAttribute(nms_scan_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < MAX_DEVICES) opted_in[dev] = smem;
    }
  }
  // programmatic dependent launch: the scan's launch and barrier set-up
  // overlap phase 1's tail
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, nms_scan_kernel,
                                             static_cast<const uint32_t*>(scratch),
                                             static_cast<uint8_t*>(keep), K, W, Kp, cw,
                                             stages));
}
