// Train-mode BatchNorm for Hopper (sm_90a), kernel D: the batch moments,
// the normalise + affine + cast, and their backward, for ops/cuda_bn_train.py.
//
// Replaces no TPU kernel.  The JAX package writes its train BN as plain jnp
// (dcfa_yolo_tpu/ops/norm.py, TorchExactBatchNorm) and XLA fuses it on the
// TPU; eager PyTorch runs the same formula as some 25 float32 kernels a
// layer, forward and backward, and autograd keeps three float32 copies of
// every input.  D is that formula in six launches a layer.
//
// Contract (X = the input's type, float or bf16; Y = the output's; the
// routes are float -> bf16 (a conv's float32 sums, ops/conv.py::conv_bn),
// bf16 -> bf16 and float -> float):
//   x      (N, C, H, W) X, NCHW-contiguous or channels_last (NHWC in memory)
//   stats  (3, C) float: the batch mean, rstd = 1 / sqrt(var + eps), and the
//          mask of the variance's clamp (1 where mean2 - mean^2 >= 0)
//   y      x's strides, Y: ((x - mean) * rstd) * gamma + beta in float,
//          each operation rounded as the plain version's separate kernels
//          round it (no contraction), then one rounding to Y
//   g      the cotangent of y, y's strides, Y
//   dx     x's strides, X: rstd*gamma*g + b*(x - mean) + a per channel,
//          the formula as written (through mean and mean2, with the clamp's
//          mask), rounded once to X
//
// Launches (all on the caller's stream, no allocation, no atomics, and a
// fixed summation order, so that a replay and a recompute are bit-equal to
// the first run):
//   1. sums: one pass over x (or x and g) in 16-byte loads, per-channel
//      [sum x, sum x^2] (or [sum g, sum g (x - mean)]) kept in float over at
//      most FLUSH loads a thread, then in double; each block writes its
//      double partials to a (chunks, C, 2) scratch.  NCHW: a block owns one
//      channel and a chunk of its N*H*W/V vectors.  NHWC: a block owns a
//      chunk of the N*H*W rows and up to 32 column vectors, each thread one
//      column vector, the rows summed over the block's thread rows in order.
//   2. finalize: one warp a channel adds the partials in double (lane l the
//      chunks l, l + 32, ..., then a fixed shuffle tree); the moments: mean
//      and mean2 rounded to float (as the plain version's, and as the ranks
//      of a group exchange them), then in double var = max(mean2 - mean^2,
//      0) (the JAX formula, no Welford) and rstd, and torch's running update
//      (the plain version's float order, skipped under recomputation); the
//      backward: the cotangents of mean and mean2 and the gradients of gamma
//      and beta.  Across the ranks of a group the moments' finalize runs
//      twice around an all-reduce of [mean, mean2] in the wrapper, and the
//      cotangents of [mean, mean2] are all-reduced between the backward's
//      finalize and its apply.
//   3. elementwise: normalise (forward) or apply (backward), a grid-stride
//      pass in 16-byte loads with the per-channel terms in shared memory.
//
// Bound.  Bytes: at ~1 FLOP a byte D sits far below the card's 295 FLOP/B
// line.  Forward: x is read twice (sums, normalise) and y written once;
// backward: x and g read twice, dx written once: 26 B an element on the
// float32-sum route, 16 B on bf16 -> bf16.  The design moves no float32
// intermediate through memory, keeps a layer's second read of x (under
// ~40 MB) in L2, loads 16 bytes a thread, and sizes every grid from the SM
// count so that the smallest layers (0.4 M elements at b16) still fill the
// card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int FLUSH = 8;  // loads a thread sums in float before adding to its double

// ---- 16-byte (or narrower) loads and stores, converted to float ----------
template <int B>
struct RawOf;
template <>
struct RawOf<16> {
  typedef uint4 T;
};
template <>
struct RawOf<8> {
  typedef uint2 T;
};
template <>
struct RawOf<4> {
  typedef unsigned int T;
};

__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      out[0] = f.x, out[1] = f.y, out[2] = f.z, out[3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = p[j];
    }
  } else {
    if constexpr (V == 1) {
      out[0] = __uint_as_float(static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
                               << 16);
    } else {
      typedef typename RawOf<2 * V>::T Raw;
      const Raw r = *reinterpret_cast<const Raw*>(p);
      const unsigned* w = reinterpret_cast<const unsigned*>(&r);
#pragma unroll
      for (int j = 0; j < V / 2; ++j) out[2 * j] = bf_lo(w[j]), out[2 * j + 1] = bf_hi(w[j]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) p[j] = v[j];
    }
  } else {
    if constexpr (V == 1) {
      p[0] = __float2bfloat16_rn(v[0]);
    } else {
      typedef typename RawOf<2 * V>::T Raw;
      Raw r;
      unsigned* w = reinterpret_cast<unsigned*>(&r);
#pragma unroll
      for (int j = 0; j < V / 2; ++j) w[j] = bf_bits(v[2 * j]) | (bf_bits(v[2 * j + 1]) << 16);
      *reinterpret_cast<Raw*>(p) = r;
    }
  }
}

// ---- pass 1: per-channel sums ------------------------------------------
// kGrad false: [sum x, sum x^2]; true: [sum g, sum g (x - mean)].
template <bool kGrad, int V>
__device__ __forceinline__ void accumulate(const float (&a)[V], const float (&b)[V], float m,
                                           float& s, float& q) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if constexpr (kGrad) {
      s += b[j];
      q += b[j] * (a[j] - m);
    } else {
      s += a[j];
      q += a[j] * a[j];
    }
  }
}

// NCHW: block (chunk, channel c); vector v of the channel's N*HW/V is image
// v / hwv, vector v % hwv of its plane.
template <typename TX, typename TG, int V, bool kGrad>
__global__ void __launch_bounds__(THREADS)
    sums_nchw_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                     const float* __restrict__ stats, double* __restrict__ part, int C,
                     unsigned hwv, unsigned nv, unsigned chunk) {
  __shared__ double red[2][THREADS / 32];
  const int c = blockIdx.y;
  const float m = kGrad ? stats[c] : 0.f;
  const unsigned v0 = blockIdx.x * chunk;
  const unsigned v1 = min(v0 + chunk, nv);
  double s = 0.0, q = 0.0;
  float fs = 0.f, fq = 0.f;
  int k = 0;
  for (unsigned v = v0 + threadIdx.x; v < v1; v += THREADS) {
    const unsigned n = v / hwv, i = v - n * hwv;
    const size_t off = ((size_t)n * C + c) * hwv * V + (size_t)i * V;
    float a[V], b[V];
    load_vec<TX, V>(x + off, a);
    if constexpr (kGrad) load_vec<TG, V>(g + off, b);
    accumulate<kGrad, V>(a, b, m, fs, fq);
    if (++k == FLUSH) s += fs, q += fq, fs = fq = 0.f, k = 0;
  }
  s += fs, q += fq;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    q += __shfl_down_sync(0xffffffffu, q, o);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) red[0][warp] = s, red[1][warp] = q;
  __syncthreads();
  if (threadIdx.x < 2) {
    double t = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) t += red[threadIdx.x][w];
    part[((size_t)blockIdx.x * C + c) * 2 + threadIdx.x] = t;
  }
}

// NHWC: x is a (rows = N*H*W, C) matrix.  Block (chunk, column group): tx =
// thread % txn is the column vector (group * txn + tx), ty = thread / txn
// the first of its rows, which step by the block's txr = THREADS / txn.
template <typename TX, typename TG, int V, bool kGrad>
__global__ void __launch_bounds__(THREADS)
    sums_nhwc_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                     const float* __restrict__ stats, double* __restrict__ part, int C,
                     unsigned rows, unsigned chunk, int txn) {
  __shared__ double red[THREADS * 2 * V];
  const int txr = THREADS / txn, tx = threadIdx.x % txn, ty = threadIdx.x / txn;
  const int cv = blockIdx.y * txn + tx, ncv = C / V;
  const bool active = ty < txr && cv < ncv;
  float m[V], fs[V], fq[V];
  double s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = kGrad && active ? stats[cv * V + j] : 0.f;
    fs[j] = fq[j] = 0.f;
    s[j] = q[j] = 0.0;
  }
  if (active) {
    const unsigned r0 = blockIdx.x * chunk, r1 = min(r0 + chunk, rows);
    int k = 0;
    for (unsigned r = r0 + ty; r < r1; r += txr) {
      const size_t off = (size_t)r * C + cv * V;
      float a[V], b[V];
      load_vec<TX, V>(x + off, a);
      if constexpr (kGrad) load_vec<TG, V>(g + off, b);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (kGrad) {
          fs[j] += b[j];
          fq[j] += b[j] * (a[j] - m[j]);
        } else {
          fs[j] += a[j];
          fq[j] += a[j] * a[j];
        }
      }
      if (++k == FLUSH) {
#pragma unroll
        for (int j = 0; j < V; ++j) s[j] += fs[j], q[j] += fq[j], fs[j] = fq[j] = 0.f;
        k = 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[threadIdx.x * 2 * V + j] = s[j] + fs[j];
    red[threadIdx.x * 2 * V + V + j] = q[j] + fq[j];
  }
  __syncthreads();
  // output o = (column vector txo, word w): the thread rows' values in order
  for (int o = threadIdx.x; o < txn * 2 * V; o += THREADS) {
    const int txo = o / (2 * V), w = o % (2 * V), cvo = blockIdx.y * txn + txo;
    if (cvo >= ncv) continue;
    double t = 0.0;
    for (int r = 0; r < txr; ++r) t += red[(r * txn + txo) * 2 * V + w];
    part[((size_t)blockIdx.x * C + cvo * V + w % V) * 2 + w / V] = t;
  }
}

// ---- pass 2: the finalizes ----------------------------------------------
// One warp a channel: lane l adds the partials of chunks l, l + 32, ... in
// double, then a fixed shuffle tree gives lane 0 the channel's totals.
constexpr int FIN_THREADS = 256;

__device__ __forceinline__ void channel_totals(const double* __restrict__ part, int chunks,
                                               int C, int c, double& s, double& q) {
  s = 0.0, q = 0.0;
  for (int k = threadIdx.x & 31; k < chunks; k += 32) {
    s += part[((size_t)k * C + c) * 2];
    q += part[((size_t)k * C + c) * 2 + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    q += __shfl_down_sync(0xffffffffu, q, o);
  }
}

// The moments' tail for channel c from the float mean and mean2: not
// inlined, so that its float arguments are rounded whichever branch of the
// finalize called it (inlined, the compiler carried the local branch's
// double moments through the rounding, and a group of one then differed
// from no group in rstd's last bit).
__device__ __noinline__ void moments_tail(int c, int C, float mean_f, float mean2_f, double eps,
                                          float* __restrict__ stats, float* __restrict__ rmean,
                                          float* __restrict__ rvar, float om, float m,
                                          float bessel) {
  const double mean = mean_f, mean2 = mean2_f;
  const double raw = mean2 - mean * mean;
  const double var = raw >= 0.0 ? raw : 0.0;
  stats[c] = mean_f;
  stats[C + c] = static_cast<float>(1.0 / sqrt(var + eps));
  stats[2 * C + c] = raw >= 0.0 ? 1.f : 0.f;
  if (rmean != nullptr) {
    const float vf = static_cast<float>(var);
    rmean[c] = __fadd_rn(__fmul_rn(om, rmean[c]), __fmul_rn(m, mean_f));
    rvar[c] = __fadd_rn(__fmul_rn(om, rvar[c]), __fmul_rn(__fmul_rn(m, vf), bessel));
  }
}

// Moments.  `reduced` (2, C) float: the group's [mean, mean2], read in
// place of the partials.  `gather` (2, C): the local [mean, mean2] are
// written there and nothing else (the first half of the group's finalize).
// Otherwise stats and, with rmean, the running update
//   r <- (1 - m) r + m stat, the variance's stat times n / (n - 1),
// in float, in the plain version's order (om = 1 - m, both rounded by the
// caller as torch rounds a Python scalar).  The moments are rounded to
// float as the ranks of a group exchange them, so that a group of one
// gives what no group gives.
__global__ void __launch_bounds__(FIN_THREADS)
    moments_finalize_kernel(const double* __restrict__ part, int chunks, int C, double n,
                            double eps, const float* __restrict__ reduced,
                            float* __restrict__ gather, float* __restrict__ stats,
                            float* __restrict__ rmean, float* __restrict__ rvar, float om,
                            float m, float bessel) {
  const int c = blockIdx.x * (FIN_THREADS / 32) + threadIdx.x / 32;
  if (c >= C) return;  // the whole warp
  if (reduced != nullptr) {
    if ((threadIdx.x & 31) == 0)
      moments_tail(c, C, reduced[c], reduced[C + c], eps, stats, rmean, rvar, om, m, bessel);
    return;
  }
  double s, q;
  channel_totals(part, chunks, C, c, s, q);
  if ((threadIdx.x & 31) != 0) return;
  const float mean_f = static_cast<float>(s / n), mean2_f = static_cast<float>(q / n);
  if (gather != nullptr) {
    gather[c] = mean_f;
    gather[C + c] = mean2_f;
  } else {
    moments_tail(c, C, mean_f, mean2_f, eps, stats, rmean, rvar, om, m, bessel);
  }
}

// Backward: from [sum g, sum g (x - mean)] per channel, out (4, C) float:
//   dmean  = -gamma rstd sum g - 2 mean dvar      (the cotangent of mean)
//   dmean2 = dvar = mask * -0.5 gamma sum g (x - mean) rstd^3
//   dgamma = rstd sum g (x - mean),  dbeta = sum g.
__global__ void __launch_bounds__(FIN_THREADS)
    grad_finalize_kernel(const double* __restrict__ part, int chunks, int C,
                         const float* __restrict__ stats, const float* __restrict__ gamma,
                         float* __restrict__ out) {
  const int c = blockIdx.x * (FIN_THREADS / 32) + threadIdx.x / 32;
  if (c >= C) return;  // the whole warp
  double sg, sgc;
  channel_totals(part, chunks, C, c, sg, sgc);
  if ((threadIdx.x & 31) != 0) return;
  const double mean = stats[c], r = stats[C + c], mask = stats[2 * C + c], gm = gamma[c];
  const double dvar = mask * (-0.5 * gm * sgc * r * r * r);
  out[c] = static_cast<float>(-gm * r * sg - 2.0 * mean * dvar);
  out[C + c] = static_cast<float>(dvar);
  out[2 * C + c] = static_cast<float>(r * sgc);
  out[3 * C + c] = static_cast<float>(sg);
}

// ---- pass 3: elementwise --------------------------------------------------
// The channel of vector v: NCHW (v / hwv) % C (V divides H*W), NHWC the
// first of V channels (v % (C / V)) * V (V divides C).
template <int V, bool kNHWC>
__device__ __forceinline__ int channel_of(unsigned v, int C, unsigned hwv) {
  if constexpr (kNHWC) return static_cast<int>(v % static_cast<unsigned>(C / V)) * V;
  return static_cast<int>((v / hwv) % static_cast<unsigned>(C));
}

// y = ((x - mean) * rstd) * gamma + beta; sp: mean, rstd, gamma, beta.
template <typename TX, typename TY, int V, bool kNHWC>
__global__ void __launch_bounds__(THREADS)
    normalise_kernel(const TX* __restrict__ x, TY* __restrict__ y, const float* __restrict__ stats,
              const float* __restrict__ gamma, const float* __restrict__ beta, int C,
              unsigned hwv, unsigned nvec) {
  extern __shared__ float sp[];
  for (int c = threadIdx.x; c < C; c += THREADS) {
    sp[c] = stats[c], sp[C + c] = stats[C + c], sp[2 * C + c] = gamma[c], sp[3 * C + c] = beta[c];
  }
  __syncthreads();
  for (unsigned v = blockIdx.x * THREADS + threadIdx.x; v < nvec; v += gridDim.x * THREADS) {
    float a[V], o[V];
    load_vec<TX, V>(x + (size_t)v * V, a);
    const int c0 = channel_of<V, kNHWC>(v, C, (unsigned)hwv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = kNHWC ? c0 + j : c0;
      o[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a[j], sp[c]), sp[C + c]), sp[2 * C + c]),
                       sp[3 * C + c]);
    }
    store_vec<TY, V>(y + (size_t)v * V, o);
  }
}

// dx = kg g + b (x - mean) + a with, per channel (in double, then float),
// kg = gamma rstd, b = 2 dmean2 / n, a = dmean / n + b mean; dm: the
// (group's) [dmean, dmean2].
template <typename TX, typename TG, int V, bool kNHWC>
__global__ void __launch_bounds__(THREADS)
    apply_grad_kernel(const TX* __restrict__ x, const TG* __restrict__ g, TX* __restrict__ dx,
               const float* __restrict__ stats, const float* __restrict__ gamma,
               const float* __restrict__ dm, double inv_n, int C, unsigned hwv, unsigned nvec) {
  extern __shared__ float sp[];
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const double mean = stats[c], b = 2.0 * dm[C + c] * inv_n;
    sp[c] = static_cast<float>(static_cast<double>(gamma[c]) * stats[C + c]);
    sp[C + c] = static_cast<float>(b);
    sp[2 * C + c] = static_cast<float>(dm[c] * inv_n + b * mean);
    sp[3 * C + c] = stats[c];
  }
  __syncthreads();
  for (unsigned v = blockIdx.x * THREADS + threadIdx.x; v < nvec; v += gridDim.x * THREADS) {
    float a[V], b[V], o[V];
    load_vec<TX, V>(x + (size_t)v * V, a);
    load_vec<TG, V>(g + (size_t)v * V, b);
    const int c0 = channel_of<V, kNHWC>(v, C, hwv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = kNHWC ? c0 + j : c0;
      o[j] = sp[c] * b[j] + sp[C + c] * (a[j] - sp[3 * C + c]) + sp[2 * C + c];
    }
    store_vec<TX, V>(dx + (size_t)v * V, o);
  }
}

// ---- dispatch ---------------------------------------------------------------
struct Shape {
  int n, c;
  long long hw;
};

template <typename TX, typename TG, int V, bool kGrad>
int launch_sums(int nhwc, const void* x, const void* g, const void* stats, void* part,
                const Shape& s, int chunks, int chunk, int txn, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TG* gp = static_cast<const TG*>(g);
  const float* sp = static_cast<const float*>(stats);
  double* pp = static_cast<double*>(part);
  if (nhwc) {
    const int groups = (s.c / V + txn - 1) / txn;
    sums_nhwc_kernel<TX, TG, V, kGrad><<<dim3(chunks, groups), THREADS, 0, st>>>(
        xp, gp, sp, pp, s.c, (unsigned)(s.n * s.hw), (unsigned)chunk, txn);
  } else {
    sums_nchw_kernel<TX, TG, V, kGrad><<<dim3(chunks, s.c), THREADS, 0, st>>>(
        xp, gp, sp, pp, s.c, (unsigned)(s.hw / V), (unsigned)(s.n * s.hw / V), (unsigned)chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY, int V>
int launch_elementwise(int grad, int nhwc, const void* x, const void* g, void* out,
                       const void* stats, const void* gamma, const void* beta_or_dm, double inv_n,
                       const Shape& s, int grid, cudaStream_t st) {
  const unsigned hwv = (unsigned)(s.hw / V), nvec = (unsigned)((long long)s.n * s.c * s.hw / V);
  const size_t smem = 4 * s.c * sizeof(float);
  const float* sp = static_cast<const float*>(stats);
  const float* gm = static_cast<const float*>(gamma);
  const float* bd = static_cast<const float*>(beta_or_dm);
  if (grad) {
    const TX* xp = static_cast<const TX*>(x);
    const TY* gp = static_cast<const TY*>(g);
    TX* op = static_cast<TX*>(out);
    if (nhwc) {
      apply_grad_kernel<TX, TY, V, true>
          <<<grid, THREADS, smem, st>>>(xp, gp, op, sp, gm, bd, inv_n, s.c, hwv, nvec);
    } else {
      apply_grad_kernel<TX, TY, V, false>
          <<<grid, THREADS, smem, st>>>(xp, gp, op, sp, gm, bd, inv_n, s.c, hwv, nvec);
    }
  } else {
    const TX* xp = static_cast<const TX*>(x);
    TY* op = static_cast<TY*>(out);
    if (nhwc) {
      normalise_kernel<TX, TY, V, true>
          <<<grid, THREADS, smem, st>>>(xp, op, sp, gm, bd, s.c, hwv, nvec);
    } else {
      normalise_kernel<TX, TY, V, false>
          <<<grid, THREADS, smem, st>>>(xp, op, sp, gm, bd, s.c, hwv, nvec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The route (x's type, y's type): 0 float -> bf16, 1 bf16 -> bf16, 2 float
// -> float; -1 for any other pair.
int route_of(int xt, int yt) {
  if (xt == 0 && yt == 1) return 0;
  if (xt == 1 && yt == 1) return 1;
  if (xt == 0 && yt == 0) return 2;
  return -1;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  vec: 1 for 16-byte vectors (V = 16 /
// sizeof(x's type) elements; V divides C (NHWC) or H*W (NCHW), and every
// pointer is 16-byte aligned), 0 for one element a thread-step.  Each entry
// returns a CUDA error code (cudaGetLastError after its launch).

// Pass 1.  grad 0: [sum x, sum x^2] (g and stats unused); grad 1: [sum g,
// sum g (x - mean)], g of type gt.  NCHW: grid (chunks, C), `chunk` vectors
// a block; NHWC: grid (chunks, ceil(C / V / txn)), `chunk` rows a block.
extern "C" int bn_train_sums(int grad, int xt, int gt, int vec, int nhwc, const void* x,
                             const void* g, const void* stats, void* part, int n, int c,
                             long long hw, int chunks, int chunk, int txn, void* stream) {
  const Shape s{n, c, hw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = grad ? route_of(xt, gt) : xt;
  if (r < 0 || r > 2 || (!grad && r > 1)) return static_cast<int>(cudaErrorInvalidValue);
#define BN_SUMS(TX, TG, V, G) \
  launch_sums<TX, TG, V, G>(nhwc, x, g, stats, part, s, chunks, chunk, txn, st)
  if (!grad) {
    if (xt == 0) return vec ? BN_SUMS(float, float, 4, false) : BN_SUMS(float, float, 1, false);
    return vec ? BN_SUMS(bf16, bf16, 8, false) : BN_SUMS(bf16, bf16, 1, false);
  }
  switch (r) {
    case 0:
      return vec ? BN_SUMS(float, bf16, 4, true) : BN_SUMS(float, bf16, 1, true);
    case 1:
      return vec ? BN_SUMS(bf16, bf16, 8, true) : BN_SUMS(bf16, bf16, 1, true);
    default:
      return vec ? BN_SUMS(float, float, 4, true) : BN_SUMS(float, float, 1, true);
  }
#undef BN_SUMS
}

// Pass 2, the moments (see moments_finalize); rmean null: no running update.
extern "C" int bn_train_finalize(const void* part, int chunks, int c, double n, double eps,
                                 const void* reduced, void* gather, void* stats, void* rmean,
                                 void* rvar, float om, float m, float bessel, void* stream) {
  const int blocks = (c + FIN_THREADS / 32 - 1) / (FIN_THREADS / 32);
  moments_finalize_kernel<<<blocks, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), chunks, c, n, eps, static_cast<const float*>(reduced),
      static_cast<float*>(gather), static_cast<float*>(stats), static_cast<float*>(rmean),
      static_cast<float*>(rvar), om, m, bessel);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2, the backward (see grad_finalize).
extern "C" int bn_train_grad_finalize(const void* part, int chunks, int c, const void* stats,
                                      const void* gamma, void* out, void* stream) {
  const int blocks = (c + FIN_THREADS / 32 - 1) / (FIN_THREADS / 32);
  grad_finalize_kernel<<<blocks, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), chunks, c, static_cast<const float*>(stats),
      static_cast<const float*>(gamma), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Pass 3.  grad 0: y (type yt) from x, stats, gamma and beta; grad 1: dx
// (x's type) from x, g (type yt), stats, gamma and the [dmean, dmean2] in
// `beta_or_dm`, inv_n = 1 / (this rank's N*H*W).
extern "C" int bn_train_elementwise(int grad, int xt, int yt, int vec, int nhwc, const void* x,
                                    const void* g, void* out, const void* stats,
                                    const void* gamma, const void* beta_or_dm, double inv_n,
                                    int n, int c, long long hw, int grid, void* stream) {
  const Shape s{n, c, hw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BN_EW(TX, TY, V) \
  launch_elementwise<TX, TY, V>(grad, nhwc, x, g, out, stats, gamma, beta_or_dm, inv_n, s, grid, st)
  switch (route_of(xt, yt)) {
    case 0:
      return vec ? BN_EW(float, bf16, 4) : BN_EW(float, bf16, 1);
    case 1:
      return vec ? BN_EW(bf16, bf16, 8) : BN_EW(bf16, bf16, 1);
    case 2:
      return vec ? BN_EW(float, float, 4) : BN_EW(float, float, 1);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BN_EW
}
