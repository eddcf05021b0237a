// K4 — one Euler–Maruyama segment of one SDE trajectory in one launch, for
// Hopper (sm_90a).
//
// Replaces upgdm_tpu/data/sde.py::_segment_scan, the JAX package's compiled
// lax.scan over a segment (no Pallas site: it is XLA's scan). From y0 [D] and
// the control values eps [n] it runs n steps of
//     y <- (y + drift(y, eps[k]) * dt) + (sigma * sqrt(dt)) * dw_k
// and returns y_end [D] and every save_every-th state, ys [n / save_every, D]
// (local steps save_every - 1, 2 save_every - 1, ...: the JAX package's
// per-segment decimation). The drift is one of the four systems of
// data/sde.py (biomass, SIS, neuronal: D nodes on a dense adjacency; SLBP:
// the two states (X, Y)), with the parameters it is given. The noise is
// additive (dw a standard normal per feature) or a scale mixture (dw = z1 * z2,
// two independent standard normals per node: the product-normal increments
// of the networked reference generators).
//
// What bounds it. The steps are a serial chain on a tiny state: the bytes
// (eps read once, the saved states written once) and the operations (a D x D
// product a step) would take microseconds for a whole segment of 10^6 steps
// on this card, but every step waits on the one before it. The time is the
// latency of one step times the number of steps.
//
// Design: keep everything off the chain that can be.
//  * One block a trajectory, the state in shared memory (networks: one
//    thread a node, a thread looping over nodes where D > 1,024; the state
//    double-buffered, one barrier a step) or in registers (SLBP: one thread
//    holds (X, Y)).
//  * The noise, which does not depend on the state, is drawn ahead: the
//    segment runs in chunks of up to 1,024 steps; all the block's threads
//    first fill a shared-memory table with the chunk's increments (Philox,
//    Box-Muller in float64) and its control values, then the chain runs over
//    the chunk reading them. The chain's step is then the drift and the update
//    only, with no transcendental but the neuronal sigmoid's exp.
//  * The adjacency, transposed so that the threads of a warp read
//    consecutive words, sits in shared memory where D^2 floats fit beside the
//    rest (D up to ~230) and is read through L2 otherwise. The node's value in
//    the product (the clipped state for biomass, the sigmoid for neuronal) is
//    stored beside the state when the state is written, so the product reads
//    it ready.
//
// Arithmetic. float32, the drift and the update rounded op by op in the JAX
// source's order (__fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from
// contracting them into FMAs), as the plain twin computes them
// (ops/kernels/sde_scan.py::sde_scan_reference). The twin's and the kernel's
// normals agree but for a float64 last bit on a float32 rounding boundary
// (philox.cuh::box_muller_f64). What remains apart: the order of the
// product's sum (here j = 0..D-1 by FMA, in the twin a BLAS matrix-vector
// product) and expf in the neuronal sigmoid; SLBP has neither.
//
// Noise stream. Counter (node i, stream, global step, 0) for the scale
// mixture (z1, z2 the cosine and sine halves of one pair), (0, stream, global
// step, f / 2) for additive feature f (cosine for even f, sine for odd f);
// key: the seed. A draw depends on (seed, stream, global step, node) only, so
// a trajectory is the same for any segmentation and launch shape.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "philox.cuh"

namespace upgdm {
namespace sde {

constexpr int BIOMASS = 0, SIS = 1, NEURONAL = 2, SLBP = 3;
constexpr int MAX_CONSTS = 16;
constexpr int MAX_CHUNK = 1024;
constexpr int MIN_CHUNK = 8;
constexpr int SMEM_LIMIT = 232448;  // bytes a block may opt in to on the H100
constexpr int SLBP_THREADS = 128;

struct Consts {
  float c[MAX_CONSTS];
};

// Noise increment dw of node or feature i at global step g.
template <bool MIX>
__device__ __forceinline__ float increment(unsigned long long seed, uint32_t stream,
                                           uint32_t g, int i) {
  if (MIX) {
    const float2 z = box_muller_f64(
        philox4x32_10(make_uint4((uint32_t)i, stream, g, 0u), philox_key(seed)));
    return __fmul_rn(z.x, z.y);
  }
  const float2 z = box_muller_f64(
      philox4x32_10(make_uint4(0u, stream, g, (uint32_t)(i >> 1)), philox_key(seed)));
  return (i & 1) ? z.y : z.x;
}

__device__ __forceinline__ float update(float y, float f, float dt, float scale, float dw) {
  return __fadd_rn(__fadd_rn(y, __fmul_rn(f, dt)), __fmul_rn(scale, dw));
}

// What node i contributes to the product A v: biomass the clipped state
// (clip(y, 0) keeps a NaN, as torch.clamp and jnp.clip do), SIS the state,
// neuronal sigmoid(tau (y - mu)).
template <int SYS>
__device__ __forceinline__ float product_value(float y, const Consts& p) {
  if (SYS == BIOMASS) return (y < 0.0f) ? 0.0f : y;
  if (SYS == NEURONAL) {
    const float x = __fmul_rn(p.c[0], __fsub_rn(y, p.c[1]));
    return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
  }
  return y;
}

// Drift of node i from its state y, the control e, its row of the product
// agg = [A v]_i and its degree.
//   biomass c = (r, k, d): r y (1 - y / k) + (-e y^2) / (y^2 + 1) + d (agg - deg y)
//   SIS     c = (d):       (-d) y + e (1 - y) agg
//   neuronal c = (tau, mu): -y + (1 - e) agg
template <int SYS>
__device__ __forceinline__ float node_drift(float y, float e, float agg, float deg,
                                            const Consts& p) {
  if (SYS == BIOMASS) {
    const float yc = (y < 0.0f) ? 0.0f : y;
    const float y2 = __fmul_rn(yc, yc);
    const float logistic =
        __fmul_rn(__fmul_rn(p.c[0], yc), __fsub_rn(1.0f, __fdiv_rn(yc, p.c[1])));
    const float harvest = __fdiv_rn(__fmul_rn(-e, y2), __fadd_rn(y2, 1.0f));
    const float diffusion = __fmul_rn(p.c[2], __fsub_rn(agg, __fmul_rn(deg, yc)));
    return __fadd_rn(__fadd_rn(logistic, harvest), diffusion);
  }
  if (SYS == SIS)
    return __fadd_rn(__fmul_rn(-p.c[0], y), __fmul_rn(__fmul_rn(e, __fsub_rn(1.0f, y)), agg));
  return __fadd_rn(-y, __fmul_rn(__fsub_rn(1.0f, e), agg));
}

// The SLBP drift, c = (i_b, i_p, r, H1, H2, K H3^2, H3^2, H4^2, c_b, c_p,
// p_r, c_e p_r, m_p) (products of parameters rounded once from float64).
__device__ __forceinline__ float2 slbp_drift(float X, float Y, float n, const Consts& p) {
  const float X2 = __fmul_rn(X, X);
  const float V = __fdiv_rn(p.c[5], __fadd_rn(X2, p.c[6]));
  const float FR = __fdiv_rn(X2, __fadd_rn(X2, p.c[7]));
  const float growth = __fmul_rn(__fmul_rn(p.c[2], X), __fdiv_rn(n, __fadd_rn(n, p.c[3])));
  const float dX = __fsub_rn(__fsub_rn(__fadd_rn(p.c[0], growth), __fmul_rn(p.c[8], X2)),
                             __fmul_rn(__fmul_rn(p.c[10], FR), Y));
  const float pred =
      __fmul_rn(__fmul_rn(__fmul_rn(p.c[11], FR), Y), __fdiv_rn(V, __fadd_rn(V, p.c[4])));
  const float dY = __fsub_rn(__fsub_rn(__fadd_rn(p.c[1], pred), __fmul_rn(p.c[12], Y)),
                             __fmul_rn(p.c[9], __fmul_rn(Y, Y)));
  return make_float2(dX, dY);
}

struct Args {
  const float *y0, *eps, *sigma, *adjT, *deg;
  float *y_end, *ys;
  long long n_steps, step0;
  int D, save_every, chunk, adj_in_smem;
  float dt, sqrt_dt;
  unsigned long long seed;
  uint32_t stream;
};

// Fill the chunk's increments [ch, D] and control values [ch] (all threads).
template <bool MIX>
__device__ __forceinline__ void fill_chunk(const Args& a, long long c0, int ch, float* noise,
                                           float* epsb) {
  const int D = a.D;
  for (int e = threadIdx.x; e < ch * D; e += blockDim.x) {
    const int s = e / D;
    noise[e] = increment<MIX>(a.seed, a.stream, (uint32_t)(a.step0 + c0 + s), e - s * D);
  }
  for (int s = threadIdx.x; s < ch; s += blockDim.x) epsb[s] = a.eps[c0 + s];
}

// Networked systems: one block, thread i owns nodes i, i + blockDim, ...
// Shared memory (floats): y[2][D], v[2][D], eps[chunk], noise[chunk][D],
// then adjT[D][D] when it fits.
template <int SYS, bool MIX>
__global__ void sde_network_kernel(Args a, Consts p) {
  extern __shared__ float smem[];
  const int D = a.D;
  float* y = smem;
  float* v = y + 2 * D;
  float* epsb = v + 2 * D;
  float* noise = epsb + a.chunk;
  const float* A = a.adjT;
  if (a.adj_in_smem) {
    float* sA = noise + (size_t)a.chunk * D;
    for (int e = threadIdx.x; e < D * D; e += blockDim.x) sA[e] = a.adjT[e];
    A = sA;
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    y[i] = a.y0[i];
    v[i] = product_value<SYS>(a.y0[i], p);
  }
  __syncthreads();
  int cur = 0;
  for (long long c0 = 0; c0 < a.n_steps; c0 += a.chunk) {
    const int ch = (int)min((long long)a.chunk, a.n_steps - c0);
    fill_chunk<MIX>(a, c0, ch, noise, epsb);
    __syncthreads();
    for (int s = 0; s < ch; ++s) {
      const float* yc = y + cur * D;
      const float* vc = v + cur * D;
      float* yn = y + (cur ^ 1) * D;
      float* vn = v + (cur ^ 1) * D;
      const float e = epsb[s];
      const long long j = c0 + s + 1;  // local steps done after this one
      const bool save = (j % a.save_every) == 0;
      for (int i = threadIdx.x; i < D; i += blockDim.x) {
        float agg = 0.0f;
        for (int k = 0; k < D; ++k) agg = fmaf(A[(size_t)k * D + i], vc[k], agg);
        const float yi = yc[i];
        const float f = node_drift<SYS>(yi, e, agg, SYS == BIOMASS ? a.deg[i] : 0.0f, p);
        const float scale = __fmul_rn(a.sigma[i], a.sqrt_dt);
        const float out = update(yi, f, a.dt, scale, noise[s * D + i]);
        yn[i] = out;
        vn[i] = product_value<SYS>(out, p);
        if (save) a.ys[(size_t)(j / a.save_every - 1) * D + i] = out;
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) a.y_end[i] = y[cur * D + i];
}

// SLBP: thread 0 runs the chain on (X, Y) in registers; the block draws the
// noise. Shared memory (floats): eps[chunk], noise[chunk][2].
template <bool MIX>
__global__ void sde_slbp_kernel(Args a, Consts p) {
  extern __shared__ float smem[];
  float* epsb = smem;
  float* noise = epsb + a.chunk;
  float X = a.y0[0], Y = a.y0[1];
  const float sx = __fmul_rn(a.sigma[0], a.sqrt_dt), sy = __fmul_rn(a.sigma[1], a.sqrt_dt);
  for (long long c0 = 0; c0 < a.n_steps; c0 += a.chunk) {
    const int ch = (int)min((long long)a.chunk, a.n_steps - c0);
    fill_chunk<MIX>(a, c0, ch, noise, epsb);
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int s = 0; s < ch; ++s) {
        const float2 f = slbp_drift(X, Y, epsb[s], p);
        const float Xn = update(X, f.x, a.dt, sx, noise[2 * s]);
        Y = update(Y, f.y, a.dt, sy, noise[2 * s + 1]);
        X = Xn;
        const long long j = c0 + s + 1;
        if (j % a.save_every == 0) {
          float* row = a.ys + (size_t)(j / a.save_every - 1) * 2;
          row[0] = X;
          row[1] = Y;
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.y_end[0] = X;
    a.y_end[1] = Y;
  }
}

template <typename K>
int launch(K kernel, int threads, size_t smem, const Args& a, const Consts& p,
           cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, threads, smem, st>>>(a, p);
  return (int)cudaGetLastError();
}

template <int SYS>
int launch_network(Args a, const Consts& p, bool mix, cudaStream_t st) {
  const long long D = a.D;
  const long long fixed = 4 * D, per_step = D + 1;
  const long long limit = SMEM_LIMIT / 4;
  a.adj_in_smem = fixed + D * D + MIN_CHUNK * per_step <= limit;
  const long long avail = limit - fixed - (a.adj_in_smem ? D * D : 0);
  const long long chunk = std::min(avail / per_step, (long long)MAX_CHUNK);
  if (chunk < 1) return (int)cudaErrorInvalidValue;  // D too large for shared memory
  a.chunk = (int)std::max(1LL, std::min(chunk, a.n_steps));
  const size_t smem = 4 * (fixed + a.chunk * per_step + (a.adj_in_smem ? D * D : 0));
  const int threads = (int)std::min(1024LL, std::max(128LL, (D + 31) / 32 * 32));
  return mix ? launch(sde_network_kernel<SYS, true>, threads, smem, a, p, st)
             : launch(sde_network_kernel<SYS, false>, threads, smem, a, p, st);
}

}  // namespace sde
}  // namespace upgdm

// C interface (ctypes). system: 0 biomass, 1 SIS, 2 neuronal, 3 SLBP (D = 2);
// mix != 0 draws scale-mixture increments, else additive. y0, sigma [D],
// eps [n_steps], adjT (the adjacency transposed, [D, D]; networks) and deg
// [D] (biomass) are float32 on the device; consts (n_consts <= 16 floats,
// the drift's constants in the order the drifts above read them) is a host
// array. Writes y_end [D] and ys [n_steps / save_every, D]. stream_id and
// step0 place the segment in the trajectory's Philox stream (step0 + n_steps
// <= 2^32). Returns cudaGetLastError() after the launch.
extern "C" int upgdm_sde_scan(int system, int mix, int D, long long n_steps, int save_every,
                              const float* y0, const float* eps, const float* sigma,
                              const float* adjT, const float* deg, const float* consts,
                              int n_consts, float dt, float sqrt_dt, unsigned long long seed,
                              unsigned int stream_id, long long step0, float* y_end, float* ys,
                              void* stream) {
  using namespace upgdm::sde;
  if (D < 1 || n_steps < 0 || save_every < 1 || n_consts < 0 || n_consts > MAX_CONSTS ||
      system < BIOMASS || system > SLBP || (system == SLBP && D != 2))
    return (int)cudaErrorInvalidValue;
  Consts p = {};
  for (int i = 0; i < n_consts; ++i) p.c[i] = consts[i];
  Args a = {y0, eps, sigma, adjT, deg, y_end, ys, n_steps, step0, D, save_every, 1, 0,
            dt, sqrt_dt, seed, stream_id};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (system) {
    case BIOMASS: return launch_network<BIOMASS>(a, p, mix != 0, st);
    case SIS: return launch_network<SIS>(a, p, mix != 0, st);
    case NEURONAL: return launch_network<NEURONAL>(a, p, mix != 0, st);
    default: {
      a.chunk = (int)std::max(1LL, std::min((long long)MAX_CHUNK, n_steps));
      const size_t smem = 4 * (size_t)a.chunk * 3;
      return mix ? launch(sde_slbp_kernel<true>, SLBP_THREADS, smem, a, p, st)
                 : launch(sde_slbp_kernel<false>, SLBP_THREADS, smem, a, p, st);
    }
  }
}
