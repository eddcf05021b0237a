// The NsDiff reverse chain's posterior update, one launch a step, for Hopper
// (sm_90a).
//
// A port kernel with no Pallas site: the JAX package computes this update as
// XLA-fused jnp between the denoiser's calls (upgdm_tpu/ops/diffusion.py::
// nsdiff_p_sample_loop). Between two K1 launches it takes the chain's state y,
// the chain's prior mean y_T_mean (= y0_hat), g(x), K1's eps_theta and
// sigma_theta and the step's normals z, all float32 of one contiguous shape,
// and writes the next state:
//     sigma_y0   the quadratic solve (or gx itself with use_gx_directly),
//     noise_var  (betas_bar - betas_tilde) gx + betas_tilde sigma_y0,
//     y0_reparam (y - (1 - sqrt(abar)) y_T_mean - eps sqrt(noise_var)) / sqrt(abar),
//     y'         g0 y0_reparam + g1 y + g2 y_T_mean + sqrt(sigma_theta) z.
// The final step (t = 0) has no draw and writes y0_reparam.
//
// What bounds it. Per row it reads six floats and writes one (28 bytes; the
// final step 24, with use_gx_directly 20), ~150 instructions counting each
// IEEE division and root as the sequence it compiles to: at 4.8 M rows
// ~40 us of memory traffic at 3.35 TB/s beside ~20 us of issue. Design: an
// elementwise grid-stride loop, one wave of 256-thread blocks (as many an SM
// as the occupancy calculator says fit; a second wave of eight an SM was
// ~15% slower on the H100), four rows a thread an iteration through 128-bit
// loads and stores where every pointer is 16-byte aligned, the rest (and
// every row of an unaligned call) one at a time.
//
// Arithmetic. float32, rounded op by op in the eager code's order
// (ops/kernels/nsdiff_chain_update.py::nsdiff_chain_update_reference):
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn keep nvcc from
// contracting a product and a sum into an FMA and from approximating a
// division or a root. The per-step scalars (the schedule's terms and their
// products) come from the host's float32 table (chain_table), the values the
// eager code's 0-d tensors hold, by value in the kernel's parameters. The
// clamp of the discriminant keeps torch.clamp's NaN. So the kernel's state
// equals the eager state bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace upgdm {
namespace chain_update {

// The table's columns (ops/kernels/nsdiff_chain_update.py::COLUMNS).
enum Column {
  SQRT_ABAR,             // sqrt(1 - (1 - abar_sqrt)^2)
  SHIFT,                 // 1 - sqrt_abar
  LAM0_2,                // 2 lam0, lam0 = a (1 - a) bt1
  LAM0_4,                // 4 lam0
  LAM1_GX,               // (1 - a)^2 bt1 + a (1 - a) (bb1 - bt1)
  LAM1_SIGMA,            // a bt1 + a (1 - a)
  ONE_M_A_SQ,            // (1 - a)^2
  BB1_M_BT1,             // bb1 - bt1
  LAM2_SIGMA,            // a bb1 - a bt1 + (1 - a)^2
  BB_M_BT,               // bb - bt
  BT,                    // betas_tilde
  BB,                    // betas_bar
  A_ONE_M_A,             // a (1 - a)
  BT1,                   // betas_tilde_m_1
  ALPHA,                 // a
  SQRT_A,                // sqrt(a)
  SQRT_ABAR_PREV,        // sqrt(abar_prev)
  SQRT_A_AM1,            // sqrt(a) (a - 1)
  ONE_M_SQRT_ABAR_PREV,  // 1 - sqrt(abar_prev)
  N_COLUMNS
};

constexpr int THREADS = 256;

struct Coef {
  float c[N_COLUMNS];
};

// One row's next state (or, FINAL, its y0_reparam).
template <bool DIRECT, bool FINAL>
__device__ __forceinline__ float update(const Coef& k, float y, float ytm, float gx, float eps,
                                        float sig, float z) {
  float sy0, nv;
  if (DIRECT) {
    sy0 = gx;
    nv = __fmul_rn(k.c[BB], gx);
  } else {
    const float lam1 = __fsub_rn(__fmul_rn(k.c[LAM1_GX], gx), __fmul_rn(sig, k.c[LAM1_SIGMA]));
    const float lam2 =
        __fsub_rn(__fmul_rn(__fmul_rn(__fmul_rn(gx, gx), k.c[ONE_M_A_SQ]), k.c[BB1_M_BT1]),
                  __fmul_rn(__fmul_rn(sig, gx), k.c[LAM2_SIGMA]));
    float disc = __fsub_rn(__fmul_rn(lam1, lam1), __fmul_rn(k.c[LAM0_4], lam2));
    disc = isnan(disc) ? disc : fmaxf(disc, 0.0f);  // torch.clamp(min=0) keeps a NaN
    sy0 = __fdiv_rn(__fadd_rn(-lam1, __fsqrt_rn(disc)), k.c[LAM0_2]);
    nv = __fadd_rn(__fmul_rn(k.c[BB_M_BT], gx), __fmul_rn(k.c[BT], sy0));
  }
  const float y0r = __fdiv_rn(
      __fsub_rn(__fsub_rn(y, __fmul_rn(k.c[SHIFT], ytm)), __fmul_rn(eps, __fsqrt_rn(nv))),
      k.c[SQRT_ABAR]);
  if (FINAL) return y0r;
  const float s1 = __fadd_rn(__fmul_rn(k.c[ONE_M_A_SQ], gx), __fmul_rn(k.c[A_ONE_M_A], sy0));
  const float s2 = __fadd_rn(__fmul_rn(k.c[BB1_M_BT1], gx), __fmul_rn(k.c[BT1], sy0));
  const float den = __fadd_rn(__fmul_rn(k.c[ALPHA], s2), s1);
  const float g0 = __fdiv_rn(__fmul_rn(k.c[SQRT_ABAR_PREV], s1), den);
  const float g1 = __fdiv_rn(__fmul_rn(k.c[SQRT_A], s2), den);
  const float g2 = __fdiv_rn(
      __fadd_rn(__fmul_rn(k.c[SQRT_A_AM1], s2), __fmul_rn(k.c[ONE_M_SQRT_ABAR_PREV], s1)), den);
  const float mean =
      __fadd_rn(__fadd_rn(__fmul_rn(g0, y0r), __fmul_rn(g1, y)), __fmul_rn(g2, ytm));
  return __fadd_rn(mean, __fmul_rn(__fsqrt_rn(sig), z));
}

// sigma_theta is read unless the final step takes gx for sigma_y0; z is read
// unless this is the final step.
template <bool DIRECT, bool FINAL>
__global__ void __launch_bounds__(THREADS)
    nsdiff_chain_update_kernel(const float* __restrict__ y, const float* __restrict__ ytm,
                               const float* __restrict__ gx, const float* __restrict__ eps,
                               const float* __restrict__ sig, const float* __restrict__ z,
                               float* __restrict__ out, long long n, long long n4, Coef k) {
  constexpr bool READ_SIG = !(DIRECT && FINAL);
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long i = first; i < n4; i += stride) {
    const float4 a = reinterpret_cast<const float4*>(y)[i];
    const float4 b = reinterpret_cast<const float4*>(ytm)[i];
    const float4 g = reinterpret_cast<const float4*>(gx)[i];
    const float4 e = reinterpret_cast<const float4*>(eps)[i];
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), w = s;
    if constexpr (READ_SIG) s = reinterpret_cast<const float4*>(sig)[i];
    if constexpr (!FINAL) w = reinterpret_cast<const float4*>(z)[i];
    float4 r;
    r.x = update<DIRECT, FINAL>(k, a.x, b.x, g.x, e.x, s.x, w.x);
    r.y = update<DIRECT, FINAL>(k, a.y, b.y, g.y, e.y, s.y, w.y);
    r.z = update<DIRECT, FINAL>(k, a.z, b.z, g.z, e.z, s.z, w.z);
    r.w = update<DIRECT, FINAL>(k, a.w, b.w, g.w, e.w, s.w, w.w);
    reinterpret_cast<float4*>(out)[i] = r;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    const float s = READ_SIG ? sig[i] : 0.f;
    const float w = FINAL ? 0.f : z[i];
    out[i] = update<DIRECT, FINAL>(k, y[i], ytm[i], gx[i], eps[i], s, w);
  }
}

template <bool DIRECT, bool FINAL>
int launch(const float* y, const float* ytm, const float* gx, const float* eps,
           const float* sig, const float* z, float* out, long long n, const Coef& k,
           cudaStream_t st) {
  const uintptr_t any = (uintptr_t)y | (uintptr_t)ytm | (uintptr_t)gx | (uintptr_t)eps |
                        (uintptr_t)sig | (uintptr_t)z | (uintptr_t)out;
  const long long n4 = (any % 16 == 0) ? n / 4 : 0;
  static int per_sm = 0;  // blocks an SM holds at once (at 44-60 registers: 4)
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nsdiff_chain_update_kernel<DIRECT, FINAL>, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const long long items = n4 + (n - 4 * n4);
  const long long grid = std::max(
      1LL, std::min((items + THREADS - 1) / THREADS, (long long)sms * std::max(per_sm, 1)));
  nsdiff_chain_update_kernel<DIRECT, FINAL>
      <<<(unsigned)grid, THREADS, 0, st>>>(y, ytm, gx, eps, sig, z, out, n, n4, k);
  return (int)cudaGetLastError();
}

}  // namespace chain_update
}  // namespace upgdm

// C interface (ctypes). n float32 values in each of y, y_T_mean, gx, eps,
// sigma, z and out, on the device (z may be null when final_step != 0); coef is a
// host pointer to the step's n_coef (= 19) table values. direct != 0 takes gx
// for sigma_y0 (use_gx_directly); final_step != 0 writes y0_reparam. Returns
// cudaGetLastError() after the launch.
extern "C" int upgdm_nsdiff_chain_update(long long n, const float* y, const float* y_T_mean,
                                         const float* gx, const float* eps, const float* sigma,
                                         const float* z, const float* coef, int n_coef,
                                         int direct, int final_step, float* out, void* stream) {
  using namespace upgdm::chain_update;
  if (n < 0 || n_coef != N_COLUMNS || (!final_step && z == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Coef k;
  for (int i = 0; i < N_COLUMNS; ++i) k.c[i] = coef[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (direct)
    return final_step ? launch<true, true>(y, y_T_mean, gx, eps, sigma, z, out, n, k, st)
                 : launch<true, false>(y, y_T_mean, gx, eps, sigma, z, out, n, k, st);
  return final_step ? launch<false, true>(y, y_T_mean, gx, eps, sigma, z, out, n, k, st)
               : launch<false, false>(y, y_T_mean, gx, eps, sigma, z, out, n, k, st);
}
