// K2 — the whole NsDiff reverse chain in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel upgdm_tpu/ops/pallas/chain_resident.py::
// fused_chain_rows (body _chain_kernel). For M rows of (y0_hat, gx) it runs
// y_T = sqrt(gx) * z + y0_hat, then for t = T-1 .. 1 the denoiser trunk (as
// K1), sigma_y0 from the per-step quadratic (or gx itself with
// use_gx_directly), the y0 reparameterisation, the gamma_0/1/2 posterior
// mean and + sqrt(sigma_theta) * z, and ends with the deterministic
// reparameterisation at t = 0. Output: y_0 [M, F] float32.
//
// Bound on the H100. At the sweep's size (M = 4.8 M rows, F = 1, T = 20) the
// chain reads y0_hat and gx and writes y_0 once (~58 MB) but does 20 trunk
// passes (~6.3e12 FLOP): compute-bound by two to three orders of magnitude
// (~94 ms at the 67 TFLOP/s float32 CUDA-core peak, ~6.4 ms at the bf16
// tensor-core peak, against ~0.02 ms of memory time).
//
// Design. The trunk is K1's (denoiser_trunk.cuh): W2/W3 resident in shared
// memory of a persistent block, one thread per hidden unit, 32 rows per group
// of 128 threads. Everything the chain carries stays on the chip for all T
// steps: the state y, y0_hat and gx live in the registers of the thread that
// owns each (row, feature); the step-invariant [y0_hat, gx] . W1[F:3F]
// partial product is computed once per tile and kept in registers; the seven
// schedule rows sit in __constant__ memory (a uniform read per step). Noise
// is Philox4x32-10 keyed by (seed, global row, step, feature pair) with a
// Box-Muller transform, so the stream does not depend on the launch shape.
// Ragged last tiles are masked, not padded.
#include "denoiser_trunk.cuh"

namespace upgdm {

constexpr int MAX_T = 1024;
// rows: alphas, betas_tilde, betas_bar, betas_tilde_m_1, betas_bar_m_1,
// alphas_cumprod_prev, one_minus_alphas_bar_sqrt (each [T])
__constant__ float c_tab[7 * MAX_T];

// Philox4x32-10 (Salmon et al., SC'11), counter (c0..c3), key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

// Standard normal for (row, step, feature f) by Box-Muller on Philox bits.
__device__ __forceinline__ float philox_normal(unsigned long long seed, long long row,
                                               int step, int f) {
  const uint4 c = make_uint4((uint32_t)row, (uint32_t)((unsigned long long)row >> 32),
                             (uint32_t)step, (uint32_t)(f >> 1));
  const uint2 k = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  const uint4 b = philox4x32_10(c, k);
  // u1 in (0, 1] so log(u1) is finite; 24 bits is all a float keeps
  const float u1 = ((float)(b.x >> 8) + 1.0f) * (1.0f / 16777216.0f);
  const float u2 = (float)(b.y >> 8) * (1.0f / 16777216.0f);
  const float rad = sqrtf(-2.0f * logf(u1));
  float sn, cs;
  sincospif(2.0f * u2, &sn, &cs);
  return rad * ((f & 1) ? sn : cs);
}

struct Coeffs {
  float a, bt, bb, bt_m1, bb_m1, acp_prev, om;
};

__device__ __forceinline__ Coeffs coeffs(int t, int T) {
  Coeffs c;
  c.a = c_tab[0 * T + t];
  c.bt = c_tab[1 * T + t];
  c.bb = c_tab[2 * T + t];
  c.bt_m1 = c_tab[3 * T + t];
  c.bb_m1 = c_tab[4 * T + t];
  c.acp_prev = c_tab[5 * T + t];
  c.om = c_tab[6 * T + t];
  return c;
}

// Per-step quadratic solve for sigma_Y0 (nsdiff_utils.py:143-146).
__device__ __forceinline__ float sigma_y0_hat(const Coeffs& c, float gx, float sig) {
  const float a = c.a, oma = 1.0f - c.a;
  const float lam0 = a * oma * c.bt_m1;
  const float lam1 = (oma * oma * c.bt_m1 + a * oma * (c.bb_m1 - c.bt_m1)) * gx -
                     sig * (a * c.bt_m1 + a * oma);
  const float lam2 = gx * gx * (oma * oma) * (c.bb_m1 - c.bt_m1) -
                     sig * gx * (a * c.bb_m1 - a * c.bt_m1 + oma * oma);
  const float disc = fmaxf(lam1 * lam1 - 4.0f * lam0 * lam2, 0.0f);
  return (-lam1 + sqrtf(disc)) / (2.0f * lam0);
}

// sqrt(noise_var) and sigma_Y0 for one (row, feature) at step coefficients c.
__device__ __forceinline__ float noise_std(const Coeffs& c, float gx, float sig,
                                           bool gx_direct, float* s_y0) {
  if (gx_direct) {
    *s_y0 = gx;
    return sqrtf(c.bb * gx);
  }
  *s_y0 = sigma_y0_hat(c, gx, sig);
  return sqrtf((c.bb - c.bt) * gx + c.bt * *s_y0);
}

template <typename WT>
__global__ void __launch_bounds__(4 * HID, 1)
chain_resident_kernel(const float* __restrict__ y0h, const float* __restrict__ gxs,
                      long long M, int F, int T, unsigned long long seed, int noise,
                      int gx_direct, const float* __restrict__ E1,
                      const float* __restrict__ E2, const float* __restrict__ E3,
                      const WT* __restrict__ W1, const float* __restrict__ b1,
                      const WT* __restrict__ W2, const float* __restrict__ b2,
                      const WT* __restrict__ W3, const float* __restrict__ b3,
                      const WT* __restrict__ W4, const float* __restrict__ b4,
                      const WT* __restrict__ Ws, const float* __restrict__ bs,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / HID;
  const SmemPlan<WT> plan(F, G);
  stage_weights<WT>(smem, plan, F, W1, W2, W3, W4, Ws);
  const WT* W1s = reinterpret_cast<const WT*>(smem + plan.w1);
  const WT* W2s = reinterpret_cast<const WT*>(smem + plan.w2);
  const WT* W3s = reinterpret_cast<const WT*>(smem + plan.w3);
  const WT* W4s = reinterpret_cast<const WT*>(smem + plan.w4);
  const WT* Wss = reinterpret_cast<const WT*>(smem + plan.ws);

  const int group = threadIdx.x / HID;
  const int j = threadIdx.x % HID;
  const GroupSmem s = group_smem<WT>(smem, plan, group);
  const float bb1 = b1[j], bb2 = b2[j], bb3 = b3[j];
  const long long rows_per_block = (long long)G * R;
  const long long tiles = (M + rows_per_block - 1) / rows_per_block;
  // io holds [R, F] of the (bf16-rounded) state, then [R, F] y0_hat, [R, F] gx
  float* ys = s.io;
  float* y0s = s.io + R * F;
  float* gxsm = s.io + 2 * R * F;
  const bool owner = j < R * F;

  float acc[R], base1[R];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * rows_per_block + (long long)group * R;
    const long long row = row0 + j / F;  // owner's row
    const int f = j % F;                 // owner's feature
    const bool live = owner && row < M;
    // gx = 1 on masked rows keeps their (unused) quadratic finite
    const float y0 = live ? y0h[row * F + f] : 0.0f;
    const float gx = live ? gxs[row * F + f] : 1.0f;
    float y = y0;
    if (owner) {
      if (noise) y = sqrtf(gx) * philox_normal(seed, row, T, f) + y0;
      ys[j] = rnd<WT>(y);
      y0s[j] = rnd<WT>(y0);
      gxsm[j] = rnd<WT>(gx);
    }
    group_sync(group);
    // step-invariant first-layer partial: [y0_hat, gx] . W1[F:3F]
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float p = 0.0f, q = 0.0f;
      for (int i = 0; i < F; ++i) {
        p = fmaf(y0s[r * F + i], to_f(W1s[(F + i) * HID + j]), p);
        q = fmaf(gxsm[r * F + i], to_f(W1s[(2 * F + i) * HID + j]), q);
      }
      base1[r] = p + q;
    }

    for (int t = T - 1; t >= 0; --t) {
      // trunk at step t (ys was published by the owners before the barrier)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = 0.0f;
        for (int i = 0; i < F; ++i) a = fmaf(ys[r * F + i], to_f(W1s[i * HID + j]), a);
        acc[r] = a + base1[r];
      }
      norm_band<WT>(acc, __ldg(E1 + t * HID + j), bb1, s, group, j, true);
      trunk_tail<WT>(acc, W2s, W3s, __ldg(E2 + t * HID + j), bb2, __ldg(E3 + t * HID + j),
                     bb3, s, group, j);
      float eps = 0.0f, sig = 0.0f;
      heads<WT>(acc, W4s, Wss, b4, bs, F, s, group, j, &eps, &sig);
      if (owner) {
        const Coeffs c = coeffs(t, T);
        const float sqrt_abar = sqrtf(1.0f - c.om * c.om);
        float s_y0;
        const float nstd = noise_std(c, gx, sig, gx_direct != 0, &s_y0);
        const float y0_reparam = (y - (1.0f - sqrt_abar) * y0 - eps * nstd) / sqrt_abar;
        if (t == 0) {
          y = y0_reparam;  // deterministic last step (p_sample_t_1to0)
        } else {
          const float oma = 1.0f - c.a;
          const float s1 = oma * oma * gx + c.a * oma * s_y0;
          const float s2 = (c.bb_m1 - c.bt_m1) * gx + c.bt_m1 * s_y0;
          const float denom = c.a * s2 + s1;
          const float sqrt_a = sqrtf(c.a);
          const float sqrt_abar_prev = sqrtf(c.acp_prev);
          const float g0 = sqrt_abar_prev * s1 / denom;
          const float g1 = sqrt_a * s2 / denom;
          const float g2 = ((sqrt_a * (c.a - 1.0f)) * s2 + (1.0f - sqrt_abar_prev) * s1) / denom;
          y = g0 * y0_reparam + g1 * y + g2 * y0;
          if (noise) y += sqrtf(sig) * philox_normal(seed, row, t, f);
          ys[j] = rnd<WT>(y);
        }
      }
      group_sync(group);  // next step's state published
    }
    if (live) out[row * F + f] = y;
  }
}

template <typename WT>
static int launch(const float* y0h, const float* gx, long long M, int F, int T,
                  const float* tab, unsigned long long seed, int noise, int gx_direct,
                  const float* E1, const float* E2, const float* E3, const void* W1,
                  const float* b1, const void* W2, const float* b2, const void* W3,
                  const float* b3, const void* W4, const float* b4, const void* Ws,
                  const float* bs, float* out, cudaStream_t stream) {
  if (F < 1 || F > MAX_F || M < 0 || T < 1 || T > MAX_T) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemcpyToSymbolAsync(c_tab, tab, sizeof(float) * 7 * T, 0,
                                            cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  const int G = pick_groups<WT>(F, &smem);
  if (G == 0) return (int)cudaErrorInvalidConfiguration;
  auto kernel = chain_resident_kernel<WT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = G * HID;
  const long long tiles = (M + (long long)G * R - 1) / ((long long)G * R);
  const int grid = persistent_grid(kernel, threads, smem, tiles);
  kernel<<<grid, threads, smem, stream>>>(
      y0h, gx, M, F, T, seed, noise, gx_direct, E1, E2, E3, static_cast<const WT*>(W1), b1,
      static_cast<const WT*>(W2), b2, static_cast<const WT*>(W3), b3,
      static_cast<const WT*>(W4), b4, static_cast<const WT*>(Ws), bs, out);
  return (int)cudaGetLastError();
}

}  // namespace upgdm

// C interface (ctypes). tab is the [7, T] float32 schedule table on the
// device; noise != 0 draws Philox normals, 0 runs the chain noise-free.
// Returns cudaGetLastError() after the launch.
extern "C" int upgdm_chain_resident(const float* y0h, const float* gx, long long M, int F,
                                    int T, const float* tab, unsigned long long seed,
                                    int noise, int gx_direct, const float* E1,
                                    const float* E2, const float* E3, const void* W1,
                                    const float* b1, const void* W2, const float* b2,
                                    const void* W3, const float* b3, const void* W4,
                                    const float* b4, const void* Ws, const float* bs,
                                    float* out, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return upgdm::launch<__nv_bfloat16>(y0h, gx, M, F, T, tab, seed, noise, gx_direct, E1,
                                        E2, E3, W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs, out,
                                        st);
  return upgdm::launch<float>(y0h, gx, M, F, T, tab, seed, noise, gx_direct, E1, E2, E3, W1,
                              b1, W2, b2, W3, b3, W4, b4, Ws, bs, out, st);
}
