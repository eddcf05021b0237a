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
// Bound on the H100, three terms. At the sweep's size (M = 4.8 M rows, F = 1,
// T = 20) the chain reads y0_hat and gx and writes y_0 once (~58 MB: ~0.02 ms
// at 3.35 TB/s), does 20 trunk passes (~6.4e12 FLOP: ~6.4 ms at the
// 989 TFLOP/s bf16 tensor-core peak, ~95 ms at the 67 TFLOP/s float32
// CUDA-core peak) and 20 x 4.8 M x 1,036 special-function results (513
// softplus of one exp and one log each, three rsqrt, and seven for the noise
// draw and the posterior's roots and reciprocal: ~23.8 ms at 16 results a
// clock on each of 132 SMs at 1.98 GHz). So the bf16 arm is bound by special
// functions, the float32 arm by operations. act_dtype = bfloat16 (either
// matmul type, as the TPU kernel allows) runs the gate band in bf16 with the
// same special functions: the same bound.
//
// Design. Nothing but y0_hat, gx and y_0 touches device memory, in either arm.
//  * bfloat16 matmuls: chain_resident_mma_kernel on the tensor-core trunk of
//    trunk_mma.cuh. A warpgroup owns a tile of 64 rows for all T steps; a
//    block is three warpgroups (168 registers a thread: with four, at 128,
//    ptxas spills a few words for every F) that share the staged W2/W3 (in
//    the order wgmma reads) and walk tiles of their own, so one warpgroup's
//    softplus band runs under another's products. The chain state never
//    leaves registers: the heads leave eps and sigma of feature f of a quad's
//    two rows (g and g + 8 of the warp's 16) on lane f, and the quad's lanes
//    share out its 2F (row, feature) pairs (struct Own: one pair a lane for
//    F <= 2, so the divergent update runs once a warp). The owner keeps y,
//    y0_hat and gx of its pair, solves the quadratic, takes the posterior
//    mean and draws the noise. The next step's first layer (K = 3F) is
//    redone from [y, y0_hat, gx] every step, as FMAs straight into the
//    accumulator layout, with the 3F values handed round the quad by shuffle:
//    the hoisted y0_hat/gx partial would be 64 more live registers beside 64
//    accumulators and 32 packed A registers. It sums in the hoisted form's
//    order, y . W1[:F] + (y0_hat . W1[F:2F] + gx . W1[2F:]), on the same
//    bf16-rounded operands. No activation and no chain state goes through
//    shared memory.
//  * Every step's gates are laid out once on the host as (gamma, gamma * bias)
//    pairs, [T, 3, 64] float4 in device memory (with ACT: bf16 (gamma, bias)
//    pairs, [T, 3, 64] uint2, since the add and the multiply round apart; T
//    may be 1,024, and a block's warpgroups are at different steps). Each warpgroup copies its step's
//    3 KB through the read-only cache into one of its two shared-memory
//    slots, under the first layer, and pays one 128-thread barrier a step;
//    the gate bands then read shared memory as in K1. Read straight from
//    device memory inside the bands, the 16-byte loads were hoisted by ptxas
//    and spilled ~100 words a thread.
//  * float32 matmuls (the parity arm): chain_resident_kernel on the float32
//    CUDA cores, the trunk of denoiser_trunk.cuh (one thread per hidden unit,
//    32 rows per group of 128 threads, state published through shared memory
//    with a group barrier a step, the y0_hat/gx partial kept in registers).
//    With ACT its bands round to bf16 and the float32 products read the bf16
//    activations.
// The seven schedule rows sit in __constant__ memory (a warp-uniform read per
// step). Noise is Philox4x32-10 keyed by (seed, global row, step, feature
// pair) with a Box-Muller transform, drawn by the lane or thread that owns the
// (row, feature): the stream is the same in both arms and at any launch
// shape. Ragged last tiles are masked, not padded; masked rows carry gx = 1.
#include "denoiser_trunk.cuh"
#include "philox.cuh"
#include "trunk_mma.cuh"

namespace upgdm {

constexpr int MAX_T = 1024;
// rows: alphas, betas_tilde, betas_bar, betas_tilde_m_1, betas_bar_m_1,
// alphas_cumprod_prev, one_minus_alphas_bar_sqrt (each [T])
__constant__ float c_tab[7 * MAX_T];

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

// One reverse step for one (row, feature): y_t -> y_{t-1} from the trunk's
// eps and sigma (nsdiff_utils.py:80-92, 271-284); at t = 0 the deterministic
// reparameterisation (p_sample_t_1to0).
__device__ __forceinline__ float chain_update(const Coeffs& c, int t, float y, float y0,
                                              float gx, float eps, float sig, bool gx_direct,
                                              bool noise, unsigned long long seed,
                                              long long row, int f) {
  const float sqrt_abar = sqrtf(1.0f - c.om * c.om);
  float s_y0;
  const float nstd = noise_std(c, gx, sig, gx_direct, &s_y0);
  const float y0_reparam = (y - (1.0f - sqrt_abar) * y0 - eps * nstd) / sqrt_abar;
  if (t == 0) return y0_reparam;
  const float oma = 1.0f - c.a;
  const float s1 = oma * oma * gx + c.a * oma * s_y0;
  const float s2 = (c.bb_m1 - c.bt_m1) * gx + c.bt_m1 * s_y0;
  const float denom = c.a * s2 + s1;
  const float sqrt_a = sqrtf(c.a);
  const float sqrt_abar_prev = sqrtf(c.acp_prev);
  const float g0 = sqrt_abar_prev * s1 / denom;
  const float g1 = sqrt_a * s2 / denom;
  const float g2 = ((sqrt_a * (c.a - 1.0f)) * s2 + (1.0f - sqrt_abar_prev) * s1) / denom;
  float next = g0 * y0_reparam + g1 * y + g2 * y0;
  if (noise) next += sqrtf(sig) * philox_normal(seed, row, t, f);
  return next;
}

// ---- float32 arm: CUDA cores -----------------------------------------------------

template <typename WT, bool ACT>
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
      norm_band<WT, ACT>(acc, __ldg(E1 + t * HID + j), bb1, s, group, j, true);
      trunk_tail<WT, ACT>(acc, W2s, W3s, __ldg(E2 + t * HID + j), bb2,
                          __ldg(E3 + t * HID + j), bb3, s, group, j);
      float eps = 0.0f, sig = 0.0f;
      heads<WT>(acc, W4s, Wss, b4, bs, F, s, group, j, &eps, &sig);
      if (owner) {
        y = chain_update(coeffs(t, T), t, y, y0, gx, eps, sig, gx_direct != 0, noise != 0, seed,
                         row, f);
        if (t > 0) ys[j] = rnd<WT>(y);
      }
      group_sync(group);  // next step's state published
    }
    if (live) out[row * F + f] = y;
  }
}

// The [7, T] schedule table into constant memory, in stream order.
static int upload_schedule(const float* tab, int T, cudaStream_t stream) {
  return (int)cudaMemcpyToSymbolAsync(c_tab, tab, sizeof(float) * 7 * T, 0,
                                      cudaMemcpyDeviceToDevice, stream);
}

template <bool ACT>
static int launch_float32(const float* y0h, const float* gx, long long M, int F, int T,
                          unsigned long long seed, int noise, int gx_direct, const float* E1,
                          const float* E2, const float* E3, const float* W1, const float* b1,
                          const float* W2, const float* b2, const float* W3, const float* b3,
                          const float* W4, const float* b4, const float* Ws, const float* bs,
                          float* out, cudaStream_t stream) {
  size_t smem = 0;
  const int G = pick_groups<float>(F, &smem);
  if (G == 0) return (int)cudaErrorInvalidConfiguration;
  auto kernel = chain_resident_kernel<float, ACT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = G * HID;
  const long long tiles = (M + (long long)G * R - 1) / ((long long)G * R);
  const int grid = persistent_grid(kernel, threads, smem, tiles);
  kernel<<<grid, threads, smem, stream>>>(y0h, gx, M, F, T, seed, noise, gx_direct, E1, E2, E3,
                                          W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs, out);
  return (int)cudaGetLastError();
}

// ---- bfloat16 arm: tensor-core trunk, chain state in registers --------------------

// Warpgroups a block, sized from the ptxas -v report: with four (128 registers
// a thread) every F spills a few words, with three (168) none does.
constexpr int CHAIN_WGS = mma::MAX_WGS - 1;

// Who owns the chain state inside a quad, the four lanes that hold rows g
// (slot 0) and g + 8 (slot 1) of the fragment. The heads leave feature f of
// both rows on lane f. For F <= 2 the quad's 2F (row, feature) pairs go one to
// a lane, lane q owning slot q / F, feature q % F, so that the divergent update
// runs once a warp and not twice; for F > 2 lane q owns feature q of both rows.
template <int F>
struct Own {
  static constexpr int PAIRS = F <= 2 ? 1 : 2;     // pairs a lane
  static constexpr int LANES = F <= 2 ? 2 * F : F;  // lanes of a quad that own any
  __device__ static int slot(int q, int p) { return F <= 2 ? q / F : p; }
  __device__ static int feature(int q) { return F <= 2 ? q % F : q; }
  // the lane that owns (slot s, feature i), and which of its pairs that is
  __device__ static int lane(int s, int i) { return F <= 2 ? s * F + i : i; }
  __device__ static int pair(int s) { return F <= 2 ? 0 : s; }
};

// Layer 1 of one step: acc = bf16(y) . W1[:F] + (bf16(y0_hat) . W1[F:2F] +
// bf16(gx) . W1[2F:]) in the accumulator layout. Every lane needs all F
// features of its two rows, so they go round the quad by shuffle from their
// owners. w1: [3F, 128] float32 (bf16 values).
template <int F>
__device__ __forceinline__ void chain_first_product(float (&acc)[mma::ACC],
                                                    const float (&y)[Own<F>::PAIRS],
                                                    const float (&y0)[Own<F>::PAIRS],
                                                    const float (&gx)[Own<F>::PAIRS],
                                                    const float* w1, int q) {
  using O = Own<F>;
  float yb[2][F], y0b[2][F], gxb[2][F];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      yb[s][i] = __shfl_sync(0xffffffffu, rnd_bf16(y[O::pair(s)]), O::lane(s, i), 4);
      y0b[s][i] = __shfl_sync(0xffffffffu, rnd_bf16(y0[O::pair(s)]), O::lane(s, i), 4);
      gxb[s][i] = __shfl_sync(0xffffffffu, rnd_bf16(gx[O::pair(s)]), O::lane(s, i), 4);
    }
  }
  const float2* w = reinterpret_cast<const float2*>(w1);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // products of two bf16 values are exact in float32, so each FMA is one
    // rounded add of the running sum, as a float32 dot product's
    float a[4], p[4], g[4];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const float2 cy = w[i * 64 + 4 * j + q];
      const float2 c0 = w[(F + i) * 64 + 4 * j + q];
      const float2 cg = w[(2 * F + i) * 64 + 4 * j + q];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        a[2 * s] = i ? fmaf(yb[s][i], cy.x, a[2 * s]) : yb[s][i] * cy.x;
        a[2 * s + 1] = i ? fmaf(yb[s][i], cy.y, a[2 * s + 1]) : yb[s][i] * cy.y;
        p[2 * s] = i ? fmaf(y0b[s][i], c0.x, p[2 * s]) : y0b[s][i] * c0.x;
        p[2 * s + 1] = i ? fmaf(y0b[s][i], c0.y, p[2 * s + 1]) : y0b[s][i] * c0.y;
        g[2 * s] = i ? fmaf(gxb[s][i], cg.x, g[2 * s]) : gxb[s][i] * cg.x;
        g[2 * s + 1] = i ? fmaf(gxb[s][i], cg.y, g[2 * s + 1]) : gxb[s][i] * cg.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = a[e] + (p[e] + g[e]);
  }
}

// Shared memory of the tensor-core arm: the trunk's plan, then two slots of one
// step's gates (3 x 64 float4, or with ACT 3 x 64 uint2 in the first half) for
// each warpgroup.
constexpr int GATE_SLOT = 3 * 64;  // float4 a step
template <int F>
struct ChainSmem {
  using Trunk = mma::Smem<3 * F, 2 * F>;
  static constexpr int gates = Trunk::bytes;
  static constexpr int total = Trunk::total + 2 * CHAIN_WGS * GATE_SLOT * 16;
};

template <int F, bool ACT>
__global__ void __launch_bounds__(128 * CHAIN_WGS, 1)
chain_resident_mma_kernel(const float* __restrict__ y0h, const float* __restrict__ gxs,
                          long long M, int T, unsigned long long seed, int noise,
                          int gx_direct, const uint4* __restrict__ gates,
                          const __nv_bfloat16* __restrict__ W1, const uint4* __restrict__ W2t,
                          const uint4* __restrict__ W3t, const __nv_bfloat16* __restrict__ W4,
                          const float* __restrict__ b4, const __nv_bfloat16* __restrict__ Ws,
                          const float* __restrict__ bs, float* __restrict__ out) {
  constexpr int IN = 3 * F;
  using S = mma::Smem<IN, 2 * F>;
  using O = Own<F>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mma::align_1024(smem_raw);
  float* w4 = reinterpret_cast<float*>(smem + S::heads);
  float* wsg = w4 + F * mma::HID;
  mma::stage_head<F>(w4, W4);
  mma::stage_head<F>(wsg, Ws);
  mma::stage_matrices<IN, 2 * F>(smem, W1, W2t, W3t);
  mma::staging_done();
  const float* w1 = reinterpret_cast<const float*>(smem + S::w1);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const mma::Walk walk;
  const int q = walk.q;
  const bool own = q < O::LANES;
  const int f = O::feature(q);
  const int tiles = (int)((M + mma::TILE - 1) / mma::TILE);
  // the warpgroup's two gate slots; a step writes the one the last did not read
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 127;
  uint4* slots = reinterpret_cast<uint4*>(smem + ChainSmem<F>::gates) + wg * 2 * GATE_SLOT;
  // a step's gates in 16-byte words: 192 float4, or 96 uint4 of (g, b) bf16 pairs
  constexpr int WORDS = ACT ? GATE_SLOT / 2 : GATE_SLOT;
  int slot = 0;

  float acc[mma::ACC];
  for (int tile = walk.first; tile < tiles; tile += walk.stride) {
    const long long r0 = (long long)tile * mma::TILE + walk.row;
    float y[O::PAIRS], y0[O::PAIRS], gx[O::PAIRS];
#pragma unroll
    for (int p = 0; p < O::PAIRS; ++p) {
      const long long row = r0 + 8 * O::slot(q, p);
      const bool live = own && row < M;
      // gx = 1 on masked rows keeps their (unused) quadratic finite
      y0[p] = live ? __ldg(y0h + row * F + f) : 0.0f;
      gx[p] = live ? __ldg(gxs + row * F + f) : 1.0f;
      y[p] = y0[p];
      if (own && noise) y[p] = sqrtf(gx[p]) * philox_normal(seed, row, T, f) + y0[p];
    }
    for (int t = T - 1; t >= 0; --t) {
      // this step's gates come in under the first layer
      const uint4* src = gates + (size_t)t * WORDS;
      uint4 ga = make_uint4(0, 0, 0, 0), gc = ga;
      if constexpr (ACT) {
        if (lane < WORDS) ga = __ldg(src + lane);
      } else {
        ga = __ldg(src + lane);
        gc = __ldg(src + 128 + (lane & 63));
      }
      chain_first_product<F>(acc, y, y0, gx, w1, q);
      uint4* gb = slots + slot * GATE_SLOT;
      slot ^= 1;
      if (!ACT || lane < WORDS) gb[lane] = ga;
      if (!ACT && lane < 64) gb[128 + lane] = gc;
      group_sync(wg);  // gates visible; every warp is past the last step's reads
      const unsigned char* gl = reinterpret_cast<const unsigned char*>(gb);
      mma::gate_band<true, ACT>(acc, mma::layer_gates<ACT>(gl, 0), q);
      mma::hidden_product(acc, base + S::w2);
      mma::gate_band<true, ACT>(acc, mma::layer_gates<ACT>(gl, 1), q);
      mma::hidden_product(acc, base + S::w3);
      mma::gate_band<true, ACT>(acc, mma::layer_gates<ACT>(gl, 2), q);
      // the heads leave feature i of slots 0 and 1 on lane i
      float eps[2], sig[2];
      mma::head<F>(acc, w4, q, eps[0], eps[1]);
      mma::softplus_band(acc);
      mma::head<F>(acc, wsg, q, sig[0], sig[1]);
      if (F <= 2) {  // to the lane that owns (slot, feature)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          eps[s] = __shfl_sync(0xffffffffu, eps[s], f, 4);
          sig[s] = __shfl_sync(0xffffffffu, sig[s], f, 4);
        }
      }
      if (own) {
        const Coeffs c = coeffs(t, T);
        const float eb = __ldg(b4 + f), sb = __ldg(bs + f);
#pragma unroll
        for (int p = 0; p < O::PAIRS; ++p) {
          const int s = O::slot(q, p);
          y[p] = chain_update(c, t, y[p], y0[p], gx[p], (s ? eps[1] : eps[0]) + eb,
                              softplus((s ? sig[1] : sig[0]) + sb), gx_direct != 0,
                              noise != 0, seed, r0 + 8 * s, f);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < O::PAIRS; ++p) {
      const long long row = r0 + 8 * O::slot(q, p);
      if (own && row < M) out[row * F + f] = y[p];
    }
  }
}

template <int F, bool ACT>
static int launch_mma(const float* y0h, const float* gx, long long M, int T,
                      unsigned long long seed, int noise, int gx_direct, const void* gates,
                      const void* W1, const void* W2t, const void* W3t, const void* W4,
                      const float* b4, const void* Ws, const float* bs, float* out,
                      cudaStream_t stream) {
  auto kernel = chain_resident_mma_kernel<F, ACT>;
  constexpr size_t smem = ChainSmem<F>::total;
  int grid = 0;
  const int err =
      mma::configure(kernel, CHAIN_WGS, smem, (M + mma::TILE - 1) / mma::TILE, &grid);
  if (err != (int)cudaSuccess) return err;
  kernel<<<grid, 128 * CHAIN_WGS, smem, stream>>>(
      y0h, gx, M, T, seed, noise, gx_direct, static_cast<const uint4*>(gates),
      static_cast<const __nv_bfloat16*>(W1), static_cast<const uint4*>(W2t),
      static_cast<const uint4*>(W3t), static_cast<const __nv_bfloat16*>(W4), b4,
      static_cast<const __nv_bfloat16*>(Ws), bs, out);
  return (int)cudaGetLastError();
}

}  // namespace upgdm

// C interface (ctypes). tab is the [7, T] float32 schedule table on the
// device; noise != 0 draws Philox normals, 0 runs the chain noise-free.
// bf16 != 0 selects the tensor-core arm: gates is the [T, 3, 64] float4 table
// of (gamma, gamma * bias) pairs (ops/kernels/chain_resident.py::gate_table;
// with act != 0 the [T, 3, 64] uint2 table of bf16 (gamma, bias) pairs),
// W1 [3F, 128], W4 and Ws [128, F] are bf16, W2 and W3 bf16 in the tiled
// B-operand order of trunk_mma.cuh; E1..E3 and b1..b3 are not read. Otherwise
// E1..E3 are the [T, 128] gate tables, all five matrices are float32
// [in, out] and gates is not read. act != 0 runs the activations in bf16, in
// either arm. Returns cudaGetLastError() after the launch.
extern "C" int upgdm_chain_resident(const float* y0h, const float* gx, long long M, int F,
                                    int T, const float* tab, unsigned long long seed,
                                    int noise, int gx_direct, const float* E1,
                                    const float* E2, const float* E3, const void* gates,
                                    const void* W1, const float* b1, const void* W2,
                                    const float* b2, const void* W3, const float* b3,
                                    const void* W4, const float* b4, const void* Ws,
                                    const float* bs, float* out, int bf16, int act,
                                    void* stream) {
  using namespace upgdm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F < 1 || F > MAX_F || M < 0 || T < 1 || T > MAX_T) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const int err = upload_schedule(tab, T, st);
  if (err != (int)cudaSuccess) return err;
  if (!bf16) {
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    return (act ? launch_float32<true> : launch_float32<false>)(
        y0h, gx, M, F, T, seed, noise, gx_direct, E1, E2, E3, f(W1), b1, f(W2), b2, f(W3), b3,
        f(W4), b4, f(Ws), bs, out, st);
  }
#define UPGDM_CHAIN_MMA(N)                                                                   \
  (act ? launch_mma<N, true> : launch_mma<N, false>)(y0h, gx, M, T, seed, noise, gx_direct,   \
                                                     gates, W1, W2, W3, W4, b4, Ws, bs, out, st)
  switch (F) {
    case 1: return UPGDM_CHAIN_MMA(1);
    case 2: return UPGDM_CHAIN_MMA(2);
    case 3: return UPGDM_CHAIN_MMA(3);
    default: return UPGDM_CHAIN_MMA(4);
  }
#undef UPGDM_CHAIN_MMA
}
