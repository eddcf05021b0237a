// K1 — fused NsDiff denoiser step for Hopper (sm_90a).
//
// Replaces the TPU kernel upgdm_tpu/ops/pallas/fused_denoiser.py::
// fused_denoiser_rows (body _kernel). One reverse step of the NsDiff
// conditional MLP over M rows of x = [y_t, y0_hat, gx] ([M, 3F] float32):
// three gated, softplus'd, L2-normalised 128-wide layers, then the eps and
// sigma heads. The timestep gates gamma_t (three [128] rows) are gathered by
// the caller.
//
// Bound on the H100, three terms. At the sweep's size (M = 4.8 M rows, F = 1)
// the step moves about 96 MB (x in, eps and sigma out: ~0.03 ms at 3.35 TB/s),
// does about 3.2e11 FLOP (the two 128x128 layers dominate: ~0.32 ms at the
// 989 TFLOP/s bf16 tensor-core peak, ~4.8 ms at the 67 TFLOP/s float32
// CUDA-core peak) and 4.8 M x 512 softplus of one exp and one log each
// (~1.2 ms at 16 special-function results a clock on each of 132 SMs at
// 1.98 GHz). So the bf16 arm is bound by special functions, the float32 arm
// by operations.
//
// act_dtype = bfloat16 (it needs bf16 matmuls, as the TPU kernel's wrapper
// says) runs the gate band in bf16 (trunk_mma.cuh, ACT): the same special
// functions a row, so the same bound; the extra roundings are issue slots.
//
// Design. Nothing but x, eps and sigma touches device memory, in either arm.
//  * bfloat16 matmuls (the arm the sweeps use): fused_denoiser_mma_kernel on
//    the tensor-core trunk of trunk_mma.cuh. A block is four warpgroups
//    (three at F = 4) that share the staged weights; each walks tiles of 64
//    rows of its own. W2 and W3 stay in shared memory in the order wgmma
//    reads; activations chain from one product's accumulators into the next
//    product's A operand in registers; each row's sum of squares is 32 local
//    adds and two quad shuffles in float32; the eps head is a dot product
//    over the thread's 32 columns plus the same shuffles, then softplus is
//    taken on the fragment in float32 and the sigma head is the same dot
//    product; lane q of a quad stores feature q. While one warpgroup waits
//    on its products the others run their softplus bands.
//  * float32 matmuls (the parity arm): fused_denoiser_kernel on the float32
//    CUDA cores. A persistent block keeps W2 and W3 in shared memory and
//    walks tiles of 32 rows per group of 128 threads; each thread owns one
//    hidden unit, keeps the tile's activations in registers (32 independent
//    FMA chains) and reads a layer's input rows as shared-memory broadcasts.
// Ragged last tiles are masked, not padded.
#include "denoiser_trunk.cuh"
#include "trunk_mma.cuh"

namespace upgdm {

static_assert(MAX_F <= 4, "a quad of lanes stores one row's F outputs");

// ---- float32 arm: CUDA cores -----------------------------------------------------

template <typename WT>
__global__ void __launch_bounds__(4 * HID, 1)
fused_denoiser_kernel(const float* __restrict__ x, long long M, int F,
                      const float* __restrict__ g1, const float* __restrict__ g2,
                      const float* __restrict__ g3, const WT* __restrict__ W1,
                      const float* __restrict__ b1, const WT* __restrict__ W2,
                      const float* __restrict__ b2, const WT* __restrict__ W3,
                      const float* __restrict__ b3, const WT* __restrict__ W4,
                      const float* __restrict__ b4, const WT* __restrict__ Ws,
                      const float* __restrict__ bs, float* __restrict__ eps_out,
                      float* __restrict__ sigma_out) {
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
  const float gam1 = g1[j], gam2 = g2[j], gam3 = g3[j];
  const float bb1 = b1[j], bb2 = b2[j], bb3 = b3[j];
  const int IN = 3 * F;
  const long long rows_per_block = (long long)G * R;
  const long long tiles = (M + rows_per_block - 1) / rows_per_block;

  float acc[R];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * rows_per_block + (long long)group * R;
    // stage the group's input rows (zeros past M), rounded for the matmul
    for (int i = j; i < R * IN; i += HID) {
      const long long e = row0 * IN + i;
      s.io[i] = (e < M * IN) ? rnd<WT>(x[e]) : 0.0f;
    }
    group_sync(group);
    // layer 1: [R, 3F] . W1[3F, 128]
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a = 0.0f;
      for (int i = 0; i < IN; ++i) a = fmaf(s.io[r * IN + i], to_f(W1s[i * HID + j]), a);
      acc[r] = a;
    }
    norm_band<WT, false>(acc, gam1, bb1, s, group, j, true);
    trunk_tail<WT, false>(acc, W2s, W3s, gam2, bb2, gam3, bb3, s, group, j);
    float e = 0.0f, sg = 0.0f;
    heads<WT>(acc, W4s, Wss, b4, bs, F, s, group, j, &e, &sg);
    if (j < R * F) {
      const long long row = row0 + j / F;
      if (row < M) {
        eps_out[row * F + j % F] = e;
        sigma_out[row * F + j % F] = sg;
      }
    }
  }
}

template <typename WT>
static int launch(const float* x, long long M, int F, const float* g1, const float* g2,
                  const float* g3, const void* W1, const float* b1, const void* W2,
                  const float* b2, const void* W3, const float* b3, const void* W4,
                  const float* b4, const void* Ws, const float* bs, float* eps,
                  float* sigma, cudaStream_t stream) {
  if (F < 1 || F > MAX_F || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  size_t smem = 0;
  const int G = pick_groups<WT>(F, &smem);
  if (G == 0) return (int)cudaErrorInvalidConfiguration;
  auto kernel = fused_denoiser_kernel<WT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = G * HID;
  const long long tiles = (M + (long long)G * R - 1) / ((long long)G * R);
  const int grid = persistent_grid(kernel, threads, smem, tiles);
  kernel<<<grid, threads, smem, stream>>>(
      x, M, F, g1, g2, g3, static_cast<const WT*>(W1), b1, static_cast<const WT*>(W2), b2,
      static_cast<const WT*>(W3), b3, static_cast<const WT*>(W4), b4,
      static_cast<const WT*>(Ws), bs, eps, sigma);
  return (int)cudaGetLastError();
}

// ---- bfloat16 arm: tensor-core trunk ---------------------------------------------

// Warpgroups a block, sized from the ptxas -v report: with four (128 registers
// a thread) F <= 3 builds without spills and F = 4 does not, so F = 4 runs
// three (168 registers); a first float32-emulated bf16-activation band
// spilled 8 bytes at F = 3 with four, so that arm runs three from F = 3.
constexpr int denoiser_wgs(int F, bool act) {
  return F <= (act ? 2 : 3) ? mma::MAX_WGS : mma::MAX_WGS - 1;
}

template <int F, bool ACT>
__global__ void __launch_bounds__(128 * denoiser_wgs(F, ACT), 1)
fused_denoiser_mma_kernel(const float* __restrict__ x, long long M,
                          const float* __restrict__ g1, const float* __restrict__ g2,
                          const float* __restrict__ g3, const __nv_bfloat16* __restrict__ W1,
                          const float* __restrict__ b1, const uint4* __restrict__ W2t,
                          const float* __restrict__ b2, const uint4* __restrict__ W3t,
                          const float* __restrict__ b3, const __nv_bfloat16* __restrict__ W4,
                          const float* __restrict__ b4, const __nv_bfloat16* __restrict__ Ws,
                          const float* __restrict__ bs, float* __restrict__ eps_out,
                          float* __restrict__ sigma_out) {
  constexpr int IN = 3 * F;
  using S = mma::Smem<IN, 2 * F>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mma::align_1024(smem_raw);
  float* w4 = reinterpret_cast<float*>(smem + S::heads);
  float* wsg = w4 + F * mma::HID;
  mma::stage_head<F>(w4, W4);
  mma::stage_head<F>(wsg, Ws);
  mma::stage_trunk<IN, 2 * F, ACT>(smem, W1, W2t, W3t, g1, b1, g2, b2, g3, b3);

  const mma::Walk walk;
  const int q = walk.q;
  const int tiles = (int)((M + mma::TILE - 1) / mma::TILE);

  float acc[mma::ACC];
  for (int tile = walk.first; tile < tiles; tile += walk.stride) {
    const long long r0 = (long long)tile * mma::TILE + walk.row;
    mma::prefetch_rows<IN>(x, M, r0 + (long long)walk.stride * mma::TILE, q);
    mma::trunk<IN, 2 * F, true, ACT>(acc, x, M, r0, smem, q);
    // each head is stored before the next is taken, so only one head's sums
    // are live beside the fragment
    float o0, o1;
    mma::head<F>(acc, w4, q, o0, o1);
    if (q < F) {
      if (r0 < M) eps_out[r0 * F + q] = o0 + b4[q];
      if (r0 + 8 < M) eps_out[(r0 + 8) * F + q] = o1 + b4[q];
    }
    mma::softplus_band(acc);
    mma::head<F>(acc, wsg, q, o0, o1);
    if (q < F) {
      if (r0 < M) sigma_out[r0 * F + q] = softplus(o0 + bs[q]);
      if (r0 + 8 < M) sigma_out[(r0 + 8) * F + q] = softplus(o1 + bs[q]);
    }
  }
}

template <int F, bool ACT>
static int launch_mma(const float* x, long long M, const float* g1, const float* g2,
                      const float* g3, const void* W1, const float* b1, const void* W2t,
                      const float* b2, const void* W3t, const float* b3, const void* W4,
                      const float* b4, const void* Ws, const float* bs, float* eps,
                      float* sigma, cudaStream_t stream) {
  auto kernel = fused_denoiser_mma_kernel<F, ACT>;
  constexpr size_t smem = mma::Smem<3 * F, 2 * F>::total;
  int grid = 0;
  constexpr int wgs = denoiser_wgs(F, ACT);
  const int err = mma::configure(kernel, wgs, smem, (M + mma::TILE - 1) / mma::TILE, &grid);
  if (err != (int)cudaSuccess) return err;
  kernel<<<grid, 128 * wgs, smem, stream>>>(
      x, M, g1, g2, g3, static_cast<const __nv_bfloat16*>(W1), b1,
      static_cast<const uint4*>(W2t), b2, static_cast<const uint4*>(W3t), b3,
      static_cast<const __nv_bfloat16*>(W4), b4, static_cast<const __nv_bfloat16*>(Ws), bs,
      eps, sigma);
  return (int)cudaGetLastError();
}

}  // namespace upgdm

// C interface (ctypes). bf16 != 0 selects the tensor-core arm: W1 [3F, 128],
// W4 and Ws [128, F] are bf16 and W2, W3 are bf16 in the tiled B-operand order
// of trunk_mma.cuh (ops/kernels/fused_denoiser.py::tile_b_operand). Otherwise
// all five matrices are float32 [in, out]. Everything else is float32. act != 0
// runs the activations in bf16 and needs bf16 != 0. Returns cudaGetLastError()
// after the launch.
extern "C" int upgdm_fused_denoiser(const float* x, long long M, int F, const float* g1,
                                    const float* g2, const float* g3, const void* W1,
                                    const float* b1, const void* W2, const float* b2,
                                    const void* W3, const float* b3, const void* W4,
                                    const float* b4, const void* Ws, const float* bs,
                                    float* eps, float* sigma, int bf16, int act,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    if (act) return (int)cudaErrorInvalidValue;
    return upgdm::launch<float>(x, M, F, g1, g2, g3, W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs,
                                eps, sigma, st);
  }
  if (M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
#define UPGDM_DENOISER_MMA(N, A)                                                        \
  upgdm::launch_mma<N, A>(x, M, g1, g2, g3, W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs, eps, \
                          sigma, st)
  switch (F) {
    case 1: return act ? UPGDM_DENOISER_MMA(1, true) : UPGDM_DENOISER_MMA(1, false);
    case 2: return act ? UPGDM_DENOISER_MMA(2, true) : UPGDM_DENOISER_MMA(2, false);
    case 3: return act ? UPGDM_DENOISER_MMA(3, true) : UPGDM_DENOISER_MMA(3, false);
    case 4: return act ? UPGDM_DENOISER_MMA(4, true) : UPGDM_DENOISER_MMA(4, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef UPGDM_DENOISER_MMA
}

extern "C" const char* upgdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
