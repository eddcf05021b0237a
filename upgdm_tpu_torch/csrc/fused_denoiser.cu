// K1 — fused NsDiff denoiser step for Hopper (sm_90a).
//
// Replaces the TPU kernel upgdm_tpu/ops/pallas/fused_denoiser.py::
// fused_denoiser_rows (body _kernel). One reverse step of the NsDiff
// conditional MLP over M rows of x = [y_t, y0_hat, gx] ([M, 3F] float32):
// three gated, softplus'd, L2-normalised 128-wide layers, then the eps and
// sigma heads. The timestep gates gamma_t (three [128] rows) are gathered by
// the caller.
//
// Bound on the H100. At the sweep's size (M = 4.8 M rows, F = 1) the step
// moves about 96 MB (x in, eps and sigma out) against about 3.2e11 FLOP
// (two 128x128 layers dominate), so it is compute-bound: ~0.03 ms of memory
// time against ~4.8 ms at the 67 TFLOP/s float32 CUDA-core peak (or ~0.3 ms
// at the 989 TFLOP/s bf16 tensor-core peak).
//
// Design. Nothing but x, eps and sigma touches device memory: a persistent
// block keeps W2 and W3 in shared memory for its whole life and walks row
// tiles of 32 rows per group of 128 threads; each thread owns one hidden unit
// and keeps the tile's activations in registers (32 independent FMA chains),
// reading the layer's input rows as shared-memory broadcasts. This first
// version runs the products on the float32 CUDA cores, also for the bf16
// arm (whose operands are rounded to bf16 exactly as the TPU kernel rounds
// them); moving the two 128x128 products onto the tensor cores (wgmma) is
// the next step toward the bound. Ragged last tiles are masked, not padded.
#include "denoiser_trunk.cuh"

namespace upgdm {

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
    norm_band<WT>(acc, gam1, bb1, s, group, j, true);
    trunk_tail<WT>(acc, W2s, W3s, gam2, bb2, gam3, bb3, s, group, j);
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

}  // namespace upgdm

// C interface (ctypes). bf16 != 0 selects bf16 weight matrices (W1..W4, Ws);
// everything else is float32. Returns cudaGetLastError() after the launch.
extern "C" int upgdm_fused_denoiser(const float* x, long long M, int F, const float* g1,
                                    const float* g2, const float* g3, const void* W1,
                                    const float* b1, const void* W2, const float* b2,
                                    const void* W3, const float* b3, const void* W4,
                                    const float* b4, const void* Ws, const float* bs,
                                    float* eps, float* sigma, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return upgdm::launch<__nv_bfloat16>(x, M, F, g1, g2, g3, W1, b1, W2, b2, W3, b3, W4,
                                        b4, Ws, bs, eps, sigma, st);
  return upgdm::launch<float>(x, M, F, g1, g2, g3, W1, b1, W2, b2, W3, b3, W4, b4, Ws, bs,
                              eps, sigma, st);
}

extern "C" const char* upgdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
