// K3 — fused TMDM denoiser step for Hopper (sm_90a).
//
// Replaces the TPU kernel upgdm_tpu/ops/pallas/fused_denoiser.py::
// fused_tmdm_rows (body _tmdm_kernel). One reverse step of the TMDM
// conditional MLP over M rows of x = [y_t, y0_hat] ([M, 2F] float32):
//     h = softplus(gamma_i * (h . W_i + b_i))        i = 1, 2, 3
//     eps = h . W4 + b4
// with no normalisation between the layers and a single head. The timestep
// gates gamma_t (three [128] rows) are gathered by the caller.
//
// Bound on the H100. At the TMDM sweep's size (M = 3.6 M rows, F = 1) the
// step moves about 43 MB (x in, eps out) against about 2.4e11 FLOP (the two
// 128x128 layers dominate), so it is bound by operations: ~0.013 ms of
// memory time against ~3.6 ms at the 67 TFLOP/s float32 CUDA-core peak (or
// ~0.24 ms at the 989 TFLOP/s bf16 tensor-core peak).
//
// Design. Nothing but x and eps touches device memory. A persistent block
// keeps W2 and W3 in shared memory for its whole life and walks row tiles of
// 32 rows per group of 128 threads; each thread owns one hidden unit and keeps
// the tile's 32 pre-activations in registers (32 independent FMA chains),
// reading the layer's input rows as shared-memory broadcasts. Without the
// L2 norm of the NsDiff trunk a layer needs no reduction across threads: the
// gated softplus goes straight to the shared row buffer, with one barrier of
// the group before the store (every read of the buffer is done) and one after
// it (the rows are complete). Only the F-wide head reduces over the 128
// units (warp shuffles, then four partials in shared memory). The shared
// memory plan holds what this kernel has and no more: a 2F-row W1, no sigma
// head, no norm scratch. The products run on the float32 CUDA cores, also for
// the bf16 arm, whose operands are rounded to bf16 exactly as the TPU kernel
// rounds them; moving the two 128x128 products onto the tensor cores is the
// next step toward the bound. Ragged last tiles are masked, not padded.
#include "denoiser_trunk.cuh"

namespace upgdm {

// Shared-memory plan of K3: the weights once per block, then G workspaces.
template <typename WT>
struct TmdmPlan {
  size_t w2, w3, w1, w4, groups, group_bytes, total;
  // Offsets (bytes) inside one group's workspace.
  size_t hs, red, io;

  __host__ __device__ TmdmPlan(int F, int G) {
    size_t off = 0;
    w2 = off; off += align16(sizeof(WT) * HID * HID);
    w3 = off; off += align16(sizeof(WT) * HID * HID);
    w1 = off; off += align16(sizeof(WT) * 2 * F * HID);
    w4 = off; off += align16(sizeof(WT) * HID * F);
    groups = off;
    size_t g = 0;
    hs = g; g += align16(sizeof(float) * R * HID);
    red = g; g += align16(sizeof(float) * WARPS * R * F);
    io = g; g += align16(sizeof(float) * R * 2 * F);
    group_bytes = g;
    total = groups + size_t(G) * group_bytes;
  }
};

template <typename WT>
__global__ void __launch_bounds__(4 * HID, 1)
fused_tmdm_kernel(const float* __restrict__ x, long long M, int F,
                  const float* __restrict__ g1, const float* __restrict__ g2,
                  const float* __restrict__ g3, const WT* __restrict__ W1,
                  const float* __restrict__ b1, const WT* __restrict__ W2,
                  const float* __restrict__ b2, const WT* __restrict__ W3,
                  const float* __restrict__ b3, const WT* __restrict__ W4,
                  const float* __restrict__ b4, float* __restrict__ eps_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / HID;
  const int IN = 2 * F;
  const TmdmPlan<WT> plan(F, G);
  WT* W1s = reinterpret_cast<WT*>(smem + plan.w1);
  WT* W2s = reinterpret_cast<WT*>(smem + plan.w2);
  WT* W3s = reinterpret_cast<WT*>(smem + plan.w3);
  WT* W4s = reinterpret_cast<WT*>(smem + plan.w4);
  stage(W2s, W2, HID * HID);
  stage(W3s, W3, HID * HID);
  stage(W1s, W1, IN * HID);
  stage(W4s, W4, HID * F);
  __syncthreads();

  const int group = threadIdx.x / HID;
  const int j = threadIdx.x % HID;
  const int warp = j >> 5, lane = j & 31;
  unsigned char* base = smem + plan.groups + size_t(group) * plan.group_bytes;
  float* hs = reinterpret_cast<float*>(base + plan.hs);    // [R, HID] layer input rows
  float* red = reinterpret_cast<float*>(base + plan.red);  // [WARPS, R*F] partial head
  float* io = reinterpret_cast<float*>(base + plan.io);    // [R, 2F] staged input rows
  const float gam1 = g1[j], gam2 = g2[j], gam3 = g3[j];
  const float bb1 = b1[j], bb2 = b2[j], bb3 = b3[j];
  const long long rows_per_block = (long long)G * R;
  const long long tiles = (M + rows_per_block - 1) / rows_per_block;

  float acc[R];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * rows_per_block + (long long)group * R;
    if (row0 >= M) continue;  // the whole group is past the end (uniform per group)
    // stage the group's input rows (zeros past M), rounded for the matmul
    for (int i = j; i < R * IN; i += HID) {
      const long long e = row0 * IN + i;
      io[i] = (e < M * IN) ? rnd<WT>(x[e]) : 0.0f;
    }
    group_sync(group);
    // layer 1: [R, 2F] . W1[2F, 128]; hs is free (layer 3 of the previous
    // tile finished before the barriers above)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a = 0.0f;
      for (int i = 0; i < IN; ++i) a = fmaf(io[r * IN + i], to_f(W1s[i * HID + j]), a);
      hs[r * HID + j] = rnd<WT>(softplus(gam1 * (a + bb1)));
    }
    group_sync(group);  // layer 1's rows complete
    // layer 2
    dense_hidden<WT>(hs, W2s, j, acc);
    group_sync(group);  // every read of hs is done
#pragma unroll
    for (int r = 0; r < R; ++r) hs[r * HID + j] = rnd<WT>(softplus(gam2 * (acc[r] + bb2)));
    group_sync(group);  // layer 2's rows complete
    // layer 3 stays in registers
    dense_hidden<WT>(hs, W3s, j, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = rnd<WT>(softplus(gam3 * (acc[r] + bb3)));
    // head: eps[r, f] = sum_j h[r, j] * W4[j, f] + b4[f]
    for (int f = 0; f < F; ++f) {
      const float w4 = to_f(W4s[j * F + f]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pe = warp_sum(acc[r] * w4);
        if (lane == 0) red[warp * R * F + r * F + f] = pe;
      }
    }
    group_sync(group);
    if (j < R * F) {
      float e = red[j];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) e += red[w * R * F + j];
      const long long row = row0 + j / F;
      if (row < M) eps_out[row * F + j % F] = e + b4[j % F];
    }
  }
}

// Largest group count (4, 2 or 1) whose plan fits the card's opt-in shared
// memory; 0 if none does.
template <typename WT>
static int pick_tmdm_groups(int F, size_t* smem_bytes) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int G = 4; G >= 1; G >>= 1) {
    TmdmPlan<WT> p(F, G);
    if (p.total <= size_t(optin)) {
      *smem_bytes = p.total;
      return G;
    }
  }
  return 0;
}

template <typename WT>
static int launch_tmdm(const float* x, long long M, int F, const float* g1, const float* g2,
                       const float* g3, const void* W1, const float* b1, const void* W2,
                       const float* b2, const void* W3, const float* b3, const void* W4,
                       const float* b4, float* eps, cudaStream_t stream) {
  if (F < 1 || F > MAX_F || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  size_t smem = 0;
  const int G = pick_tmdm_groups<WT>(F, &smem);
  if (G == 0) return (int)cudaErrorInvalidConfiguration;
  auto kernel = fused_tmdm_kernel<WT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = G * HID;
  const long long tiles = (M + (long long)G * R - 1) / ((long long)G * R);
  const int grid = persistent_grid(kernel, threads, smem, tiles);
  kernel<<<grid, threads, smem, stream>>>(
      x, M, F, g1, g2, g3, static_cast<const WT*>(W1), b1, static_cast<const WT*>(W2), b2,
      static_cast<const WT*>(W3), b3, static_cast<const WT*>(W4), b4, eps);
  return (int)cudaGetLastError();
}

}  // namespace upgdm

// C interface (ctypes). bf16 != 0 selects bf16 weight matrices (W1..W4);
// everything else is float32. Returns cudaGetLastError() after the launch.
extern "C" int upgdm_fused_tmdm(const float* x, long long M, int F, const float* g1,
                                const float* g2, const float* g3, const void* W1,
                                const float* b1, const void* W2, const float* b2,
                                const void* W3, const float* b3, const void* W4,
                                const float* b4, float* eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return upgdm::launch_tmdm<__nv_bfloat16>(x, M, F, g1, g2, g3, W1, b1, W2, b2, W3, b3, W4,
                                             b4, eps, st);
  return upgdm::launch_tmdm<float>(x, M, F, g1, g2, g3, W1, b1, W2, b2, W3, b3, W4, b4, eps,
                                   st);
}
