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
// Bound on the H100, three terms. At the TMDM sweep's size (M = 3.6 M rows,
// F = 1) the step moves about 43 MB (x in, eps out: ~0.013 ms at 3.35 TB/s),
// does about 2.4e11 FLOP (the two 128x128 layers dominate: ~0.24 ms at the
// 989 TFLOP/s bf16 tensor-core peak, ~3.6 ms at the 67 TFLOP/s float32
// CUDA-core peak) and 3.6 M x 384 softplus of one exp and one log each
// (~0.7 ms at 16 special-function results a clock on each of 132 SMs at
// 1.98 GHz). So the bf16 arm is bound by special functions, the float32 arm
// by operations.
//
// Design. Nothing but x and eps touches device memory, in either arm.
//  * bfloat16 matmuls (the arm the sweeps use): fused_tmdm_mma_kernel on the
//    tensor-core trunk of trunk_mma.cuh. A block is four warpgroups that share
//    the staged weights; each walks tiles of 64 rows of its own. W2 and W3
//    stay in shared memory in the order wgmma reads; activations chain from
//    one product's accumulators into the next product's A operand in
//    registers; the head is a dot product over the thread's 32 columns and
//    two quad shuffles; lane q of a quad stores feature q. While one
//    warpgroup waits on its products the others run their softplus bands.
//  * float32 matmuls (the parity arm): fused_tmdm_kernel on the float32 CUDA
//    cores. A persistent block keeps W2 and W3 in shared memory and walks
//    tiles of 32 rows per group of 128 threads; each thread owns one hidden
//    unit, keeps the tile's pre-activations in registers and reads a layer's
//    input rows as shared-memory broadcasts, with one barrier of the group
//    before the row buffer is overwritten and one after. The head reduces
//    over the 128 units with warp shuffles and four partials in shared memory.
// Ragged last tiles are masked, not padded.
#include "denoiser_trunk.cuh"
#include "trunk_mma.cuh"

namespace upgdm {

static_assert(MAX_F <= 4, "a quad of lanes stores one row's F outputs");

// ---- float32 arm: CUDA cores -----------------------------------------------------

// Shared-memory plan of the float32 arm: the weights once per block, then G
// workspaces.
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

// ---- bfloat16 arm: tensor-core trunk ---------------------------------------------

// One block of four warpgroups per SM: every feature width fits 128 registers
// a thread without spills (ptxas -v).
template <int F>
__global__ void __launch_bounds__(128 * mma::MAX_WGS, 1)
fused_tmdm_mma_kernel(const float* __restrict__ x, long long M,
                      const float* __restrict__ g1, const float* __restrict__ g2,
                      const float* __restrict__ g3, const __nv_bfloat16* __restrict__ W1,
                      const float* __restrict__ b1, const uint4* __restrict__ W2t,
                      const float* __restrict__ b2, const uint4* __restrict__ W3t,
                      const float* __restrict__ b3, const __nv_bfloat16* __restrict__ W4,
                      const float* __restrict__ b4, float* __restrict__ eps_out) {
  constexpr int IN = 2 * F;
  using S = mma::Smem<IN, F>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mma::align_1024(smem_raw);
  float* w4 = reinterpret_cast<float*>(smem + S::heads);
  mma::stage_head<F>(w4, W4);
  mma::stage_trunk<IN, F>(smem, W1, W2t, W3t, g1, b1, g2, b2, g3, b3);

  const mma::Walk walk;
  const int q = walk.q;
  const int tiles = (int)((M + mma::TILE - 1) / mma::TILE);

  float acc[mma::ACC];
  for (int tile = walk.first; tile < tiles; tile += walk.stride) {
    const long long r0 = (long long)tile * mma::TILE + walk.row;
    mma::prefetch_rows<IN>(x, M, r0 + (long long)walk.stride * mma::TILE, q);
    mma::trunk<IN, F, false>(acc, x, M, r0, smem, q);
    float o0, o1;
    mma::head<F>(acc, w4, q, o0, o1);
    if (q < F) {
      if (r0 < M) eps_out[r0 * F + q] = o0 + b4[q];
      if (r0 + 8 < M) eps_out[(r0 + 8) * F + q] = o1 + b4[q];
    }
  }
}

template <int F>
static int launch_tmdm_mma(const float* x, long long M, const float* g1, const float* g2,
                           const float* g3, const void* W1, const float* b1, const void* W2t,
                           const float* b2, const void* W3t, const float* b3, const void* W4,
                           const float* b4, float* eps, cudaStream_t stream) {
  auto kernel = fused_tmdm_mma_kernel<F>;
  constexpr size_t smem = mma::Smem<2 * F, F>::total;
  int grid = 0;
  const int err =
      mma::configure(kernel, mma::MAX_WGS, smem, (M + mma::TILE - 1) / mma::TILE, &grid);
  if (err != (int)cudaSuccess) return err;
  kernel<<<grid, 128 * mma::MAX_WGS, smem, stream>>>(
      x, M, g1, g2, g3, static_cast<const __nv_bfloat16*>(W1), b1,
      static_cast<const uint4*>(W2t), b2, static_cast<const uint4*>(W3t), b3,
      static_cast<const __nv_bfloat16*>(W4), b4, eps);
  return (int)cudaGetLastError();
}

}  // namespace upgdm

// C interface (ctypes). bf16 != 0 selects the tensor-core arm: W1 [2F, 128]
// and W4 [128, F] are bf16 and W2, W3 are bf16 in the tiled B-operand order of
// trunk_mma.cuh (ops/kernels/fused_denoiser.py::tile_b_operand). Otherwise all
// four matrices are float32 [in, out]. Everything else is float32. Returns
// cudaGetLastError() after the launch.
extern "C" int upgdm_fused_tmdm(const float* x, long long M, int F, const float* g1,
                                const float* g2, const float* g3, const void* W1,
                                const float* b1, const void* W2, const float* b2,
                                const void* W3, const float* b3, const void* W4,
                                const float* b4, float* eps, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return upgdm::launch_tmdm<float>(x, M, F, g1, g2, g3, W1, b1, W2, b2, W3, b3, W4, b4, eps,
                                     st);
  if (M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
#define UPGDM_TMDM_MMA(N) \
  upgdm::launch_tmdm_mma<N>(x, M, g1, g2, g3, W1, b1, W2, b2, W3, b3, W4, b4, eps, st)
  switch (F) {
    case 1: return UPGDM_TMDM_MMA(1);
    case 2: return UPGDM_TMDM_MMA(2);
    case 3: return UPGDM_TMDM_MMA(3);
    case 4: return UPGDM_TMDM_MMA(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef UPGDM_TMDM_MMA
}
