// Shared device code of the NsDiff denoiser kernels (fused_denoiser.cu and
// chain_resident.cu): the three-layer conditional trunk
//     h = l2norm(softplus(gamma_t * (h . W_i + b_i)))       i = 1, 2, 3
// and the two heads eps = h . W4 + b4, sigma = softplus(softplus(h) . Ws + bs).
//
// Layout. A block is G groups of 128 threads; thread j of a group owns hidden
// unit j for the group's R rows and keeps their activations in registers.
// The 128x128 matrices W2 and W3 sit in dynamic shared memory for the whole
// (persistent) block; a layer's input rows are staged in shared memory so
// every thread reads them as broadcasts. The per-row sum of squares is a warp
// shuffle plus a shared-memory reduction over the group's four warps; the
// F-wide heads reduce the same way over the 128 hidden units.
//
// Numerics. Sums accumulate in float32 in a fixed order (k = 0..127). With
// bf16 matmuls (WT = __nv_bfloat16) both dot operands are rounded to bf16
// (round to nearest even) and the products accumulate in float32, as the TPU
// kernel does. Activations are float32, or with ACT (the TPU kernels'
// act_dtype = bfloat16) bf16: act_softplus rounds after every operation, the
// sum of squares stays float32 over the rounded squares, and the layer's
// output is the bf16 row times the bf16-rounded rsqrt.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_math.cuh"

namespace upgdm {

constexpr int HID = 128;      // hidden width of the denoiser
constexpr int R = 32;         // rows per group of 128 threads
constexpr int WARPS = HID / 32;
constexpr int MAX_F = 4;      // feature width the shared-memory plan allows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round a dot operand to the matmul type (identity for float32 weights).
template <typename WT>
__device__ __forceinline__ float rnd(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), as jax.nn.softplus.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// The gate and softplus of one pre-activation in bf16, as the TPU kernels'
// act_dtype = bfloat16 arm computes them (fused_denoiser.py:125-133 with
// _softplus_branchfree, chain_resident.py:87-90): the float32 product is
// rounded, then o = g (o + b) and log(1 + exp(-|o|)) + 0.5 (o + |o|) are
// taken with a bf16 rounding after every operation. g and b are bf16 values.
// exp and log are the special-function unit's ex2 / lg2 (relative error
// ~2^-22, far below the 2^-9 of the rounding that follows each).
__device__ __forceinline__ float act_softplus(float acc, float g, float b) {
  const float o = rnd_bf16(g * rnd_bf16(rnd_bf16(acc) + b));
  const float ax = fabsf(o);
  const float e = rnd_bf16(ex2_approx(-1.4426950408889634f * ax));
  const float l = rnd_bf16(lg2_approx(rnd_bf16(1.0f + e)) * 0.6931471805599453f);
  return rnd_bf16(l + 0.5f * rnd_bf16(o + ax));  // 0.5 x is exact
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Barrier over the 128 threads of one group (named barrier 1 + group).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(HID) : "memory");
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared-memory plan: the weights once per block, then G group workspaces.
template <typename WT>
struct SmemPlan {
  size_t w2, w3, w1, w4, ws, groups, group_bytes, total;
  // Offsets (bytes) inside one group's workspace.
  size_t hs, red_ss, red_e, red_s, io;

  __host__ __device__ SmemPlan(int F, int G) {
    size_t off = 0;
    w2 = off; off += align16(sizeof(WT) * HID * HID);
    w3 = off; off += align16(sizeof(WT) * HID * HID);
    w1 = off; off += align16(sizeof(WT) * 3 * F * HID);
    w4 = off; off += align16(sizeof(WT) * HID * F);
    ws = off; off += align16(sizeof(WT) * HID * F);
    groups = off;
    size_t g = 0;
    hs = g; g += align16(sizeof(float) * R * HID);
    red_ss = g; g += align16(sizeof(float) * WARPS * R);
    red_e = g; g += align16(sizeof(float) * WARPS * R * F);
    red_s = g; g += align16(sizeof(float) * WARPS * R * F);
    io = g; g += align16(sizeof(float) * R * 3 * F);
    group_bytes = g;
    total = groups + size_t(G) * group_bytes;
  }
};

// Copy n elements global -> shared with the whole block.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Per-group views of the shared workspace.
struct GroupSmem {
  float* hs;      // [R, HID] activations feeding the next layer
  float* red_ss;  // [WARPS, R] partial sums of squares
  float* red_e;   // [WARPS, R*F] partial eps head
  float* red_s;   // [WARPS, R*F] partial sigma head
  float* io;      // [R, 3F] staged input rows / chain state
};

template <typename WT>
__device__ __forceinline__ GroupSmem group_smem(unsigned char* smem, const SmemPlan<WT>& p,
                                                int group) {
  unsigned char* base = smem + p.groups + size_t(group) * p.group_bytes;
  GroupSmem s;
  s.hs = reinterpret_cast<float*>(base + p.hs);
  s.red_ss = reinterpret_cast<float*>(base + p.red_ss);
  s.red_e = reinterpret_cast<float*>(base + p.red_e);
  s.red_s = reinterpret_cast<float*>(base + p.red_s);
  s.io = reinterpret_cast<float*>(base + p.io);
  return s;
}

// acc[r] = sum_k hs[r, k] * W[k, j] over the 128 inputs of a hidden layer.
template <typename WT>
__device__ __forceinline__ void dense_hidden(const float* hs, const WT* W, int j,
                                             float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < HID; k += 4) {
    const float w0 = to_f(W[(k + 0) * HID + j]);
    const float w1 = to_f(W[(k + 1) * HID + j]);
    const float w2 = to_f(W[(k + 2) * HID + j]);
    const float w3 = to_f(W[(k + 3) * HID + j]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 h = *reinterpret_cast<const float4*>(hs + r * HID + k);
      float a = acc[r];
      a = fmaf(h.x, w0, a);
      a = fmaf(h.y, w1, a);
      a = fmaf(h.z, w2, a);
      a = fmaf(h.w, w3, a);
      acc[r] = a;
    }
  }
}

// Gate, softplus and L2-normalise the R pre-activations of hidden unit j:
// v = softplus(gamma * (acc + bias)); h = v * rsqrt(max(sum_j v^2, 1e-24)),
// in float32 or, with ACT, in bf16 (act_softplus; the squares rounded before
// the float32 sum, h = bf16(v * bf16(rsqrt))). When `store` is set the
// (bf16-rounded, for bf16 matmuls) rows are written to hs for the next layer.
// Must be entered by all 128 threads of the group after they finished
// reading hs.
template <typename WT, bool ACT>
__device__ __forceinline__ void norm_band(float (&acc)[R], float gamma, float bias,
                                          const GroupSmem& s, int group, int j,
                                          bool store) {
  const int warp = j >> 5, lane = j & 31;
  if (ACT) {
    gamma = rnd_bf16(gamma);
    bias = rnd_bf16(bias);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float v = ACT ? act_softplus(acc[r], gamma, bias) : softplus(gamma * (acc[r] + bias));
    acc[r] = v;
    const float ss = warp_sum(ACT ? rnd_bf16(v * v) : v * v);
    if (lane == 0) s.red_ss[warp * R + r] = ss;
  }
  group_sync(group);  // partial sums visible; every read of hs is done
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float ss = s.red_ss[r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) ss += s.red_ss[w * R + r];
    const float scale = rsqrtf(fmaxf(ss, 1e-24f));
    acc[r] = ACT ? rnd_bf16(acc[r] * rnd_bf16(scale)) : acc[r] * scale;
    if (store) s.hs[r * HID + j] = rnd<WT>(acc[r]);
  }
  group_sync(group);  // hs complete; red_ss free again
}

// Layers 2 and 3 of the trunk; on entry hs holds layer 1's output rows and
// acc layer 1's output for unit j. On exit acc holds h (float32 holding bf16
// values with ACT).
template <typename WT, bool ACT>
__device__ __forceinline__ void trunk_tail(float (&acc)[R], const WT* W2s, const WT* W3s,
                                           float g2, float b2, float g3, float b3,
                                           const GroupSmem& s, int group, int j) {
  dense_hidden<WT>(s.hs, W2s, j, acc);
  norm_band<WT, ACT>(acc, g2, b2, s, group, j, true);
  dense_hidden<WT>(s.hs, W3s, j, acc);
  norm_band<WT, ACT>(acc, g3, b3, s, group, j, false);
}

// The two heads over h (acc): thread j adds its unit's terms; after the
// call, thread o < R*F of the group holds row o / F, feature o % F in
// (*eps, *sigma). Must be entered by all 128 threads of the group.
template <typename WT>
__device__ __forceinline__ void heads(const float (&acc)[R], const WT* W4s, const WT* Wss,
                                      const float* b4, const float* bs, int F,
                                      const GroupSmem& s, int group, int j,
                                      float* eps, float* sigma) {
  const int warp = j >> 5, lane = j & 31;
  for (int f = 0; f < F; ++f) {
    const float w4 = to_f(W4s[j * F + f]);
    const float wsg = to_f(Wss[j * F + f]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pe = warp_sum(rnd<WT>(acc[r]) * w4);
      const float ps = warp_sum(rnd<WT>(softplus(acc[r])) * wsg);
      if (lane == 0) {
        s.red_e[warp * R * F + r * F + f] = pe;
        s.red_s[warp * R * F + r * F + f] = ps;
      }
    }
  }
  group_sync(group);
  if (j < R * F) {
    const int f = j % F;
    float e = s.red_e[j], q = s.red_s[j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      e += s.red_e[w * R * F + j];
      q += s.red_s[w * R * F + j];
    }
    *eps = e + b4[f];
    *sigma = softplus(q + bs[f]);
  }
}

// Stage the trunk's weights into shared memory (whole block).
template <typename WT>
__device__ __forceinline__ void stage_weights(unsigned char* smem, const SmemPlan<WT>& p,
                                              int F, const WT* W1, const WT* W2,
                                              const WT* W3, const WT* W4, const WT* Ws) {
  stage(reinterpret_cast<WT*>(smem + p.w2), W2, HID * HID);
  stage(reinterpret_cast<WT*>(smem + p.w3), W3, HID * HID);
  stage(reinterpret_cast<WT*>(smem + p.w1), W1, 3 * F * HID);
  stage(reinterpret_cast<WT*>(smem + p.w4), W4, HID * F);
  stage(reinterpret_cast<WT*>(smem + p.ws), Ws, HID * F);
  __syncthreads();
}

// Largest group count (4, 2 or 1) whose plan fits the card's opt-in shared
// memory; 0 if none does.
template <typename WT>
inline int pick_groups(int F, size_t* smem_bytes) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int G = 4; G >= 1; G >>= 1) {
    SmemPlan<WT> p(F, G);
    if (p.total <= size_t(optin)) {
      *smem_bytes = p.total;
      return G;
    }
  }
  return 0;
}

// Persistent grid: at most (resident blocks per SM) x (SM count) blocks.
template <typename K>
inline int persistent_grid(K kernel, int threads, size_t smem, long long tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > tiles) grid = tiles;
  return (int)(grid > 0 ? grid : 1);
}

}  // namespace upgdm
