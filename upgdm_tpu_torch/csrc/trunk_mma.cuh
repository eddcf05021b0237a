// Tensor-core trunk of the denoiser kernels for Hopper (sm_90a): the bf16 arm
// of fused_denoiser.cu (K1), fused_tmdm.cu (K3) and chain_resident.cu (K2, which
// runs it once per reverse step on a tile it keeps in registers). It replaces,
// for matmul_dtype = bfloat16, the body of the TPU kernels
// upgdm_tpu/ops/pallas/fused_denoiser.py::_kernel and ::_tmdm_kernel and the
// trunk of upgdm_tpu/ops/pallas/chain_resident.py::_chain_kernel:
//     h = [l2norm](softplus(gamma_i * (h . W_i + b_i)))       i = 1, 2, 3
// followed by the kernel's own F-wide heads.
//
// Bound on the H100, three terms. Per row the trunk does two 128x128 products
// (65,536 FLOP of the ~66,000), moves 8 to 20 bytes of device memory, and
// takes 384 (K3) or 512 (K1) softplus, each one ex2 and one lg2 on the
// special-function unit, which issues 16 results a clock on each of 132 SMs.
// At the sweeps' sizes the bytes take ~0.03 ms, the products ~0.3 ms at the
// 989 TFLOP/s bf16 tensor-core peak, and the special functions ~1.2 ms (K1,
// 4.8 M rows) or ~0.7 ms (K3, 3.6 M rows) at 1.98 GHz: once the products are
// on the tensor cores the softplus band is the limit.
//
// Design.
//  * One warpgroup (128 threads) owns a tile of 64 rows. Layers 2 and 3 are
//    wgmma.mma_async m64n128k16 products, bf16 operands and float32 sums:
//    B = W2 or W3 stays in shared memory for the whole persistent block, in
//    the K-major 128-byte-swizzled order that wgmma reads (laid out once
//    on the host, copied in with plain 16-byte loads); A comes from registers.
//  * Activations never touch shared memory. The accumulator fragment of one
//    product (thread: rows g and g+8 of its warp's 16, columns 8j + 2q, +1
//    for j = 0..15, with g = lane / 4, q = lane % 4) is the A fragment of the
//    next after pairs are rounded to bf16 (round to nearest even) and packed.
//    The first k16 slice of a product declares the accumulators as outputs
//    only, so the old fragment is dead once it is packed.
//  * Gate, bias and softplus work on the fragment: one FMA with (gamma,
//    gamma * bias), read as one float4 per column pair from a small shared
//    array, then softplus. The per-row sum of squares of K1's norm is 32 local
//    adds and two quad shuffles, in float32.
//  * Layer 1 (K = 2F or 3F <= 12) is FMAs straight into the fragment layout
//    from x rounded to bf16, one input column at a time; the next tile's rows
//    are asked into L2 meanwhile. The heads are per-thread dot products over
//    the thread's 32 columns plus the same quad shuffles.
//  * The softplus band overlaps the products across warpgroups: a block is
//    four warpgroups (three where a kernel needs more than 128 registers)
//    that share the staged weights (~70 KB) and walk tiles independently, so
//    while one waits on its wgmma the others run their epilogues (tensor
//    cores and the special-function unit are different pipes). Sixteen warps
//    an SM at 128 registers measured faster than twelve at 168.
//  * softplus in this arm is ex2.approx / lg2.approx with the series
//    e - e^2/2 of log1p below e = 2^-7, so that strongly negative
//    pre-activations keep their relative accuracy (K1 divides by the row
//    norm). Its relative error (< 3e-5) is far below the bf16 rounding
//    (2^-9) that follows it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace upgdm {
namespace mma {

constexpr int HID = 128;        // hidden width of the denoiser
constexpr int TILE = 64;        // rows per warpgroup tile (wgmma M)
constexpr int MAX_WGS = 4;      // warpgroups a block: 4 leave 128 registers a thread, 3 leave 168
constexpr int ACC = 64;         // accumulator registers a thread (2 rows x 32 columns)
constexpr int W_BYTES = HID * HID * 2;       // one bf16 128x128 matrix
constexpr int KBLOCK_BYTES = HID * 64 * 2;   // 128 rows (n) x 64 k of one swizzle block

// ---- small device helpers --------------------------------------------------

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus(x) = max(x, 0) + log1p(exp(-|x|)) in two special-function
// operations and eight others. log1p(e) is lg2(1 + e) * ln 2 for e >= 2^-7
// (absolute error ~2.3e-7 from the rounding of 1 + e and lg2.approx, i.e.
// below 3e-5 relative) and the series e - e^2/2 below it (relative error
// < e^2/3 = 2e-5), where 1 + e would lose the low bits of e.
__device__ __forceinline__ float softplus_fast(float x) {
  const float e = ex2_approx(-1.4426950408889634f * fabsf(x));
  const float relu = fmaxf(x, 0.0f);
  const float big = fmaf(lg2_approx(1.0f + e), 0.6931471805599453f, relu);
  const float small = fmaf(e, fmaf(e, -0.5f, 1.0f), relu);
  return e < 0.0078125f ? small : big;
}

// Two float32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sum over the four lanes of a quad (the lanes that hold one row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// ---- wgmma -------------------------------------------------------------------

// Shared-memory descriptor of a K-major, 128-byte-swizzled B operand: start
// address, LBO (unused in this mode, 1), SBO = 1024 bytes between groups of 8
// rows, layout type 1 (B128). The matrix must start on a 1024-byte boundary.
__device__ __forceinline__ uint64_t b_descriptor(uint32_t smem_addr) {
  return uint64_t((smem_addr & 0x3FFFFu) >> 4) | (uint64_t(1) << 16) | (uint64_t(64) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving uses of a register across the asynchronous
// product that reads or writes it.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define UPGDM_D8(c, b) c(d[b]), c(d[b + 1]), c(d[b + 2]), c(d[b + 3]), c(d[b + 4]), \
                       c(d[b + 5]), c(d[b + 6]), c(d[b + 7])
#define UPGDM_D64(c) UPGDM_D8(c, 0), UPGDM_D8(c, 8), UPGDM_D8(c, 16), UPGDM_D8(c, 24), \
                     UPGDM_D8(c, 32), UPGDM_D8(c, 40), UPGDM_D8(c, 48), UPGDM_D8(c, 56)
#define UPGDM_WGMMA_REGS                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                           \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "                   \
  "{%64, %65, %66, %67}, %68, "

// One k16 slice of a product: a is the thread's A fragment (4 registers of
// packed bf16), desc the B slice in shared memory. wgmma_first overwrites d
// (scale-d false; d is an output only, so its old values are dead once they
// are packed); wgmma_next adds to it.
__device__ __forceinline__ void wgmma_first(float (&d)[ACC], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " UPGDM_WGMMA_REGS
      "p, 1, 1, 0;\n"
      "}\n"
      : UPGDM_D64("=&f")
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(0));
}

__device__ __forceinline__ void wgmma_next(float (&d)[ACC], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " UPGDM_WGMMA_REGS
      "p, 1, 1, 0;\n"
      "}\n"
      : UPGDM_D64("+f")
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

#undef UPGDM_WGMMA_REGS
#undef UPGDM_D64
#undef UPGDM_D8

// acc <- bf16(acc) . W for a 128x128 W at shared address w_addr. The
// accumulator fragment is rounded to bf16 and packed into the A fragments of
// the eight k16 slices, all in registers.
__device__ __forceinline__ void hidden_product(float (&acc)[ACC], uint32_t w_addr) {
  uint32_t a[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 32; ++i) pin(a[i]);
  wgmma_fence();
  wgmma_first(acc, a[0], a[1], a[2], a[3], b_descriptor(w_addr));
#pragma unroll
  for (int kk = 1; kk < 8; ++kk) {
    const uint64_t desc = b_descriptor(w_addr + (kk >> 2) * KBLOCK_BYTES + (kk & 3) * 32);
    wgmma_next(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc);
  }
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int i = 0; i < 32; ++i) pin(a[i]);
#pragma unroll
  for (int i = 0; i < ACC; ++i) pin(acc[i]);
}

// ---- shared memory -----------------------------------------------------------

// Shared-memory plan of one block: W2 and W3 in the tiled bf16 order (each on
// a 1024-byte boundary), then float32 arrays: the three layers' (gamma,
// gamma * bias) as float4 per column pair, W1 [IN, 128] and NH head rows
// [NH, 128] (a head matrix [128, F] is stored transposed, feature by feature).
template <int IN, int NH>
struct Smem {
  static constexpr int w2 = 0;
  static constexpr int w3 = W_BYTES;
  static constexpr int gb = 2 * W_BYTES;                 // 3 x 64 float4
  static constexpr int w1 = gb + 3 * 64 * 16;            // IN x 128 float
  static constexpr int heads = w1 + IN * HID * 4;        // NH x 128 float
  static constexpr int bytes = heads + NH * HID * 4;
  static constexpr int total = bytes + 1024;             // slack to align the base
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// (gamma, gamma * bias) of columns 2p and 2p + 1: the gate is one FMA,
// gamma * (acc + bias) = fma(gamma, acc, gamma * bias) to an ulp.
__device__ __forceinline__ float4 gate_pair(const float* g, const float* b, int p) {
  return make_float4(g[2 * p], g[2 * p] * b[2 * p], g[2 * p + 1], g[2 * p + 1] * b[2 * p + 1]);
}

// Stage the trunk's matrices (whole block): W2t and W3t are in the tiled order
// already; W1 is [IN, 128] bf16 and is kept as float32. No barrier.
template <int IN, int NH>
__device__ __forceinline__ void stage_matrices(unsigned char* smem, const __nv_bfloat16* W1,
                                               const uint4* W2t, const uint4* W3t) {
  using S = Smem<IN, NH>;
  uint4* w2 = reinterpret_cast<uint4*>(smem + S::w2);
  uint4* w3 = reinterpret_cast<uint4*>(smem + S::w3);
  for (int i = threadIdx.x; i < W_BYTES / 16; i += blockDim.x) {
    w2[i] = W2t[i];
    w3[i] = W3t[i];
  }
  float* w1 = reinterpret_cast<float*>(smem + S::w1);
  for (int i = threadIdx.x; i < IN * HID; i += blockDim.x) w1[i] = __bfloat162float(W1[i]);
}

// Make the staged matrices visible to the block and to wgmma, which reads
// shared memory through the async proxy.
__device__ __forceinline__ void staging_done() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// Stage the trunk's weights and one step's gates (whole block). Ends with the
// block barrier.
template <int IN, int NH>
__device__ __forceinline__ void stage_trunk(unsigned char* smem, const __nv_bfloat16* W1,
                                            const uint4* W2t, const uint4* W3t,
                                            const float* g1, const float* b1, const float* g2,
                                            const float* b2, const float* g3, const float* b3) {
  using S = Smem<IN, NH>;
  stage_matrices<IN, NH>(smem, W1, W2t, W3t);
  float4* gb = reinterpret_cast<float4*>(smem + S::gb);
  for (int p = threadIdx.x; p < 64; p += blockDim.x) {
    gb[p] = gate_pair(g1, b1, p);
    gb[64 + p] = gate_pair(g2, b2, p);
    gb[128 + p] = gate_pair(g3, b3, p);
  }
  staging_done();
}

// Stage one head matrix W [128, F] bf16 as F float32 rows of 128 (before the
// barrier of stage_trunk).
template <int F>
__device__ __forceinline__ void stage_head(float* dst, const __nv_bfloat16* W) {
  for (int i = threadIdx.x; i < F * HID; i += blockDim.x) {
    const int f = i / HID, c = i % HID;
    dst[i] = __bfloat162float(W[c * F + f]);
  }
}

// ---- the trunk on a fragment ---------------------------------------------------

// The walk of one warpgroup over the tiles: first tile, stride, and the first
// of the thread's two rows inside a tile (the second is 8 below).
struct Walk {
  int first, stride, row, q;
  __device__ __forceinline__ Walk()
      : first(blockIdx.x * (blockDim.x >> 7) + (threadIdx.x >> 7)),
        stride(gridDim.x * (blockDim.x >> 7)),
        row(((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2)),
        q(threadIdx.x & 3) {}
};

// Ask for the thread's two rows of a later tile to be brought into L2.
template <int IN>
__device__ __forceinline__ void prefetch_rows(const float* __restrict__ x, long long M,
                                              long long r0, int q) {
  if (q == 0 && r0 < M) asm volatile("prefetch.global.L2 [%0];" ::"l"(x + r0 * IN));
  if (q == 1 && r0 + 8 < M) asm volatile("prefetch.global.L2 [%0];" ::"l"(x + (r0 + 8) * IN));
}

// Layer 1: acc = bf16(x) . W1 in the accumulator layout for the thread's rows
// r0 and r0 + 8 (rows past M read as zeros; w1: [IN, 128] float32). One input
// column at a time, so only two values of x are held beside the fragment.
template <int IN>
__device__ __forceinline__ void first_product(float (&acc)[ACC], const float* __restrict__ x,
                                              long long M, long long r0, const float* w1,
                                              int q) {
  const float2* w = reinterpret_cast<const float2*>(w1);
  const float* p0 = x + r0 * IN;
  const bool ok0 = r0 < M, ok1 = r0 + 8 < M;
#pragma unroll
  for (int i = 0; i < IN; ++i) {
    const float xa = ok0 ? rnd_bf16(__ldg(p0 + i)) : 0.0f;
    const float xb = ok1 ? rnd_bf16(__ldg(p0 + 8 * IN + i)) : 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 c = w[i * 64 + 4 * j + q];
      acc[4 * j] = i ? fmaf(xa, c.x, acc[4 * j]) : xa * c.x;
      acc[4 * j + 1] = i ? fmaf(xa, c.y, acc[4 * j + 1]) : xa * c.y;
      acc[4 * j + 2] = i ? fmaf(xb, c.x, acc[4 * j + 2]) : xb * c.x;
      acc[4 * j + 3] = i ? fmaf(xb, c.y, acc[4 * j + 3]) : xb * c.y;
    }
  }
}

// acc <- softplus(gamma * (acc + bias)), and with NORM each row is scaled by
// rsqrt(max(sum of squares, 1e-24)). gb: the layer's 64 float4 (g, g b, g, g b).
template <bool NORM>
__device__ __forceinline__ void gate_band(float (&acc)[ACC], const float4* gb, int q) {
  float ss0 = 0.0f, ss1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 p = gb[4 * j + q];
    const float v0 = softplus_fast(fmaf(p.x, acc[4 * j], p.y));
    const float v1 = softplus_fast(fmaf(p.z, acc[4 * j + 1], p.w));
    const float v2 = softplus_fast(fmaf(p.x, acc[4 * j + 2], p.y));
    const float v3 = softplus_fast(fmaf(p.z, acc[4 * j + 3], p.w));
    acc[4 * j] = v0;
    acc[4 * j + 1] = v1;
    acc[4 * j + 2] = v2;
    acc[4 * j + 3] = v3;
    if (NORM) {
      ss0 = fmaf(v0, v0, ss0);
      ss0 = fmaf(v1, v1, ss0);
      ss1 = fmaf(v2, v2, ss1);
      ss1 = fmaf(v3, v3, ss1);
    }
  }
  if (NORM) {
    const float s0 = rsqrtf(fmaxf(quad_sum(ss0), 1e-24f));
    const float s1 = rsqrtf(fmaxf(quad_sum(ss1), 1e-24f));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[4 * j] *= s0;
      acc[4 * j + 1] *= s0;
      acc[4 * j + 2] *= s1;
      acc[4 * j + 3] *= s1;
    }
  }
}

// The three layers for the thread's two rows; on exit acc holds h (float32).
template <int IN, int NH, bool NORM>
__device__ __forceinline__ void trunk(float (&acc)[ACC], const float* __restrict__ x,
                                      long long M, long long r0, unsigned char* smem, int q) {
  using S = Smem<IN, NH>;
  const float4* gb = reinterpret_cast<const float4*>(smem + S::gb);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  first_product<IN>(acc, x, M, r0, reinterpret_cast<const float*>(smem + S::w1), q);
  gate_band<NORM>(acc, gb, q);
  hidden_product(acc, base + S::w2);
  gate_band<NORM>(acc, gb + 64, q);
  hidden_product(acc, base + S::w3);
  gate_band<NORM>(acc, gb + 128, q);
}

// One head over the fragment: lane q of a quad gets, for feature q, the sums
// sum_c bf16(h)[c] * head[q][c] of rows g (o0) and g + 8 (o1); 0 where q >= F.
template <int F>
__device__ __forceinline__ void head(const float (&acc)[ACC], const float* rows, int q,
                                     float& o0, float& o1) {
  const float2* w = reinterpret_cast<const float2*>(rows);
  float s0[F], s1[F];
#pragma unroll
  for (int f = 0; f < F; ++f) s0[f] = s1[f] = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t p0 = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    const uint32_t p1 = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float2 c = w[f * 64 + 4 * j + q];
      s0[f] = fmaf(bf16_lo(p0), c.x, s0[f]);
      s0[f] = fmaf(bf16_hi(p0), c.y, s0[f]);
      s1[f] = fmaf(bf16_lo(p1), c.x, s1[f]);
      s1[f] = fmaf(bf16_hi(p1), c.y, s1[f]);
    }
  }
  o0 = o1 = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float t0 = quad_sum(s0[f]), t1 = quad_sum(s1[f]);
    if (q == f) {
      o0 = t0;
      o1 = t1;
    }
  }
}

// acc <- softplus(acc), in place (the sigma head reads softplus(h)).
__device__ __forceinline__ void softplus_band(float (&acc)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = softplus_fast(acc[i]);
}

// Persistent grid of blocks of `wgs` warpgroups: (resident blocks per SM) x
// (SMs), at most one warpgroup per tile. The kernel gets its dynamic shared
// memory and the largest shared-memory carve-out first.
template <typename K>
inline int configure(K kernel, int wgs, size_t smem, long long tiles, int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128 * wgs, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long g = (long long)per_sm * sms, need = (tiles + wgs - 1) / wgs;
  *grid = (int)(g < need ? g : need);
  return (int)cudaSuccess;
}

}  // namespace mma
}  // namespace upgdm
