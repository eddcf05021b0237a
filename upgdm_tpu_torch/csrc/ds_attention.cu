// De-stationary attention of the NS-Transformer, one launch a call, for
// Hopper (sm_90a).
//
// A port kernel with no Pallas site: the JAX package leaves this attention to
// XLA (upgdm_tpu/models/attention.py::DSAttention). For q [B, L, H, E] and k, v
// [B, S, H, E], read in place in the layout AttentionLayer makes, it writes
// out [B, L, H, E] (contiguous, so [B, L, H E] is a view):
//     s = (q . k) * tau[b] + delta[b, j]      (tau and delta each optional)
//     s = scale * s,  keys after the query left out when causal
//     p = softmax over the row (max, expf, sum, divide)
//     out = sum_j p_j v_j
// in float32 in that order: the plain twin's (ops/kernels/ds_attention.py::
// ds_attention_reference), with the products and sums in another order only.
// The twin fills keys after the query with -1e9 before the scale; their
// weight exp(-1.25e8 - max) is exactly 0, so skipping them changes nothing.
//
// What bounds it. At the NsDiff sweep's calls (B 480, H 8, E 64, L and S 100
// or 150) a (b, h) pair does 4 L S E float32 operations on 4 (L + 2 S) E bytes
// of q, k, v and out: ~4 operations a byte read from device memory against
// the card's ~20 at its float32 rate of 67 TFLOP/s, so it is bound by the
// float32 multiply-adds on the CUDA cores, and the plain path's cost is the
// score tensor [B, H, L, S] it writes and reads six times.
//
// Design. One block of four warps a (b, h) pair. Each warp takes ROWS query
// rows at a time: their queries into its own region, then the scores as a
// register tile of ROWS rows x CE keys a lane (key j = k0 + lane + 32 c),
// each query chunk a broadcast 16-byte load and each key chunk a 16-byte load
// per lane, ROWS x CE x 4 FFMA for ROWS + CE loads. The output is a second
// register tile: a lane owns four of the E outputs of ROWS / (32 / (E / 4))
// rows and takes the weights and V as 16-byte loads, four keys ahead. A
// causal group of rows reads only the keys up to its last row.
//
// Two paths, by the number of keys S:
// * S <= TILE (the sweeps' calls). K and V of the pair are staged whole in
//   shared memory with cp.async (K's 16-byte chunks XOR-swizzled by row, so a
//   quarter warp reading one chunk of 8 consecutive rows hits 32 banks; V's
//   rows past S zeroed). A group's scores are one tile (CE chosen a group, a
//   template up to MAX_COLS); its softmax runs on those registers with warp
//   shuffles, exact and in two passes, and writes the weights over the
//   queries in the warp's region. At E 64 a block holds 68.1 KB at S 100
//   (three blocks an SM) and 98.3 KB at S 150 (two).
// * S > TILE (longer windows and horizons; ds_attention_long_kernel). The
//   scores of a group go tile by tile into score rows of S in the warp's
//   region, beside its queries; the softmax is the same exact two passes, over
//   the row in shared memory. One block an SM, with as many warps (up to
//   MAX_WARPS) as shared memory holds: K and V staged as above where they fit
//   beside MIN_WARPS_STAGED warps' score rows (E 64 up to S ~310), else read
//   from device memory (L2) by the same loads. One warp's score rows bound S:
//   upgdm_ds_attention_max_keys.
//
// Arithmetic: float32 FFMA for the products (no TF32, no bf16); __fmul_rn /
// __fadd_rn keep nvcc from contracting the tau scale and the delta shift into
// one FMA; expf and an IEEE division, no fast-math intrinsic.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace upgdm {
namespace ds_attention {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 8;      // query rows a warp takes at once
constexpr int MAX_COLS = 5;  // keys a lane holds of a row in registers
constexpr int TILE = 32 * MAX_COLS;  // keys of a score tile
constexpr int MIN_BLOCKS = 3;  // blocks an SM holds at S 100, E 64 (shared memory)
constexpr int MAX_WARPS = 8;   // warps a block past TILE keys
constexpr int MIN_WARPS_STAGED = 4;
constexpr int SOFTMAX_UNROLL = 4;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* tau;    // [B, 1] or null (1)
  const float* delta;  // [B, S] or null (0)
  float* out;          // [B, L, H, E] contiguous
  long long qb, ql, qh, kb, ks, kh, vb, vs, vh, tau_b, delta_b;  // strides in floats
  int H, L, S, causal;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The position of 16-byte chunk c of key row j in shared memory.
template <int E>
__device__ __forceinline__ int kchunk(int j, int c) {
  if constexpr (E >= 32) return c ^ (j & 7);
  else return c ^ ((j / (32 / E)) & (E / 4 - 1));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The queries of rows l0 .. l0 + ROWS - 1 of pair (b, h) into Qs [ROWS][E],
// zero past L.
template <int E>
__device__ __forceinline__ void load_queries(const Args& a, int b, int h, int l0, float* Qs,
                                             int lane) {
  constexpr int NC = E / 4;  // 16-byte chunks a row
  const float* qg = a.q + b * a.qb + h * a.qh;
  for (int i = lane; i < ROWS * NC; i += 32) {
    const int r = i / NC, c = i % NC, l = l0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l < a.L) x = __ldg(reinterpret_cast<const float4*>(qg + l * a.ql) + c);
    reinterpret_cast<float4*>(Qs)[i] = x;
  }
  __syncwarp();
}

// The scores of the queries Qs against keys k0 .. k0 + 32 CE - 1, scaled,
// shifted and times the scale, into W[r PS + j] (W may lie over Qs); keys past
// S or after the query (causal) -inf. K is the pair's keys, staged (swizzled
// rows of E) or in device memory (rows a.ks apart); dl[c] is delta of key
// k0 + lane + 32 c.
template <int E, int CE, bool STAGED>
__device__ __forceinline__ void score_tile(const Args& a, int l0, int k0, const float* K,
                                           const float* Qs, float* W, int PS, float tau,
                                           const float (&dl)[MAX_COLS], int lane) {
  constexpr int NC = E / 4;
  float acc[ROWS][CE];
  int jr[CE];
#pragma unroll
  for (int c = 0; c < CE; ++c) jr[c] = min(k0 + lane + 32 * c, a.S - 1);
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < CE; ++c) acc[r][c] = 0.f;
  const float4* Q4 = reinterpret_cast<const float4*>(Qs);
#pragma unroll 2
  for (int ec = 0; ec < NC; ++ec) {
    float4 kk[CE];
#pragma unroll
    for (int c = 0; c < CE; ++c) {
      if constexpr (STAGED)
        kk[c] = reinterpret_cast<const float4*>(K)[jr[c] * NC + kchunk<E>(jr[c], ec)];
      else
        kk[c] = __ldg(reinterpret_cast<const float4*>(K + jr[c] * a.ks) + ec);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 qq = Q4[r * NC + ec];
#pragma unroll
      for (int c = 0; c < CE; ++c) {
        acc[r][c] = fmaf(qq.x, kk[c].x, acc[r][c]);
        acc[r][c] = fmaf(qq.y, kk[c].y, acc[r][c]);
        acc[r][c] = fmaf(qq.z, kk[c].z, acc[r][c]);
        acc[r][c] = fmaf(qq.w, kk[c].w, acc[r][c]);
      }
    }
  }
  __syncwarp();  // every lane has read the queries: the scores may go over them
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < CE; ++c) {
      const int j = k0 + lane + 32 * c;
      const float x = __fadd_rn(__fmul_rn(acc[r][c], tau), dl[c]);
      const bool keep = j < a.S && (!a.causal || j <= l0 + r);
      W[r * PS + j] = keep ? __fmul_rn(a.scale, x) : -INFINITY;
    }
  }
}

// Each row's softmax over keys 0 .. 32 CE - 1 of W, on registers (a lane
// reads back what it wrote).
template <int CE>
__device__ __forceinline__ void softmax_tile(float* W, int PS, int lane) {
#pragma unroll SOFTMAX_UNROLL
  for (int r = 0; r < ROWS; ++r) {
    float s[CE];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < CE; ++c) {
      s[c] = W[r * PS + lane + 32 * c];
      m = fmaxf(m, s[c]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CE; ++c) {
      s[c] = expf(s[c] - m);
      sum += s[c];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < CE; ++c) W[r * PS + lane + 32 * c] = __fdiv_rn(s[c], sum);
  }
}

// The same over keys 0 .. n - 1 of W (n a multiple of 32), in shared memory.
__device__ __forceinline__ void softmax_rows(float* W, int PS, int n, int lane) {
  for (int r = 0; r < ROWS; ++r) {
    float* w = W + r * PS;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, w[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(w[j] - m);
      w[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) w[j] = __fdiv_rn(w[j], sum);
  }
}

// out rows l0 .. = the weights in W (those of keys `keys` up to the next
// multiple of 4 are 0) times V, staged (rows of E, zero past S) or in device
// memory (rows a.vs apart). A lane owns outputs e0 .. e0 + 3 of rows rs,
// rs + RS, ...
template <int E, bool STAGED>
__device__ __forceinline__ void weighted_sum(const Args& a, int b, int h, int l0, const float* V,
                                             const float* W, int PS, int keys, int lane) {
  constexpr int LP = E / 4;    // lanes a row
  constexpr int RS = 32 / LP;  // rows side by side
  constexpr int RL = (ROWS + RS - 1) / RS;
  const int rs = lane / LP, e0 = 4 * (lane % LP);
  float4 o[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int j4 = (keys + 3) & ~3;
  // four keys' values and each row's four weights, loaded a step ahead
  float4 vv[4], pp[RL];
  auto fetch = [&](int j, float4 (&v)[4], float4 (&p)[RL]) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if constexpr (STAGED)
        v[t] = *reinterpret_cast<const float4*>(V + (j + t) * E + e0);
      else
        v[t] = j + t < a.S ? __ldg(reinterpret_cast<const float4*>(V + (j + t) * a.vs + e0))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int r = rs + RS * i;
      p[i] = (ROWS % RS == 0 || r < ROWS) ? *reinterpret_cast<const float4*>(W + r * PS + j)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  fetch(0, vv, pp);
  for (int j = 0; j < j4; j += 4) {
    float4 vn[4], pn[RL];
    fetch(j + 4 < j4 ? j + 4 : j, vn, pn);
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const float pt[4] = {pp[i].x, pp[i].y, pp[i].z, pp[i].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        o[i].x = fmaf(pt[t], vv[t].x, o[i].x);
        o[i].y = fmaf(pt[t], vv[t].y, o[i].y);
        o[i].z = fmaf(pt[t], vv[t].z, o[i].z);
        o[i].w = fmaf(pt[t], vv[t].w, o[i].w);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) vv[t] = vn[t];
#pragma unroll
    for (int i = 0; i < RL; ++i) pp[i] = pn[i];
  }
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int r = rs + RS * i, l = l0 + r;
    if (r < ROWS && l < a.L)
      *reinterpret_cast<float4*>(a.out + (((long long)b * a.L + l) * a.H + h) * E + e0) = o[i];
  }
}

// S <= TILE: rows l0 .. of pair (b, h) against keys 0 .. 32 CE - 1 of the
// staged Ks and Vs. Ws is the warp's region: the queries [ROWS][E], then the
// weights [ROWS][32 CE + 4] over them.
template <int E, int CE>
__device__ __forceinline__ void group(const Args& a, int b, int h, int l0, const float* Ks,
                                      const float* Vs, float* Ws, float tau,
                                      const float (&dl)[MAX_COLS], int lane) {
  constexpr int PS = 32 * CE + 4;  // rows of weights 4 floats apart in the banks
  load_queries<E>(a, b, h, l0, Ws, lane);
  score_tile<E, CE, true>(a, l0, 0, Ks, Ws, Ws, PS, tau, dl, lane);
  softmax_tile<CE>(Ws, PS, lane);
  __syncwarp();
  const int keys = a.causal ? min(a.S, l0 + ROWS) : a.S;
  weighted_sum<E, true>(a, b, h, l0, Vs, Ws, PS, keys, lane);
  __syncwarp();  // the next group's queries go over these weights
}

// S > TILE: the same, tile by tile, into score rows W [ROWS][PS] beside the
// queries Qs; K and V staged or in device memory.
template <int E, bool STAGED>
__device__ __forceinline__ void group_long(const Args& a, int b, int h, int l0, const float* K,
                                           const float* V, float* Qs, float* W, int PS, float tau,
                                           int lane) {
  load_queries<E>(a, b, h, l0, Qs, lane);
  const int keys = a.causal ? min(a.S, l0 + ROWS) : a.S;
  for (int k0 = 0; k0 < keys; k0 += TILE) {
    float dl[MAX_COLS];
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) {
      const int j = k0 + lane + 32 * c;
      dl[c] = (a.delta && j < a.S) ? __ldg(a.delta + b * a.delta_b + j) : 0.f;
    }
    switch ((min(keys - k0, TILE) + 31) / 32) {
      case 1: score_tile<E, 1, STAGED>(a, l0, k0, K, Qs, W, PS, tau, dl, lane); break;
      case 2: score_tile<E, 2, STAGED>(a, l0, k0, K, Qs, W, PS, tau, dl, lane); break;
      case 3: score_tile<E, 3, STAGED>(a, l0, k0, K, Qs, W, PS, tau, dl, lane); break;
      case 4: score_tile<E, 4, STAGED>(a, l0, k0, K, Qs, W, PS, tau, dl, lane); break;
      default: score_tile<E, 5, STAGED>(a, l0, k0, K, Qs, W, PS, tau, dl, lane); break;
    }
  }
  softmax_rows(W, PS, (keys + 31) & ~31, lane);
  __syncwarp();
  weighted_sum<E, STAGED>(a, b, h, l0, V, W, PS, keys, lane);
  __syncwarp();  // the next group's queries and scores go over these
}

// K and V of pair (b, h) into shared memory (K's chunks swizzled, V's rows
// past S zeroed) by the block's `threads` threads.
template <int E>
__device__ __forceinline__ void stage_kv(const Args& a, const float* kg, const float* vg,
                                         float* Ks, float* Vs, int tid, int threads) {
  constexpr int NC = E / 4;
  const int S4 = (a.S + 3) & ~3;
  for (int i = tid; i < a.S * NC; i += threads) {
    const int j = i / NC, c = i % NC;
    cp_async16(Ks + 4 * (j * NC + kchunk<E>(j, c)), kg + j * a.ks + 4 * c);
    cp_async16(Vs + 4 * i, vg + j * a.vs + 4 * c);
  }
  for (int i = a.S * E + tid; i < S4 * E; i += threads) Vs[i] = 0.f;
}

// Group g of the pair's rows for the warp in round i: the groups go to the
// warps back and forth, so that a causal call's longer rows are shared out.
__device__ __forceinline__ int group_of(int i, int warp, int warps) {
  return i * warps + ((i & 1) ? warps - 1 - warp : warp);
}

// S <= TILE: four warps a block.
template <int E>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ds_attention_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int S4 = (a.S + 3) & ~3;
  const int cols = (a.S + 31) / 32;
  const int region = ROWS * max(E, 32 * cols + 4);
  float* Ks = smem;
  float* Vs = Ks + a.S * E;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Ws = Vs + S4 * E + warp * region;

  stage_kv<E>(a, a.k + b * a.kb + h * a.kh, a.v + b * a.vb + h * a.vh, Ks, Vs, tid, THREADS);
  const float tau = a.tau ? a.tau[b * a.tau_b] : 1.f;
  float dl[MAX_COLS];
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    const int j = lane + 32 * c;
    dl[c] = (a.delta && j < a.S) ? a.delta[b * a.delta_b + j] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int groups = (a.L + ROWS - 1) / ROWS;
  for (int i = 0;; ++i) {
    const int g = group_of(i, warp, WARPS);
    if (g >= groups) break;
    const int l0 = g * ROWS;
    const int keys = a.causal ? min(a.S, l0 + ROWS) : a.S;
    switch ((keys + 31) / 32) {
      case 1: group<E, 1>(a, b, h, l0, Ks, Vs, Ws, tau, dl, lane); break;
      case 2: group<E, 2>(a, b, h, l0, Ks, Vs, Ws, tau, dl, lane); break;
      case 3: group<E, 3>(a, b, h, l0, Ks, Vs, Ws, tau, dl, lane); break;
      case 4: group<E, 4>(a, b, h, l0, Ks, Vs, Ws, tau, dl, lane); break;
      default: group<E, 5>(a, b, h, l0, Ks, Vs, Ws, tau, dl, lane); break;
    }
  }
}

// S > TILE: as many warps a block as shared memory holds (up to MAX_WARPS),
// one block an SM; STAGED: K and V in shared memory.
template <int E, bool STAGED>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1) ds_attention_long_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int S4 = (a.S + 3) & ~3;
  const int PS = 32 * ((a.S + 31) / 32) + 4;
  const int region = ROWS * (E + PS);
  float* Ks = smem;
  float* Vs = Ks + a.S * E;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  float* Ws = (STAGED ? Vs + S4 * E : smem) + warp * region;

  const float* kg = a.k + b * a.kb + h * a.kh;
  const float* vg = a.v + b * a.vb + h * a.vh;
  if constexpr (STAGED) {
    stage_kv<E>(a, kg, vg, Ks, Vs, tid, blockDim.x);
    cp_async_wait_all();
    __syncthreads();
  }
  const float tau = a.tau ? a.tau[b * a.tau_b] : 1.f;

  const int groups = (a.L + ROWS - 1) / ROWS;
  for (int i = 0;; ++i) {
    const int g = group_of(i, warp, warps);
    if (g >= groups) break;
    group_long<E, STAGED>(a, b, h, g * ROWS, STAGED ? Ks : kg, STAGED ? Vs : vg, Ws,
                          Ws + ROWS * E, PS, tau, lane);
  }
}

// Shared memory of a launch at S keys: K and V staged, and a warp's region.
size_t kv_bytes(int S, int E) {
  return sizeof(float) * ((size_t)S * E + (size_t)((S + 3) & ~3) * E);
}

size_t warp_bytes(int S, int E) {
  const size_t PS = 32 * (size_t)((S + 31) / 32) + 4;
  return sizeof(float) * ROWS * (S > TILE ? E + PS : (PS > (size_t)E ? PS : E));
}

size_t shared_cap() {
  int dev = 0, cap = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)cap;
}

template <typename Kernel>
int run(Kernel kernel, const Args& a, int B, int warps, size_t bytes, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(B * a.H), 32 * warps, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// S <= TILE: the one-tile kernel. Else K and V staged beside at least
// MIN_WARPS_STAGED warps' score rows where they fit, else read from device
// memory by as many warps as fit.
template <int E>
int launch(const Args& a, int B, cudaStream_t st) {
  const size_t kv = kv_bytes(a.S, E), w = warp_bytes(a.S, E), cap = shared_cap();
  if (a.S <= TILE) return run(ds_attention_kernel<E>, a, B, WARPS, kv + WARPS * w, st);
  if (kv + MIN_WARPS_STAGED * w <= cap) {
    const int warps = (int)std::min<size_t>(MAX_WARPS, (cap - kv) / w);
    return run(ds_attention_long_kernel<E, true>, a, B, warps, kv + warps * w, st);
  }
  const int warps = (int)std::min<size_t>(MAX_WARPS, cap / w);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  return run(ds_attention_long_kernel<E, false>, a, B, warps, warps * w, st);
}

}  // namespace ds_attention
}  // namespace upgdm

// The most keys a call at head width E takes on the current device: one
// warp's score rows in shared memory.
extern "C" int upgdm_ds_attention_max_keys(int E) {
  using namespace upgdm::ds_attention;
  const size_t cap = shared_cap();
  int S = TILE;
  while (warp_bytes(S + 32, E) <= cap) S += 32;
  return S;
}

// C interface (ctypes). q [B, L, H, E], k and v [B, S, H, E] float32 on the
// device, each with a unit last stride, 16-byte aligned rows and strides
// (strides[0..8]: q's, k's and v's strides of b, position and h, in floats);
// tau [B, 1] (stride strides[9] over b) and delta [B, S] (strides[10] over b,
// unit over S) may be null; out [B, L, H, E] contiguous. E is 8, 16, 32 or 64
// and 1 <= S <= upgdm_ds_attention_max_keys(E). Returns cudaGetLastError()
// after the launch.
extern "C" int upgdm_ds_attention(const float* q, const float* k, const float* v,
                                  const float* tau, const float* delta, float* out,
                                  const long long* strides, int B, int H, int L, int S, int E,
                                  int causal, float scale, void* stream) {
  using namespace upgdm::ds_attention;
  if (B < 1 || H < 1 || L < 1 || S < 1 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, tau, delta, out,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10],
         H, L, S, causal ? 1 : 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E == 64) return launch<64>(a, B, st);
  if (E == 32) return launch<32>(a, B, st);
  if (E == 16) return launch<16>(a, B, st);
  if (E == 8) return launch<8>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
