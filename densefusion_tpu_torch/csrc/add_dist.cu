// Fused ADD / ADD-S mean distance per pose hypothesis, with the 12
// coefficients of its gradient.
//
// Replaces the Pallas TPU kernels `_paired_kernel` (ADD,
// densefusion_tpu/ops/add_dist.py:116, launched by `_paired_call` at :181)
// and `_min_kernel` (ADD-S, :221, launched by `_min_call` at :334). What
// they compute, not how the TPU blocks it: for sample b, hypothesis n and
// model point m, with q = R_n model_m + t_n,
//
//   paired: c*(m) = target_m
//   min:    c*(m) = target_k, k = argmin_k ||target_k||^2 - 2 q.target_k
//           (ties to the lowest index)
//   diff = q - c*,  d2 = |diff|^2,  d = sqrt(max(d2, EPS))
//   u = diff / d where d2 > EPS, else 0
//   out[b, n] = [sum_m d, A_cj = sum_m u_c model_j (at 1 + 3c + j),
//                s_c = sum_m u_c (at 10 + c)] / M
//
// and out[b, n] = 0 for every n where act[b] == 0. R is (B, N, 3, 3), t
// (B, N, 3), model and target (B, M, 3), act (B,) int32, out (B, N, 13),
// all float32 and allocated by the caller, as is the scratch `partial`.
//
// Design. The model points of a sample are cut into S = ceil(M / M_CHUNK)
// chunks, and each block works on one chunk, so the refiner's shape (N = 1,
// M = 2600) still spreads over S * B blocks. Each block writes its chunk's 13
// sums to partial (S, B, N, 13); a second, deterministic pass adds the S
// partial sums of every row in order, scales by 1/M and zeroes gated rows
// (no float atomics, so a run repeats bit for bit).
//
// * Paired: one thread per hypothesis (blocks of PAIRED_THREADS hypotheses
//   of one sample), the chunk's model and target points staged once in
//   shared memory, the 13 sums in registers.
// * Min: one thread per query (n, m), one block per (chunk, n, b). The query
//   is built in registers; the sample's targets stream through shared
//   memory as float4 {x, y, z, ||r||^2}, as in adds_remap.cu; each thread
//   keeps its best score and winning coordinates. The distance comes from
//   the winning coordinates (not the factored score), and a warp-shuffle
//   plus shared-memory reduction in fixed order sums the 13 values of the
//   block's queries. Padded queries (m >= M) skip the search and add zeros.
//
// Rounding. q, diff, d2, ||r||^2 and the scores are built with __fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc never contracts into FMAs, in the order
// of the plain PyTorch versions (ops/add_dist.py `_transform`, `_dist_coef`,
// ops/knn.py `_scores`). Kernel and plain version therefore pick the same
// nearest target, ties included, and make the same floor decisions; they
// differ only in the order of the sums.
//
// Bound on the H100: arithmetic, fp32 on the CUDA cores (K = 3 is no shape
// for tensor cores). Paired: ~60 operations per (hypothesis, m) pair of an
// active row; at phase 1 (B=32, N=1000, M=500, 24 rows active) ~7.2e8
// operations, ~11 us at 67 TFLOP/s, against ~3.6 MB of traffic (~1 us).
// Min: ~8 operations per (hypothesis, m, k) triple plus ~60 per (hypothesis,
// m); at phase 1 (8 rows active) ~1.6e10, ~0.24 ms.

#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1e-12f;
constexpr int NV = 13;               // values per hypothesis row
constexpr int M_CHUNK = 256;         // model points per block (both kernels)
constexpr int PAIRED_THREADS = 128;  // hypotheses per paired block
constexpr int MIN_THREADS = M_CHUNK; // queries per min block
constexpr int TR = 1024;             // targets per shared-memory tile (16 KB)
constexpr int FIN_THREADS = 256;

// q_c = ((R_c0 x + R_c1 y) + R_c2 z) + t_c, rounded as the plain version.
__device__ __forceinline__ float affine(const float* rc, float tc, float x,
                                        float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(rc[0], x),
                                       __fmul_rn(rc[1], y)),
                             __fmul_rn(rc[2], z)),
                   tc);
}

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

// Adds one model point's terms to the 13 sums.
__device__ __forceinline__ void accumulate(float* acc, float dx, float dy,
                                           float dz, float x, float y,
                                           float z) {
  const float d2 = sq3(dx, dy, dz);
  acc[0] += sqrtf(fmaxf(d2, EPS));
  const float inv = d2 > EPS ? rsqrtf(d2) : 0.f;
  const float u[3] = {dx * inv, dy * inv, dz * inv};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc[1 + 3 * c + 0] += u[c] * x;
    acc[1 + 3 * c + 1] += u[c] * y;
    acc[1 + 3 * c + 2] += u[c] * z;
    acc[10 + c] += u[c];
  }
}

__global__ void __launch_bounds__(PAIRED_THREADS)
paired_partial(const float* __restrict__ R, const float* __restrict__ t,
               const float* __restrict__ model,
               const float* __restrict__ target,
               const int* __restrict__ act, float* __restrict__ partial,
               int N, int M) {
  __shared__ float pts[2 * 3 * M_CHUNK];   // model xyz, then target xyz
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  if (act[b] == 0) return;                 // uniform across the block
  const int m0 = s * M_CHUNK;
  const int cnt = min(M_CHUNK, M - m0);
  const float* mb = model + ((long long)b * M + m0) * 3;
  const float* tb = target + ((long long)b * M + m0) * 3;
  for (int i = threadIdx.x; i < cnt * 3; i += PAIRED_THREADS) {
    pts[i] = mb[i];
    pts[3 * M_CHUNK + i] = tb[i];
  }
  __syncthreads();
  const int n = blockIdx.x * PAIRED_THREADS + threadIdx.x;
  if (n >= N) return;

  const long long row = (long long)b * N + n;
  float r[9], tt[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = R[row * 9 + k];
#pragma unroll
  for (int c = 0; c < 3; ++c) tt[c] = t[row * 3 + c];

  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  for (int i = 0; i < cnt; ++i) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const float* g = pts + 3 * M_CHUNK + 3 * i;
    const float dx = __fsub_rn(affine(r + 0, tt[0], x, y, z), g[0]);
    const float dy = __fsub_rn(affine(r + 3, tt[1], x, y, z), g[1]);
    const float dz = __fsub_rn(affine(r + 6, tt[2], x, y, z), g[2]);
    accumulate(acc, dx, dy, dz, x, y, z);
  }
  float* out = partial + ((long long)s * gridDim.y * N + row) * NV;
#pragma unroll
  for (int k = 0; k < NV; ++k) out[k] = acc[k];
}

__global__ void __launch_bounds__(MIN_THREADS)
min_partial(const float* __restrict__ R, const float* __restrict__ t,
            const float* __restrict__ model,
            const float* __restrict__ target, const int* __restrict__ act,
            float* __restrict__ partial, int N, int M) {
  __shared__ float4 tile[TR];
  __shared__ float red[MIN_THREADS / 32][NV];
  const int s = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  if (act[b] == 0) return;                 // uniform across the block
  const int m = s * M_CHUNK + threadIdx.x;
  const bool live = m < M;
  const long long row = (long long)b * N + n;

  float r[9], tt[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = R[row * 9 + k];
#pragma unroll
  for (int c = 0; c < 3; ++c) tt[c] = t[row * 3 + c];

  float x = 0.f, y = 0.f, z = 0.f;
  if (live) {
    const float* mp = model + ((long long)b * M + m) * 3;
    x = mp[0];
    y = mp[1];
    z = mp[2];
  }
  const float qx = affine(r + 0, tt[0], x, y, z);
  const float qy = affine(r + 3, tt[1], x, y, z);
  const float qz = affine(r + 6, tt[2], x, y, z);

  float best = __int_as_float(0x7f800000);  // +inf
  float bx = 0.f, by = 0.f, bz = 0.f;
  const float* tb = target + (long long)b * M * 3;
  for (int k0 = 0; k0 < M; k0 += TR) {
    const int cnt = min(TR, M - k0);
    for (int i = threadIdx.x; i < cnt; i += MIN_THREADS) {
      const float tx = tb[(long long)(k0 + i) * 3 + 0];
      const float ty = tb[(long long)(k0 + i) * 3 + 1];
      const float tz = tb[(long long)(k0 + i) * 3 + 2];
      tile[i] = make_float4(tx, ty, tz, sq3(tx, ty, tz));
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < cnt; ++i) {
        const float4 c = tile[i];
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, c.x),
                                              __fmul_rn(qy, c.y)),
                                    __fmul_rn(qz, c.z));
        const float sc = __fsub_rn(c.w, __fmul_rn(2.f, dot));
        if (sc < best) {
          best = sc;
          bx = c.x;
          by = c.y;
          bz = c.z;
        }
      }
    }
    __syncthreads();
  }

  float acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  if (live) {
    accumulate(acc, __fsub_rn(qx, bx), __fsub_rn(qy, by), __fsub_rn(qz, bz),
               x, y, z);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < MIN_THREADS / 32; ++w) v += red[w][threadIdx.x];
    partial[((long long)s * gridDim.z * N + row) * NV + threadIdx.x] = v;
  }
}

// out[b, n, k] = act[b] ? (sum_s partial[s, b, n, k]) / M : 0, summing the
// chunks in order.
__global__ void __launch_bounds__(FIN_THREADS)
finalize(const float* __restrict__ partial, const int* __restrict__ act,
         float* __restrict__ out, int B, int N, int S, float inv_m) {
  const long long total = (long long)B * N * NV;
  const long long i = (long long)blockIdx.x * FIN_THREADS + threadIdx.x;
  if (i >= total) return;
  const int b = (int)(i / ((long long)N * NV));
  float v = 0.f;
  if (act[b] != 0) {
    for (int s = 0; s < S; ++s) v += partial[s * total + i];
    v *= inv_m;
  }
  out[i] = v;
}

int finalize_launch(const float* partial, const int* act, float* out, int B,
                    int N, int M, int S, cudaStream_t stream) {
  const long long total = (long long)B * N * NV;
  const unsigned blocks = (unsigned)((total + FIN_THREADS - 1) / FIN_THREADS);
  finalize<<<blocks, FIN_THREADS, 0, stream>>>(partial, act, out, B, N, S,
                                                1.0f / (float)M);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int N, int M, int S) {
  return B < 1 || B > 65535 || N < 1 || N > 65535 || M < 1 ||
         S != (M + M_CHUNK - 1) / M_CHUNK;
}

}  // namespace

// Both launchers run on `stream` (PyTorch's current stream), return
// cudaGetLastError() (cudaErrorInvalidValue for shapes they do not take;
// the Python wrapper checks them first), and need partial to hold
// S * B * N * 13 floats, S = ceil(M / 256).
extern "C" int add_dist_paired_launch(const float* R, const float* t,
                                      const float* model, const float* target,
                                      const int* act, float* partial,
                                      float* out, int B, int N, int M, int S,
                                      void* stream) {
  if (bad_shape(B, N, M, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + PAIRED_THREADS - 1) / PAIRED_THREADS, B, S);
  paired_partial<<<grid, PAIRED_THREADS, 0, st>>>(R, t, model, target, act,
                                                  partial, N, M);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return finalize_launch(partial, act, out, B, N, M, S, st);
}

extern "C" int add_dist_min_launch(const float* R, const float* t,
                                   const float* model, const float* target,
                                   const int* act, float* partial, float* out,
                                   int B, int N, int M, int S, void* stream) {
  if (bad_shape(B, N, M, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(S, N, B);
  min_partial<<<grid, MIN_THREADS, 0, st>>>(R, t, model, target, act,
                                            partial, N, M);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return finalize_launch(partial, act, out, B, N, M, S, st);
}
