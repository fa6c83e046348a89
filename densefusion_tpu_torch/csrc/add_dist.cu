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
// all float32 and allocated by the caller, as is the min kernel's scratch
// `partial`.
//
// Design. Neither kernel uses float atomics: every sum is taken in a fixed
// order, so a run repeats bit for bit.
//
// * Paired: one launch. A block of PAIRED_THREADS threads owns a tile of
//   hypotheses of one row over all M model points: its threads form teams
//   of P, each team holds HT hypotheses (HT = 2 where N allows, so one
//   staged point serves two independent chains), and a team's P threads
//   split the model points between them (thread j takes m = j, j + P, ...).
//   The block stages PAIRED_TILE model and target points at a time in
//   shared memory as float4, one broadcast load per point. A team's 13 * HT
//   sums merge by a warp butterfly over its lanes and, where a team spans
//   warps, in shared memory in warp order; then they are scaled by 1/M and
//   written to out. Blocks of gated rows write their zeros and return.
//   `nn_scan::paired_split` picks P from (B, N): one thread per hypothesis
//   where the rows alone fill the card, a whole block per hypothesis at the
//   refiner's N = 1. P is a template parameter, so a thread's point stride
//   is a constant and its loop, unrolled PAIRED_UNROLL times, reads shared
//   memory at immediate offsets: ~47.6 lane instructions per (hypothesis,
//   point) pair at phase 1 (cuobjdump -sass, examples/gpu_scan_turns.py),
//   of which the pinned q takes 21 and the 13 sums 15. ptxas takes 80
//   registers, so three blocks fit on an SM. Slower on the H100 in scratch
//   builds: a runtime stride; the registers held to 64 for four blocks per
//   SM (it spills); one hypothesis per thread; blocks of 128 threads; IEEE
//   division by M in place of the scaling. The first design (one thread per
//   hypothesis, M cut into 256-point chunks whose partial sums a second
//   kernel added) ran at 5.0x its bound at phase 1 and ~59x at the refiner,
//   where 24 threads each walked 256 points in a dependent chain.
// * Min: the M model points of a sample are cut into chunks, and each
//   chunk's 13 sums go to partial (S, B, N, 13), S = ceil(M / chunk); a
//   second pass (`finalize`) adds the S partial sums of every row in order,
//   scales by 1/M and zeroes gated rows. The chunk's sums come from the
//   nearest-neighbour scan of csrc/nn_scan.cuh. A work item is a
//   (row b, hypothesis n, chunk of MIN_CHUNK = 128 model points); one warp
//   builds the item's 128 queries q = R_n model_m + t_n, 4 per lane, in
//   registers, and scans the sample's targets, staged in shared memory as
//   float4 {x, y, z, ||r||^2}, keeping per query the best score and the
//   group of 8 targets that holds it, then finds the first target of that
//   group with that score: exactly the strict-< scan's winner. Where the
//   items are too few to fill the card (the refiner's N = 1, M = 2600), S
//   warps share an item, each scanning every S-th group of targets, and
//   merge their winners exactly (nn_scan.cuh). Only then are the winner's coordinates
//   read, once per query, and the distance built from them (not from the
//   factored score); a lane adds its 4 queries' terms in order and a warp
//   butterfly of fixed order sums the item's 13 values.
//   The grid is persistent (as many blocks as fit on the card at once).
//   Blocks walk groups of 8 / S consecutive items of the active rows only
//   (act[b] != 0, found by warp ballots over `act`), stepping by the grid
//   size: gated rows cost no blocks, the live work lands on the first
//   blocks wherever the active rows lie in the batch, and the host never
//   reads `act`.
//
// Rounding. q, diff, d2, ||r||^2 and the scores are built with __fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc never contracts into FMAs, in the order
// of the plain PyTorch versions (ops/add_dist.py `_transform`, `_dist_coef`,
// ops/knn.py `_scores`). Kernel and plain version therefore pick the same
// nearest target, ties included, and make the same floor decisions (d2 >
// EPS), so at the pose the coefficients are exactly 0; they differ only in
// the order of the sums and, in the paired kernel, in d = d2f * rsqrt(d2f)
// from the approximate reciprocal square root (a few ulp from the IEEE
// sqrtf, held at rtol 1e-5). FMAs are used in the 13 accumulations only.
// Why no FMAs in q and no tensor cores: csrc/nn_scan.cuh. An FMA-chained q
// would save 9 of the paired kernel's ~47.6 lane instructions per
// (hypothesis, point) pair.
//
// Bound on the H100: arithmetic, fp32 on the CUDA cores (K = 3 is no shape
// for tensor cores). Paired: ~60 operations per (hypothesis, m) pair of an
// active row; at phase 1 (B=32, N=1000, M=500, 24 rows active) ~7.2e8
// operations, ~11 us at 67 TFLOP/s, against ~3.6 MB of traffic (~1 us).
// Min: ~8 operations per (hypothesis, m, k) triple plus ~60 per (hypothesis,
// m); at phase 1 (8 rows active) ~1.6e10, ~0.24 ms. The pinned score and
// the group minimum cost ~8 lane instructions per triple, so the min
// kernel's floor is ~2x its bound; the first design (one query per thread,
// one block per 256 points of every row, gated or not, coordinates
// selected per triple) ran at 4.5x at phase 1 and 12-16x at the refiner
// shape, where its 88 live blocks left most SMs idle.

#include <cuda_runtime.h>

#include "nn_scan.cuh"

namespace {

constexpr float EPS = 1e-12f;
constexpr int NV = 13;               // values per hypothesis row
constexpr int PAIRED_THREADS = 256;  // threads per paired block
constexpr int PAIRED_TILE = 1024;    // model points staged at a time (32 KB)
constexpr int PAIRED_UNROLL = 4;     // points per turn of a thread's loop
constexpr int MIN_CHUNK = nn_scan::SLOT;  // model points per min work item
// Min blocks per SM that the compiler must fit (__launch_bounds__). Told
// three, ptxas may give the kernel up to 85 registers and takes 78-79;
// left to itself it packs the kernel into 64 for four blocks per SM, and
// its scan then ran 4% slower at phase 1 on the H100, even with the grid
// held to three blocks per SM (examples/gpu_scan_turns.py).
constexpr int MIN_BLOCKS_PER_SM = 3;
constexpr int FIN_THREADS = 256;

using nn_scan::sq3;

// q_c = ((R_c0 x + R_c1 y) + R_c2 z) + t_c, rounded as the plain version.
__device__ __forceinline__ float affine(const float* rc, float tc, float x,
                                        float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(rc[0], x),
                                       __fmul_rn(rc[1], y)),
                             __fmul_rn(rc[2], z)),
                   tc);
}

// 1 / sqrt(x) for a normal x (here x >= EPS): the approximate reciprocal
// square root with denormals flushed, which spares the scaling that
// rsqrtf wraps around it for denormal inputs.
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Adds one model point's terms to the 13 sums. kRsqrtDist takes the
// distance as d2f * rsqrt(d2f), from the reciprocal square root that u
// needs (the paired kernel's inner loop); otherwise it is the IEEE sqrtf
// (the min kernel, which adds one term per query after its scan).
template <bool kRsqrtDist>
__device__ __forceinline__ void accumulate(float* acc, float dx, float dy,
                                           float dz, float x, float y,
                                           float z) {
  const float d2 = sq3(dx, dy, dz);
  float inv;
  if constexpr (kRsqrtDist) {
    const float d2f = fmaxf(d2, EPS);
    const float rs = rsqrt_normal(d2f);
    acc[0] += d2f * rs;
    inv = d2 > EPS ? rs : 0.f;
  } else {
    acc[0] += sqrtf(fmaxf(d2, EPS));
    inv = d2 > EPS ? rsqrtf(d2) : 0.f;
  }
  const float u[3] = {dx * inv, dy * inv, dz * inv};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc[1 + 3 * c + 0] += u[c] * x;
    acc[1 + 3 * c + 1] += u[c] * y;
    acc[1 + 3 * c + 2] += u[c] * z;
    acc[10 + c] += u[c];
  }
}

// The paired kernel: a block owns hypotheses [n0, n0 + teams * HT) of row
// b = blockIdx.y, n0 = blockIdx.x * teams * HT; team k of P threads holds
// hypotheses n0 + k * HT + h, h < HT. Every thread reaches the merge
// (threads of hypotheses past N compute on zeros and write nothing).
template <int P, int HT>
__global__ void __launch_bounds__(PAIRED_THREADS)
paired_dist(const float* __restrict__ R, const float* __restrict__ t,
            const float* __restrict__ model,
            const float* __restrict__ target, const int* __restrict__ act,
            float* __restrict__ out, int N, int M) {
  using nn_scan::WARP;
  constexpr int teams = PAIRED_THREADS / P;
  __shared__ float4 mdl[PAIRED_TILE];
  __shared__ float4 tgt[PAIRED_TILE];
  __shared__ float red[PAIRED_THREADS / WARP][HT * NV];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * teams * HT;
  const int nb = min(teams * HT, N - n0);      // hypotheses of this block
  float* ob = out + ((long long)b * N + n0) * NV;
  if (act[b] == 0) {                           // uniform across the block
    for (int i = threadIdx.x; i < nb * NV; i += PAIRED_THREADS) ob[i] = 0.f;
    return;
  }
  const int team = threadIdx.x / P, j = threadIdx.x % P;

  float r[HT][9], tt[HT][3], acc[HT][NV];
#pragma unroll
  for (int h = 0; h < HT; ++h) {
    const int n = team * HT + h;
    const long long row = (long long)b * N + n0 + n;
#pragma unroll
    for (int k = 0; k < 9; ++k) r[h][k] = n < nb ? R[row * 9 + k] : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) tt[h][c] = n < nb ? t[row * 3 + c] : 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[h][k] = 0.f;
  }

  const float* mb = model + (long long)b * M * 3;
  const float* tb = target + (long long)b * M * 3;
  for (int m0 = 0; m0 < M; m0 += PAIRED_TILE) {
    const int cnt = min(PAIRED_TILE, M - m0);
    if (m0 > 0) __syncthreads();               // the last tile is read
    for (int i = threadIdx.x; i < cnt; i += PAIRED_THREADS) {
      const float* p = mb + (long long)(m0 + i) * 3;
      const float* g = tb + (long long)(m0 + i) * 3;
      mdl[i] = make_float4(p[0], p[1], p[2], 0.f);
      tgt[i] = make_float4(g[0], g[1], g[2], 0.f);
    }
    __syncthreads();
#pragma unroll PAIRED_UNROLL
    for (int i = j; i < cnt; i += P) {
      const float4 x = mdl[i], g = tgt[i];
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const float dx = __fsub_rn(affine(r[h] + 0, tt[h][0], x.x, x.y, x.z),
                                   g.x);
        const float dy = __fsub_rn(affine(r[h] + 3, tt[h][1], x.x, x.y, x.z),
                                   g.y);
        const float dz = __fsub_rn(affine(r[h] + 6, tt[h][2], x.x, x.y, x.z),
                                   g.z);
        accumulate<true>(acc[h], dx, dy, dz, x.x, x.y, x.z);
      }
    }
  }

  // Merge the team's sums: a butterfly over its lanes in each warp (every
  // lane ends with the same bits), then, where the team spans warps, the
  // warps' sums in warp order.
#pragma unroll
  for (int off = 1; off < (P < WARP ? P : WARP); off <<= 1) {
#pragma unroll
    for (int h = 0; h < HT; ++h) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
        acc[h][k] += __shfl_xor_sync(0xffffffffu, acc[h][k], off);
    }
  }
  const float inv_m = 1.f / (float)M;
  if constexpr (P <= WARP) {
    if (j == 0) {
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const int n = team * HT + h;
        if (n < nb) {
#pragma unroll
          for (int k = 0; k < NV; ++k) ob[n * NV + k] = acc[h][k] * inv_m;
        }
      }
    }
  } else {
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < HT; ++h) {
#pragma unroll
        for (int k = 0; k < NV; ++k) red[warp][h * NV + k] = acc[h][k];
      }
    }
    __syncthreads();
    constexpr int per_team = P / WARP;         // warps per team
    if (warp % per_team == 0 && lane < HT * NV) {
      float v = red[warp][lane];
#pragma unroll
      for (int w = 1; w < per_team; ++w) v += red[warp + w][lane];
      const int n = team * HT + lane / NV;
      if (n < nb) ob[n * NV + lane % NV] = v * inv_m;
    }
  }
}

struct Active {
  int row;     // the r-th active row (0-based), if there is one
  int count;   // active rows before it (all of them if r >= that count)
};

// The r-th row with act[row] != 0, by ballots over `act` (B rows); every
// lane of the warp takes part and gets the same answer.
__device__ __forceinline__ Active nth_active(const int* act, int B, int r,
                                             int lane) {
  int count = 0;
  for (int b0 = 0; b0 < B; b0 += nn_scan::WARP) {
    const unsigned m = __ballot_sync(
        0xffffffffu, b0 + lane < B && act[b0 + lane] != 0);
    const int c = __popc(m);
    if (r - count < c) return {b0 + (int)__fns(m, 0, r - count + 1), r};
    count += c;
  }
  return {0, count};
}

template <int S>
__global__ void __launch_bounds__(nn_scan::THREADS, MIN_BLOCKS_PER_SM)
min_partial(const float* __restrict__ R, const float* __restrict__ t,
            const float* __restrict__ model,
            const float* __restrict__ target, const int* __restrict__ act,
            float* __restrict__ partial, int B, int N, int M, int C) {
  using nn_scan::QT;
  using nn_scan::WARP;
  constexpr int SLOTS = nn_scan::WARPS / S;   // items per group
  __shared__ float4 tile[nn_scan::TILE];
  __shared__ nn_scan::MergeBuf<S> buf;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int seg = warp % S;
  const long long items = (long long)N * C;   // per row
  const long long per_row = (items + SLOTS - 1) / SLOTS;

  // The blocks walk only the active rows' groups (each warp counts and
  // finds the active rows by ballots over `act`), so the live work goes to
  // the first blocks wherever the active rows lie in the batch.
  const long long groups = per_row * nth_active(act, B, B, lane).count;

  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const int b = nth_active(act, B, (int)(g / per_row), lane).row;
    const long long k = (g % per_row) * SLOTS + warp / S;
    const bool live = k < items;             // uniform across the warp
    const int n = live ? (int)(k / C) : 0;
    const int c = live ? (int)(k % C) : 0;
    const long long row = (long long)b * N + n;

    // this lane's query j is model point m0 + j * WARP
    const int m0 = c * MIN_CHUNK + lane;
    float mp[QT][3];
    nn_scan::Lane l;
    l.reset();
    {
      float r[9], tt[3];
#pragma unroll
      for (int i = 0; i < 9; ++i) r[i] = live ? R[row * 9 + i] : 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) tt[i] = live ? t[row * 3 + i] : 0.f;
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const int m = m0 + j * WARP;
        const float* p = model + ((long long)b * M + m) * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          mp[j][i] = live && m < M ? p[i] : 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          l.q[j][i] = affine(r + 3 * i, tt[i], mp[j][0], mp[j][1], mp[j][2]);
      }
    }

    const float* tb = target + (long long)b * M * 3;
    for (int t0 = 0; t0 < M; t0 += nn_scan::TR) {
      const int cnt = min(nn_scan::TR, M - t0);
      nn_scan::stage(tile, tb, t0, cnt);
      __syncthreads();
      if (live) l.scan<S>(tile, cnt, t0, seg);
      __syncthreads();
    }
    nn_scan::merge<S>(buf, l, warp, seg, lane);
    if (seg == 0 && live) {
      l.resolve(tile, tb, M);
      float acc[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] = 0.f;
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        if (m0 + j * WARP < M) {
          const float* w = tb + (long long)l.idx[j] * 3;
          accumulate<false>(acc, __fsub_rn(l.q[j][0], w[0]),
                            __fsub_rn(l.q[j][1], w[1]),
                            __fsub_rn(l.q[j][2], w[2]), mp[j][0], mp[j][1],
                            mp[j][2]);
        }
      }
      float* out = partial + ((long long)c * B * N + row) * NV;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float v = acc[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);   // equal on every lane
        if (lane == i) out[i] = v;
      }
    }
    __syncthreads();   // the tile and the merge buffer are free again
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

// The min kernel's persistent grid for split S: as many blocks as fit on
// the card at once (the occupancy read once per process), or fewer where
// the groups of all rows are fewer.
template <int S>
int min_launch_split(const float* R, const float* t, const float* model,
                     const float* target, const int* act, float* partial,
                     int B, int N, int M, int C, cudaStream_t stream) {
  static const long long full = [] {
    int per_sm = 0;   // blocks resident on one SM
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, min_partial<S>,
                                                  nn_scan::THREADS, 0);
    return (long long)nn_scan::sm_count() * (per_sm > 0 ? per_sm : 1);
  }();
  const long long slots = nn_scan::WARPS / S;
  const long long groups = (long long)B * (((long long)N * C + slots - 1)
                                           / slots);
  const unsigned grid = (unsigned)(groups < full ? groups : full);
  min_partial<S><<<grid, nn_scan::THREADS, 0, stream>>>(
      R, t, model, target, act, partial, B, N, M, C);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int N, int M) {
  return B < 1 || B > 65535 || N < 1 || N > 65535 || M < 1;
}

}  // namespace

// The launchers run on `stream` (PyTorch's current stream) and return
// cudaGetLastError() (cudaErrorInvalidValue for shapes they do not take;
// the Python wrapper checks them first).

// The paired kernel: one launch that writes out, with no scratch.
extern "C" int add_dist_paired_launch(const float* R, const float* t,
                                      const float* model, const float* target,
                                      const int* act, float* out, int B,
                                      int N, int M, void* stream) {
  if (bad_shape(B, N, M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int ht = 1;
  const int split = nn_scan::paired_split(B, N, PAIRED_THREADS, &ht);
  return nn_scan::dispatch<PAIRED_THREADS>(split, [&](auto p) {
    constexpr int P = decltype(p)::value;
    const int per_block = PAIRED_THREADS / P * ht;
    const dim3 grid((N + per_block - 1) / per_block, B);
    if (ht == 2)
      paired_dist<P, 2><<<grid, PAIRED_THREADS, 0, st>>>(R, t, model, target,
                                                         act, out, N, M);
    else
      paired_dist<P, 1><<<grid, PAIRED_THREADS, 0, st>>>(R, t, model, target,
                                                         act, out, N, M);
    return static_cast<int>(cudaGetLastError());
  });
}

// The paired kernel's split for B rows of N hypotheses: returns the threads
// that share one hypothesis and sets *hyps_per_thread.
extern "C" int add_dist_paired_split(int B, int N, int* hyps_per_thread) {
  return nn_scan::paired_split(B, N, PAIRED_THREADS, hyps_per_thread);
}

// The min kernel: its partial sums, then `finalize`; partial must hold
// S * B * N * 13 floats, S = ceil(M / 128).
extern "C" int add_dist_min_launch(const float* R, const float* t,
                                   const float* model, const float* target,
                                   const int* act, float* partial, float* out,
                                   int B, int N, int M, int S, void* stream) {
  if (bad_shape(B, N, M) || S != (M + MIN_CHUNK - 1) / MIN_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = nn_scan::dispatch(
      nn_scan::min_split(B, N, M), [&](auto split) {
        return min_launch_split<decltype(split)::value>(
            R, t, model, target, act, partial, B, N, M, S, st);
      });
  if (err != 0) return err;
  const long long total = (long long)B * N * NV;
  const unsigned blocks = (unsigned)((total + FIN_THREADS - 1) / FIN_THREADS);
  finalize<<<blocks, FIN_THREADS, 0, st>>>(partial, act, out, B, N, S,
                                           1.0f / (float)M);
  return static_cast<int>(cudaGetLastError());
}
