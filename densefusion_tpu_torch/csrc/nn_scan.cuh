// The nearest-neighbour scan shared by csrc/nn.cu (1-NN search, TPU kernels
// 3 and 4), csrc/adds_remap.cu (ADD-S remap, TPU kernel 5) and
// csrc/add_dist.cu (ADD-S min distance, TPU kernel 2): for a set of queries
// q, the (score, index) of the reference r that minimises
//
//   s(q, r) = ||r||^2 - 2 q.r,   ties to the lowest index,
//
// with every score rounded exactly as the plain PyTorch version rounds it
// (ops/knn.py `_scores`): rsq = (x*x + y*y) + z*z, dot = (qx*rx + qy*ry) +
// qz*rz, s = rsq - 2*dot, each step one __fmul_rn / __fadd_rn / __fsub_rn.
// nvcc never contracts those into FMAs, so kernel and plain version agree
// bit for bit, ties included.
//
// How a block scans. A warp holds QT queries per lane in registers (a
// "slot" of 32 * QT queries) and walks a tile of the reference cloud
// staged in shared memory as float4 {x, y, z, ||r||^2}: each broadcast
// 16-byte load serves QT queries. The refs come in groups of G = 8: within
// a group a query keeps only the minimum score (one FMNMX per pair), and
// only the group's minimum is compared with the running best (strictly
// smaller wins), selecting the score and the group's number. After the scan
// the winning group is scanned once more for the first ref whose score
// equals the best: that is the first minimum over all refs, exactly what
// one ascending scan with a strict < keeps, and its score is reported.
// So a pair costs ~8 lane instructions (5 for the dot, 2 for the score, 1
// min) where a per-pair compare, select score, select index cost ~10. A
// NaN score never wins (fminf drops it, < is false), as in a strict-< scan.
// Where the grid would be too small to fill the card, S warps share one
// slot: warp `seg` of the slot scans groups seg, seg + S, ... of each tile,
// and the S partial winners merge in shared memory with the order of
// `beats`: the smaller score wins, an equal score goes to the lower group.
// Each warp's winner is the first minimal group among its own groups, so
// the merge gives the first minimal group overall, whatever S. The resolve
// is short but latency-bound where the slot's first warp does it alone
// after the merge (S > 1): there the search kernels read a whole group
// before comparing (`resolve_alone`). Each group of staged refs is
// followed by one unused float4, so that the 32 lanes' reads of 32
// different winning groups do not all fall on one shared-memory bank.
//
// Not taken, and why:
// * FMAs. An FMA-chained score picks another nearest ref than the pinned
//   score for a few queries in 20,000 at the ADD-S geometry
//   (examples/fma_parity.py), which would end bit parity with the plain
//   versions; keeping it would need the plain version to emulate a float32
//   FMA exactly, a second definition in float64. So the score stays
//   pinned, and the floor is ~8 lane instructions per pair.
// * Tensor cores. K = 3; after register tiling the pinned score's seven
//   rounded steps and the min set the floor, not the dot, and a TF32 or 3xTF32 product of (-2q, 1) and
//   (r, ||r||^2) would round differently from the plain version.
// * cp.async / TMA staging, or a tile that holds a whole 2600-point cloud.
//   A tile is 18 KB and its copy a few percent of the scan at the driven
//   shapes; staging the refiner's whole cloud at once (41.6 KB of dynamic
//   shared memory) bought nothing there and cost ~5% at phase 1.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace nn_scan {

constexpr int QT = 4;                // queries per lane
constexpr int WARP = 32;
constexpr int SLOT = WARP * QT;      // queries per slot (one warp's worth)
constexpr int WARPS = 8;             // warps per block
constexpr int THREADS = WARP * WARPS;
constexpr int G = 8;                 // refs per group
constexpr int TR = 1024;             // refs per staged tile, G | TR
constexpr int TILE = TR / G * (G + 1);   // its float4 positions (18 KB)

// The SM count of the device current at the first call, read once per
// process. A card with another count only gets another split or persistent
// grid size, never another result.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

// Warps per slot: the least S in {1, 2, 4, 8} at which `rows` rows of
// `slots` slots each, WARPS / S slots to a block, give at least `per_sm`
// blocks per SM, while each warp keeps at least 32 of the `refs` refs.
inline int split(long long rows, long long slots, long long refs,
                 int per_sm) {
  const long long want = (long long)per_sm * sm_count();
  int s = 1;
  while (s < WARPS && refs >= 64LL * s) {
    const long long per_block = WARPS / s;
    if (rows * ((slots + per_block - 1) / per_block) >= want) break;
    s *= 2;
  }
  return s;
}

// The 1-NN search (nn.cu): B samples of Q queries against R refs, at least
// two blocks per SM.
inline int nn_split(int B, long long Q, int R) {
  return split(B, (Q + SLOT - 1) / SLOT, R, 2);
}

// The ADD-S min kernel (add_dist.cu): B rows of N hypotheses, each cut into
// slots of SLOT model points, against M targets. The host never reads
// which rows are active, and about a quarter of them are in training, so
// it asks for four blocks' worth per SM over all rows.
inline int min_split(int B, int N, int M) {
  return split(B, (long long)N * ((M + SLOT - 1) / SLOT), M, 4);
}

// The paired (ADD) distance kernel (add_dist.cu), which needs no scan but
// fills the card by the same measure: B rows of N hypotheses on blocks of
// `threads` threads. Returns P, the threads that share one hypothesis and
// split its model points: the least power of two at which the grid has at
// least two blocks per SM, at most `threads` (a whole block on one
// hypothesis, as at the refiner's N = 1). Sets *ht to the hypotheses a
// thread carries: 2 where N fills the block's teams twice over, else 1.
inline int paired_split(int B, int N, int threads, int* ht) {
  const long long want = 2LL * sm_count();
  for (int p = 1;; p *= 2) {
    const int teams = threads / p;
    *ht = N >= 2 * teams ? 2 : 1;
    const long long per_block = (long long)teams * *ht;
    if (p >= threads || B * ((N + per_block - 1) / per_block) >= want)
      return p;
  }
}

// Returns launch(std::integral_constant<int, S>{}) for the split S = s, a
// power of two up to MAX (the scan's WARPS by default).
template <int MAX = WARPS, int V = 1, class F>
int dispatch(int s, F&& launch) {
  if constexpr (V >= MAX) {
    return launch(std::integral_constant<int, V>{});
  } else {
    if (s <= V) return launch(std::integral_constant<int, V>{});
    return dispatch<MAX, 2 * V>(s, launch);
  }
}

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

// The float4 position in a tile of its ref r: each group of G refs is
// followed by one unused position. The resolve reads, in each lane, a ref of
// that lane's own winning group; unpadded, every group would start on the
// same shared-memory bank, and those reads would conflict 32 ways.
__device__ __forceinline__ int pos(int r) { return r + r / G; }

__device__ __forceinline__ float4 staged(const float* p) {
  const float x = p[0], y = p[1], z = p[2];
  return make_float4(x, y, z, sq3(x, y, z));
}

// The pinned score ||r||^2 - 2 q.r of a staged ref r = {x, y, z, ||r||^2}.
__device__ __forceinline__ float score(const float* q, float4 r) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(q[0], r.x),
                                        __fmul_rn(q[1], r.y)),
                              __fmul_rn(q[2], r.z));
  return __fsub_rn(r.w, __fmul_rn(2.f, dot));
}

// (s, g) comes before (s2, g2) in the order of one ascending strict-< scan.
__device__ __forceinline__ bool beats(float s, int g, float s2, int g2) {
  return s < s2 || (s == s2 && g < g2);
}

// Stages refs [t0, t0 + n) of the cloud `rb` (R, 3) into `tile` (ref i at
// pos(i)) with all THREADS threads of the block, and pads the last group
// with refs whose score is +inf (||r||^2 = +inf), which never win.
__device__ __forceinline__ void stage(float4* tile, const float* rb, int t0,
                                      int n) {
  const int padded = (n + G - 1) / G * G;
  for (int i = threadIdx.x; i < padded; i += THREADS)
    tile[pos(i)] = i < n ? staged(rb + (long long)(t0 + i) * 3)
                          : make_float4(0.f, 0.f, 0.f,
                                        __int_as_float(0x7f800000));
}

// Per lane: QT queries, their running best scores and groups; after
// `resolve`, `idx` holds each query's nearest ref and `best` its score.
struct Lane {
  float q[QT][3];
  float best[QT];
  int grp[QT];
  int idx[QT];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      best[j] = __int_as_float(0x7f800000);   // +inf
      grp[j] = 0;
    }
  }

  // Groups seg, seg + S, ... of a staged tile whose first ref is t0.
  template <int S>
  __device__ __forceinline__ void scan(const float4* tile, int n, int t0,
                                       int seg) {
    const int groups = (n + G - 1) / G;
    for (int g = seg; g < groups; g += S) {
      const float4* p = tile + g * (G + 1);
      float m[QT];
      const float4 r0 = p[0];
#pragma unroll
      for (int j = 0; j < QT; ++j) m[j] = score(q[j], r0);
#pragma unroll
      for (int i = 1; i < G; ++i) {
        const float4 r = p[i];
#pragma unroll
        for (int j = 0; j < QT; ++j) m[j] = fminf(m[j], score(q[j], r));
      }
      const int gg = t0 / G + g;
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        if (m[j] < best[j]) {
          best[j] = m[j];
          grp[j] = gg;
        }
      }
    }
  }

  // The first ref of each query's winning group whose score equals the
  // best, from `tile` when it holds the whole cloud (R <= TR), else from
  // the cloud `rb` (R, 3) in global memory. With no such ref (every score
  // +inf or NaN) the group's first ref stands, with the best score.
  __device__ __forceinline__ void resolve(const float4* tile, const float* rb,
                                          int R) {
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const int base = grp[j] * G;
      int k = base;
      float sk = best[j];
#pragma unroll
      for (int i = G - 1; i >= 0; --i) {
        const int r = base + i;
        if (r < R) {
          const float s = score(q[j], R <= TR ? tile[pos(r)]
                                              : staged(rb + (long long)r * 3));
          if (s == best[j]) {
            k = r;
            sk = s;
          }
        }
      }
      idx[j] = k;
      best[j] = sk;
    }
  }

  // `resolve` for a warp that resolves its slot alone, after the merge
  // (S > 1 in the search kernels): a group's G refs are all read and scored
  // before any is compared, with no branch between them, so that their
  // loads overlap; a compare and branch per ref left the warp waiting out
  // each load in turn. Where every warp resolves a slot of its own (S = 1)
  // the loads of many warps overlap anyway, and `resolve`'s fewer registers
  // leave room for more blocks; the min kernel, held to 85 registers for
  // three blocks per SM, keeps `resolve` too.
  __device__ __forceinline__ void resolve_alone(const float4* tile,
                                                const float* rb, int R) {
    if (R <= TR)
      resolve_from(R, [&](int r) { return tile[pos(r)]; });
    else
      resolve_from(R, [&](int r) {
        return staged(rb + (long long)min(r, R - 1) * 3);
      });
  }

  // `resolve_alone` with the staged ref r from `ref(r)`, which must be
  // readable up to the end of r's group.
  template <class F>
  __device__ __forceinline__ void resolve_from(int R, F ref) {
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const int base = grp[j] * G;
      float s[G];
#pragma unroll
      for (int i = 0; i < G; ++i) s[i] = score(q[j], ref(base + i));
      int k = base;
      float sk = best[j];
#pragma unroll
      for (int i = G - 1; i >= 0; --i) {
        if (base + i < R && s[i] == best[j]) {
          k = base + i;
          sk = s[i];
        }
      }
      idx[j] = k;
      best[j] = sk;
    }
  }
};

// Winners of the S warps of each slot, for the merge.
template <int S>
struct MergeBuf {
  float s[WARPS][QT][WARP];
  int g[WARPS][QT][WARP];
};
template <>
struct MergeBuf<1> {};

// Merges the S partial winners of each slot into the lanes of the slot's
// first warp (seg 0). Every thread of the block calls it (it synchronises).
template <int S>
__device__ __forceinline__ void merge(MergeBuf<S>& buf, Lane& l, int warp,
                                      int seg, int lane) {
  if constexpr (S > 1) {
    if (seg != 0) {
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        buf.s[warp][j][lane] = l.best[j];
        buf.g[warp][j][lane] = l.grp[j];
      }
    }
    __syncthreads();
    if (seg == 0) {
#pragma unroll
      for (int k = 1; k < S; ++k) {
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          const float s = buf.s[warp + k][j][lane];
          const int g = buf.g[warp + k][j][lane];
          if (beats(s, g, l.best[j], l.grp[j])) {
            l.best[j] = s;
            l.grp[j] = g;
          }
        }
      }
    }
  }
}

// The grid of a search kernel (nn.cu, adds_remap.cu) at split S: blocks of
// WARPS / S slots of one sample's queries along x, the B samples along y.
template <int S>
inline dim3 search_grid(int B, long long Q) {
  const long long per_block = SLOT * (WARPS / S);
  return dim3((unsigned)((Q + per_block - 1) / per_block), B);
}

// The first of this lane's QT queries in the block of `search_grid<S>`: its
// query j is the result + j * WARP.
template <int S>
__device__ __forceinline__ long long first_query() {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  return ((long long)blockIdx.x * (WARPS / S) + warp / S) * SLOT + lane;
}

// The body of the search kernels: loads this lane's queries (q0 + j * WARP
// of the sample's `qb` (Q, 3); zeros past Q), scans the sample's cloud `rb`
// (R, 3) tile by tile, merges the slot's S warps and resolves. Every thread
// of the block calls it (it synchronises). Returns true in the slot's first
// warp (seg 0), whose lanes then hold each query's `idx` and `best`; when
// R <= TR, `tile` still holds the whole cloud.
template <int S>
__device__ __forceinline__ bool search(Lane& l, float4* tile,
                                       MergeBuf<S>& buf, const float* qb,
                                       const float* rb, long long q0, int Q,
                                       int R) {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int seg = warp % S;
  l.reset();
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const long long q = q0 + j * WARP;
#pragma unroll
    for (int c = 0; c < 3; ++c) l.q[j][c] = q < Q ? qb[q * 3 + c] : 0.f;
  }
  for (int t0 = 0; t0 < R; t0 += TR) {
    const int n = min(TR, R - t0);
    stage(tile, rb, t0, n);
    __syncthreads();
    l.scan<S>(tile, n, t0, seg);
    __syncthreads();
  }
  merge<S>(buf, l, warp, seg, lane);
  if (seg != 0) return false;
  if constexpr (S > 1)
    l.resolve_alone(tile, rb, R);
  else
    l.resolve(tile, rb, R);
  return true;
}

}  // namespace nn_scan
