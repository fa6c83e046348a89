// 1-NN search: for every query point, the 0-based index of its nearest
// reference point and the exact squared distance to it.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * `_nn_kernel`    (densefusion_tpu/ops/knn.py:89, nearest_neighbor_pallas,
//     called at :162; query (Q, 3) against ref (R, 3)): entry point
//     `nn_launch`, B = 1;
//   * `_nn_kernel_bt` (densefusion_tpu/ops/knn.py:211,
//     nearest_neighbor_pallas_batched, called at :270; (B, Q, 3) against
//     (B, R, 3)): entry point `nn_batched_launch`.
// The TPU needed two kernels for two HBM layouts; here one kernel serves
// both. What it computes, not how the TPU blocks it:
//
//   idx[b, q]  = argmin_r s(q, r),   s(q, r) = ||r||^2 - 2 q.r
//   dist[b, q] = min_r s(q, r) + ||q||^2
//
// ties going to the lowest reference index. The TPU wrappers add ||q||^2
// outside the kernel (knn.py:191, :298); here it is the kernel's last step,
// so one launch writes both outputs: (B, Q) float32 and (B, Q) int64 (the
// index type PyTorch's gather takes), allocated by the caller.
//
// Bound on the H100. About 8 fp32 operations per (query, ref) pair against
// about 67 TFLOP/s of non-tensor fp32; 12 bytes in per point and 12 out per
// query. At the KNN benchmark's Q = 250,000, R = 500 that is ~15 us of
// arithmetic and ~1.5 us of memory traffic: operations-bound.
//
// Design: the scan of csrc/nn_scan.cuh (`nn_scan::search`, which the remap
// of csrc/adds_remap.cu runs too). A block of 8 warps covers 8 / S
// slots of 128 queries (4 per lane) of one sample; S warps share a slot
// where the grid would otherwise not fill the card (nn_scan::nn_split picks
// S from the shape: at least two blocks per SM, while each warp keeps at
// least 32 refs), and their winners merge exactly. The sample's reference
// cloud is staged in tiles, so R is unbounded; the ragged ends of Q and R
// are masked by the bounds (the TPU kernel padded refs with rsq = +inf).
// The rounding is pinned (no FMAs, no tensor cores: the header says why),
// so kernel and plain version (ops/knn.py `_scores`, `_qsq`) give
// bit-identical distances, dist = s + ((qx*qx + qy*qy) + qz*qz), and equal
// indices, ties included. The pinned score and the group minimum cost ~8
// lane instructions per pair, so expect ~2x the bound; the first design
// (one query per lane, a compare and two selects per pair) ran at 4.1x.

#include <cuda_runtime.h>

#include "nn_scan.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(nn_scan::THREADS)
nn_kernel(const float* __restrict__ query,   // (B, Q, 3)
          const float* __restrict__ ref,     // (B, R, 3)
          float* __restrict__ dist,          // (B, Q)
          long long* __restrict__ idx,       // (B, Q)
          int Q, int R) {
  __shared__ float4 tile[nn_scan::TILE];
  __shared__ nn_scan::MergeBuf<S> buf;
  const int b = blockIdx.y;
  const long long q0 = nn_scan::first_query<S>();
  nn_scan::Lane l;
  if (!nn_scan::search<S>(l, tile, buf, query + (long long)b * Q * 3,
                          ref + (long long)b * R * 3, q0, Q, R))
    return;
#pragma unroll
  for (int j = 0; j < nn_scan::QT; ++j) {
    const long long q = q0 + j * nn_scan::WARP;
    if (q < Q) {
      const long long o = (long long)b * Q + q;
      dist[o] = __fadd_rn(l.best[j],
                          nn_scan::sq3(l.q[j][0], l.q[j][1], l.q[j][2]));
      idx[o] = l.idx[j];
    }
  }
}

int launch(const float* query, const float* ref, float* dist, long long* idx,
           int B, int Q, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nn_scan::dispatch(nn_scan::nn_split(B, Q, R), [&](auto split) {
    constexpr int S = decltype(split)::value;
    nn_kernel<S><<<nn_scan::search_grid<S>(B, Q), nn_scan::THREADS, 0, st>>>(
        query, ref, dist, idx, Q, R);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Both launch on `stream` (PyTorch's current stream) and return
// cudaGetLastError(); the caller raises on a non-zero result. They require
// Q >= 1, R >= 1 and, batched, B in [1, 65535] (checked by the Python
// wrappers).

// Kernel 3's entry: query (Q, 3) against ref (R, 3).
extern "C" int nn_launch(const float* query, const float* ref, float* dist,
                         long long* idx, int Q, int R, void* stream) {
  return launch(query, ref, dist, idx, 1, Q, R, stream);
}

// Kernel 4's entry: query (B, Q, 3) against ref (B, R, 3), sample by sample.
extern "C" int nn_batched_launch(const float* query, const float* ref,
                                 float* dist, long long* idx, int B, int Q,
                                 int R, void* stream) {
  return launch(query, ref, dist, idx, B, Q, R, stream);
}

// The warps per slot (S) that the shared scan takes for a shape: kernel 2
// (csrc/add_dist.cu's min kernel; B rows of n hypotheses, m model and
// target points) if `min_kernel` is non-zero, else kernels 3 and 4 (B
// samples of n queries against m refs). Both rules live in nn_scan.cuh.
extern "C" int scan_split(int min_kernel, int B, int n, int m) {
  return min_kernel ? nn_scan::min_split(B, n, m)
                    : nn_scan::nn_split(B, n, m);
}
