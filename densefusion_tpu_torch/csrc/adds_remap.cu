// ADD-S remap: for every query point, the coordinates of its nearest
// reference point and the winning score ||r||^2 - 2 q.r.
//
// Replaces the Pallas TPU kernel `_remap_kernel_bt`
// (densefusion_tpu/ops/knn.py:303, launched by adds_remap_pallas_batched at
// :414). What it computes, not how the TPU blocks it:
//
//   coords[b, q, :] = ref[b, argmin_r s(q, r), :]
//   score[b, q]     = min_r s(q, r),   s(q, r) = ||r||^2 - 2 q.r
//
// ties going to the lowest reference index; rows with active[b] == 0 write
// zeros. Outputs are (B, Q, 3) and (B, Q) float32, allocated by the caller.
// The score is the search's own, with no ||q||^2 added (kernel 3 adds it;
// the ADD-S loss adds it outside).
//
// Bound on the H100. About 8 fp32 operations per (query, ref) pair against
// about 67 TFLOP/s of non-tensor fp32; 12 bytes in per point and 16 out per
// query. At the serving path's scoring shape B = 64, Q = R = 500 that is
// ~1.9 us of arithmetic and ~0.4 us of memory traffic: operations-bound,
// and below a graph replay's launch floor (~4-7 us).
//
// Design: the search of csrc/nn_scan.cuh (`nn_scan::search`), the same
// body as the 1-NN kernels of csrc/nn.cu; only the outputs differ. A block
// of 8 warps covers 8 / S slots of 128 queries (4 per lane) of one sample;
// nn_scan::nn_split picks S (at the scoring shape 8: 256 blocks, each warp
// scanning every eighth group of 8 refs of one slot), the S partial
// winners merge exactly, and the slot's first warp resolves the winning
// group alone (`resolve_alone`: a group's loads overlap, and the staged
// groups are padded so that its lanes' reads do not conflict). A block
// reads its row's `active` flag once, before it stages anything (the TPU
// kernel took it by scalar prefetch); a gated row's block writes zeros and
// returns, which is uniform across the block, so no barrier is skipped by
// part of it. The main path passes no `active`; a persistent grid over the
// active rows (kernel 2's) would buy nothing there. Once the search has
// resolved the winner's index, its coordinates are copied from the staged
// tile when the cloud fits one (R <= 1024), else from `ref` in global
// memory: a copy, so exact. The rounding is pinned (no FMAs: the header
// says why), so the scores are bit-identical to the plain version's
// (ops/knn.py `_scores`) and so are the coordinates, ties included. Where
// every score of a query is +inf or NaN, the search's winning group
// stands: its first ref's coordinates, with the best score (nn.cu does the
// same); nothing on the driven paths gives such inputs. The first design
// (one query per lane, 128-thread blocks, a compare and four selects per
// pair) ran at 7.1-7.2x the bound; the scan costs ~8 lane instructions per
// pair, and at the scoring shape the launch, the staging, the merge and
// the resolve, each a fixed cost, add up to about as much as the scan.
//
// Not taken, as in csrc/nn_scan.cuh: FMAs (another nearest ref for a few
// queries in 20,000, an end to bit parity with the plain version) and the
// tensor cores (K = 3; a TF32 or 3xTF32 product would round the scores
// differently from the plain version).

#include <cuda_runtime.h>

#include "nn_scan.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(nn_scan::THREADS)
adds_remap_kernel(const float* __restrict__ query,   // (B, Q, 3)
                  const float* __restrict__ ref,     // (B, R, 3)
                  const int* __restrict__ active,    // (B,) or nullptr
                  float* __restrict__ coords,        // (B, Q, 3)
                  float* __restrict__ score,         // (B, Q)
                  int Q, int R) {
  __shared__ float4 tile[nn_scan::TILE];
  __shared__ nn_scan::MergeBuf<S> buf;
  using nn_scan::QT;
  using nn_scan::WARP;
  const int b = blockIdx.y;
  const long long q0 = nn_scan::first_query<S>();
  const float* rb = ref + (long long)b * R * 3;
  float* cb = coords + (long long)b * Q * 3;
  float* sb = score + (long long)b * Q;

  if (active != nullptr && active[b] == 0) {   // one row per block: uniform
    if (threadIdx.x / WARP % S == 0) {         // the slot's first warp
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const long long q = q0 + j * WARP;
        if (q < Q) {
          cb[q * 3 + 0] = cb[q * 3 + 1] = cb[q * 3 + 2] = 0.f;
          sb[q] = 0.f;
        }
      }
    }
    return;
  }

  nn_scan::Lane l;
  if (!nn_scan::search<S>(l, tile, buf, query + (long long)b * Q * 3, rb,
                          q0, Q, R))
    return;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const long long q = q0 + j * WARP;
    if (q < Q) {
      const long long k = l.idx[j];
      if (R <= nn_scan::TR) {   // the tile holds the whole cloud
        const float4 r = tile[nn_scan::pos(k)];
        cb[q * 3 + 0] = r.x;
        cb[q * 3 + 1] = r.y;
        cb[q * 3 + 2] = r.z;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) cb[q * 3 + c] = rb[k * 3 + c];
      }
      sb[q] = l.best[j];
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); the caller raises on a non-zero result. Requires
// B in [1, 65535], Q >= 1, R >= 1 (checked by the Python wrapper).
extern "C" int adds_remap_launch(const float* query, const float* ref,
                                 const int* active, float* coords,
                                 float* score, int B, int Q, int R,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nn_scan::dispatch(nn_scan::nn_split(B, Q, R), [&](auto split) {
    constexpr int S = decltype(split)::value;
    adds_remap_kernel<S>
        <<<nn_scan::search_grid<S>(B, Q), nn_scan::THREADS, 0, st>>>(
            query, ref, active, coords, score, Q, R);
    return static_cast<int>(cudaGetLastError());
  });
}
