// ADD-S remap: for every query point, the coordinates of its nearest
// reference point and the winning score ||r||^2 - 2 q.r.
//
// Replaces the Pallas TPU kernel `_remap_kernel_bt`
// (densefusion_tpu/ops/knn.py:303, launched by adds_remap_pallas_batched).
// What it computes, not how the TPU blocks it:
//
//   coords[b, q, :] = ref[b, argmin_r s(q, r), :]
//   score[b, q]     = min_r s(q, r),   s(q, r) = ||r||^2 - 2 q.r
//
// ties going to the lowest reference index; rows with active[b] == 0 write
// zeros. Outputs are (B, Q, 3) and (B, Q) float32, allocated by the caller.
//
// Design. One block per (sample, tile of TQ queries), one query per thread,
// the query's running best score and coordinates in registers. The sample's
// reference cloud is staged through shared memory in tiles of TR points as
// float4 {x, y, z, ||r||^2}, so R is unbounded. The block reads its own
// `active` flag (the TPU kernel took it by scalar prefetch) and the ragged
// edges are masked by the bounds Q and R (the TPU kernel padded refs with
// rsq = +inf).
//
// Arithmetic. K = 3, so no tensor cores and no TF32: plain fp32 on the CUDA
// cores. The rounding is pinned with __fmul_rn / __fadd_rn, which nvcc
// never contracts into FMAs, in the order of the plain PyTorch version
// (ops/knn.py `_scores`): rsq = (x*x + y*y) + z*z, dot = (qx*rx + qy*ry) +
// qz*rz, s = rsq - 2*dot. The kernel's scores are thus bit-identical to the
// plain version's, so their argmins, ties included, agree exactly. A score
// replaces the running best only when strictly smaller, and refs are
// scanned in ascending order, so ties go to the lowest index.
//
// Bound on the H100. About 8 fp32 operations per (query, ref) pair against
// about 67 TFLOP/s of non-tensor fp32, and 12 bytes in per point and 16 out
// per query: at the main path's B=64, Q=R=500 that is ~2 us of arithmetic
// and ~0.4 us of memory traffic, so a launch (several us) dominates.

#include <cuda_runtime.h>

namespace {

constexpr int TQ = 128;   // queries per block (one per thread)
constexpr int TR = 1024;  // refs per shared-memory tile (16 KB)

__global__ void __launch_bounds__(TQ)
adds_remap_kernel(const float* __restrict__ query,   // (B, Q, 3)
                  const float* __restrict__ ref,     // (B, R, 3)
                  const int* __restrict__ active,    // (B,) or nullptr
                  float* __restrict__ coords,        // (B, Q, 3)
                  float* __restrict__ score,         // (B, Q)
                  int Q, int R) {
  __shared__ float4 tile[TR];
  const int b = blockIdx.y;
  const int q = blockIdx.x * TQ + threadIdx.x;
  const bool in_range = q < Q;
  const long long qo = (long long)b * Q + q;

  if (active != nullptr && active[b] == 0) {   // uniform across the block
    if (in_range) {
      coords[qo * 3 + 0] = 0.f;
      coords[qo * 3 + 1] = 0.f;
      coords[qo * 3 + 2] = 0.f;
      score[qo] = 0.f;
    }
    return;
  }

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (in_range) {
    qx = query[qo * 3 + 0];
    qy = query[qo * 3 + 1];
    qz = query[qo * 3 + 2];
  }
  float best = __int_as_float(0x7f800000);    // +inf
  float bx = 0.f, by = 0.f, bz = 0.f;

  const float* rb = ref + (long long)b * R * 3;
  for (int t0 = 0; t0 < R; t0 += TR) {
    const int n = min(TR, R - t0);
    for (int i = threadIdx.x; i < n; i += TQ) {
      const float x = rb[(long long)(t0 + i) * 3 + 0];
      const float y = rb[(long long)(t0 + i) * 3 + 1];
      const float z = rb[(long long)(t0 + i) * 3 + 2];
      const float rsq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                  __fmul_rn(z, z));
      tile[i] = make_float4(x, y, z, rsq);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 r = tile[i];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, r.x),
                                            __fmul_rn(qy, r.y)),
                                  __fmul_rn(qz, r.z));
      const float s = __fsub_rn(r.w, __fmul_rn(2.f, dot));
      if (s < best) {
        best = s;
        bx = r.x;
        by = r.y;
        bz = r.z;
      }
    }
    __syncthreads();
  }

  if (in_range) {
    coords[qo * 3 + 0] = bx;
    coords[qo * 3 + 1] = by;
    coords[qo * 3 + 2] = bz;
    score[qo] = best;
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
  const dim3 grid((Q + TQ - 1) / TQ, B);
  adds_remap_kernel<<<grid, TQ, 0, static_cast<cudaStream_t>(stream)>>>(
      query, ref, active, coords, score, Q, R);
  return static_cast<int>(cudaGetLastError());
}
