// 1-NN search: for every query point, the 0-based index of its nearest
// reference point and the exact squared distance to it.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * `_nn_kernel`    (densefusion_tpu/ops/knn.py:89, nearest_neighbor_pallas,
//     query (Q, 3) against ref (R, 3)): entry point `nn_launch`, B = 1;
//   * `_nn_kernel_bt` (densefusion_tpu/ops/knn.py:211,
//     nearest_neighbor_pallas_batched, (B, Q, 3) against (B, R, 3)): entry
//     point `nn_batched_launch`.
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
// Design (that of csrc/adds_remap.cu). One block per (sample, tile of TQ
// queries), one query per thread, the running best score and index in
// registers. The sample's reference cloud is staged through shared memory in
// tiles of TR points as float4 {x, y, z, ||r||^2}, so R is unbounded. The
// ragged ends of Q and R are masked by the bounds (the TPU kernel padded
// refs with rsq = +inf).
//
// Arithmetic. K = 3, so no tensor cores: plain fp32 on the CUDA cores. The
// rounding is pinned with __fmul_rn / __fadd_rn, which nvcc never contracts
// into FMAs, in the order of the plain PyTorch version (ops/knn.py
// `_scores` and `_qsq`): rsq = (x*x + y*y) + z*z, dot = (qx*rx + qy*ry) +
// qz*rz, s = rsq - 2*dot, dist = s + ((qx*qx + qy*qy) + qz*qz). Kernel and
// plain version thus give bit-identical distances and equal indices, ties
// included: a score replaces the running best only when strictly smaller,
// and refs are scanned in ascending order.
//
// Bound on the H100. About 8 fp32 operations per (query, ref) pair against
// about 67 TFLOP/s of non-tensor fp32; 12 bytes in per point and 12 out per
// query. At the KNN benchmark's Q = 250,000, R = 500 that is ~15 us of
// arithmetic and ~1.5 us of memory traffic: operations-bound. Without FMAs
// the loop issues ~10 instructions per pair, so expect a few times the
// bound.

#include <cuda_runtime.h>

namespace {

constexpr int TQ = 128;   // queries per block (one per thread)
constexpr int TR = 1024;  // refs per shared-memory tile (16 KB)

__global__ void __launch_bounds__(TQ)
nn_kernel(const float* __restrict__ query,   // (B, Q, 3)
          const float* __restrict__ ref,     // (B, R, 3)
          float* __restrict__ dist,          // (B, Q)
          long long* __restrict__ idx,       // (B, Q)
          int Q, int R) {
  __shared__ float4 tile[TR];
  const int b = blockIdx.y;
  const int q = blockIdx.x * TQ + threadIdx.x;
  const bool in_range = q < Q;
  const long long qo = (long long)b * Q + q;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (in_range) {
    qx = query[qo * 3 + 0];
    qy = query[qo * 3 + 1];
    qz = query[qo * 3 + 2];
  }
  float best = __int_as_float(0x7f800000);    // +inf
  int best_i = 0;

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
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float4 r = tile[i];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, r.x),
                                            __fmul_rn(qy, r.y)),
                                  __fmul_rn(qz, r.z));
      const float s = __fsub_rn(r.w, __fmul_rn(2.f, dot));
      if (s < best) {
        best = s;
        best_i = t0 + i;
      }
    }
    __syncthreads();
  }

  if (in_range) {
    const float qsq = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                                __fmul_rn(qz, qz));
    dist[qo] = __fadd_rn(best, qsq);
    idx[qo] = best_i;
  }
}

int launch(const float* query, const float* ref, float* dist, long long* idx,
           int B, int Q, int R, void* stream) {
  const dim3 grid((Q + TQ - 1) / TQ, B);
  nn_kernel<<<grid, TQ, 0, static_cast<cudaStream_t>(stream)>>>(
      query, ref, dist, idx, Q, R);
  return static_cast<int>(cudaGetLastError());
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
