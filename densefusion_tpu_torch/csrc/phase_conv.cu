// The decoder's 3x3 VALID convolution of a pre-padded map, as an implicit
// GEMM in flat spatial space.
//
// Replaces the Pallas TPU kernel `_conv_kernel`
// (densefusion_tpu/ops/phase_conv.py:72; `_conv3x3_pallas_impl` at :100
// calls it through `pl.pallas_call` at :125). What it computes, not how the
// TPU blocks it. With xp the (B, Cin, h+2, w+2) padded input in NCHW, pk the
// (3, 3, Cin, Cout) HWIO kernel, wp = w + 2 and xp_flat[b, c, q] =
// xp[b, c, q / wp, q % wp]:
//
//   out_flat[b, co, p] = sum_{kh, kw, ci}
//                        xp_flat[b, ci, p + kh*wp + kw] * pk[kh, kw, ci, co]
//
// for p = i*wp + j < h*wp, one float32 accumulator per output. Every tap is
// a shift of one flat map. The columns j in {w, w+1} are phantoms (their taps
// run across a row end) and are not stored: the kernel writes only j < w,
// straight into out[b, co, i, j] (B, Cout, h, w), so no slice copy follows.
// The bias stays outside, as in JAX (models/layers.py:109).
//
// Design. A block computes BM = 128 output channels x BN = 128 flat
// positions of one image (grid: position tiles, channel tiles, batch); its
// 256 threads each hold an 8 x 8 tile of accumulators in registers: 8
// consecutive channels (read from shared memory as two float4) by 8
// positions 16 apart (so a warp reads 16 consecutive words, free of bank
// conflicts). The reduction over Cin runs in chunks of BK = 4 channels. Per
// chunk the block stages the weights of all 9 taps (BK x 9 x BM, coalesced
// along Cout) and, per tap row kh, one input row of BN + 2 elements: two
// wider than the tile, so one staged row serves the three kw taps. That row
// is the GPU's counterpart of the TPU kernel's single aligned window
// (phase_conv.py:81-83); the TPU's roll of the partial product has no reason
// to exist here. Loads past a channel's flat end (the last tile's tail, and
// the two elements that the last phantom columns reach past the last image)
// read as zero, as do ragged Cin and Cout; nothing is padded in a copy.
//
// Arithmetic: float32 FFMA on the CUDA cores (the port keeps TF32 off), in
// the order ci-chunk, channel, kh, kw. The plain PyTorch version sums nine
// shifted matmuls, so the two agree to rounding, not bit for bit.
//
// Bound on the H100. 2*9*B*h*w*Cin*Cout operations against 67 TFLOP/s of
// non-tensor float32: 10.38 ms at up1 (B=64, 24x24, 1024 -> 4*256), 2.60 ms
// at up2 (48x48, 256 -> 4*64) and at up3 (96x96, 64 -> 4*64); the bytes
// (input, weights, output once) take 0.1-0.2 ms, so it is operations-bound.
// The flat space adds (w+2)/w of work (8.3% at w=24), and each (channel, tap)
// step issues 8 scalar and 2 vector shared loads per 64 FFMAs, with no
// overlap of the staging with the math: expect 2-4x the bound.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;     // output channels per block
constexpr int BN = 128;     // flat positions per block
constexpr int BK = 4;       // input channels per staged chunk
constexpr int TM = 8;       // channels per thread (consecutive)
constexpr int TN = 8;       // positions per thread (BN / TN = 16 apart)
constexpr int LANES = BN / TN;
constexpr int THREADS = (BM / TM) * LANES;   // 256
constexpr int XW = BN + 2;  // a staged input row: the tile and its kw shifts

__global__ void __launch_bounds__(THREADS)
phase_conv_kernel(const float* __restrict__ xp,   // (B, Cin, h+2, w+2)
                  const float* __restrict__ pk,   // (3, 3, Cin, Cout)
                  float* __restrict__ out,        // (B, Cout, h, w)
                  int Cin, int Cout, int h, int w) {
  __shared__ __align__(16) float ws[BK][9][BM];
  __shared__ float xs[BK][3][XW];

  const int wp = w + 2;
  const int L = (h + 2) * wp;    // flat input length of one channel
  const int P = h * wp;          // flat output positions, phantoms included
  const int p0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % LANES;   // position lane
  const int ty = threadIdx.x / LANES;   // channel group
  const float* xb = xp + (long long)b * Cin * L;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += BK) {
    // ws[c][tap][m] = pk[tap][ci0 + c][co0 + m]
    for (int e = threadIdx.x; e < BK * 9 * BM; e += THREADS) {
      const int m = e % BM, tap = (e / BM) % 9, c = e / (BM * 9);
      const int ci = ci0 + c, co = co0 + m;
      ws[c][tap][m] = (ci < Cin && co < Cout)
                          ? pk[((long long)tap * Cin + ci) * Cout + co]
                          : 0.f;
    }
    // xs[c][kh][t] = xp_flat[b, ci0 + c, p0 + kh*wp + t]
    for (int e = threadIdx.x; e < BK * 3 * XW; e += THREADS) {
      const int t = e % XW, kh = (e / XW) % 3, c = e / (XW * 3);
      const int ci = ci0 + c, q = p0 + kh * wp + t;
      xs[c][kh][t] = (ci < Cin && q < L) ? xb[(long long)ci * L + q] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(&ws[c][kh * 3 + kw][ty * TM]);
          const float4 a1 = *reinterpret_cast<const float4*>(
              &ws[c][kh * 3 + kw][ty * TM + 4]);
          const float a[TM] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
          float x[TN];
#pragma unroll
          for (int n = 0; n < TN; ++n) x[n] = xs[c][kh][tx + LANES * n + kw];
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int n = 0; n < TN; ++n)
              acc[m][n] = fmaf(a[m], x[n], acc[m][n]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < TN; ++n) {
    const int p = p0 + tx + LANES * n;
    const int i = p / wp, j = p - (p / wp) * wp;
    if (p >= P || j >= w) continue;   // past the map, or a phantom column
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int co = co0 + ty * TM + m;
      if (co < Cout)
        out[(((long long)b * Cout + co) * h + i) * w + j] = acc[m][n];
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); the caller raises on a non-zero result. Requires
// contiguous float32 tensors, B in [1, 65535], h, w, Cin, Cout >= 1 and
// Cin * (h+2) * (w+2) < 2^31 (checked by the Python wrapper).
extern "C" int phase_conv_launch(const float* xp, const float* pk, float* out,
                                 int B, int Cin, int Cout, int h, int w,
                                 void* stream) {
  const dim3 grid((h * (w + 2) + BN - 1) / BN, (Cout + BM - 1) / BM, B);
  phase_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xp, pk, out, Cin, Cout, h, w);
  return static_cast<int>(cudaGetLastError());
}
