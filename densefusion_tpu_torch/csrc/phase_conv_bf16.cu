// The decoder's 3x3 VALID convolution of a pre-padded map in bfloat16: the
// bf16 route of kernel 6, an implicit GEMM in flat spatial space on the
// tensor cores (wgmma, bf16 products, float32 sums).
//
// Replaces the Pallas TPU kernel `_conv_kernel`
// (densefusion_tpu/ops/phase_conv.py:72) for bf16 operands, as the JAX
// package runs it under bf16 compute: bf16 x bf16 products summed in
// float32 (`preferred_element_type=jnp.float32`, :96) and rounded once to
// bf16 (`acc.astype(o_ref.dtype)`, :104). With xp the (B, Cin, h+2, w+2)
// padded input in NCHW, pk the (3, 3, Cin, Cout) HWIO kernel, wp = w + 2
// and xp_flat[b, c, q] = xp[b, c, q / wp, q % wp]:
//
//   out_flat[b, co, p] = bf16(sum_{kh, kw, ci}
//                        xp_flat[b, ci, p + kh*wp + kw] * pk[kh, kw, ci, co])
//
// for p = i*wp + j < h*wp; the phantom columns j in {w, w+1} are not
// stored, and the bias stays outside, as in JAX (models/layers.py:109).
// The float32 route is csrc/phase_conv.cu (3xTF32); this file shares no
// code with it, so that route's source and build stay as they were.
//
// Arithmetic: a bf16 x bf16 product is exact in float32. Each stage's
// products (16 channels x 3 taps) go into a fresh wgmma accumulator that is
// added to the running float32 sum with a rounded FADD, as the float32
// route does; the sum is rounded once to bf16 (round to nearest even).
//
// Instruction: wgmma.mma_async m64n128k16 .bf16 with float32 accumulators,
// A (the weights) from registers, B (the input) from shared memory,
// K-major: the 16 channels of one position as two 16-byte halves (8
// channels each, LBO apart), positions 16 bytes apart. One wgmma per kw tap
// and stage: no hi / lo split. Each stage's raw input rows are transposed
// once into that layout, and a tap's shift of one or two positions is a
// move of 16 or 32 bytes of the descriptor's start, so the three kw taps
// read one buffer.
//
// Tiles, as the float32 route: a block computes BM = 128 output channels
// (two warpgroups of 64) x BN = 128 flat positions of one image; grid:
// position tiles, channel tiles, batch. K runs over (channel chunk of BK =
// 16, tap row kh): 3 wgmmas per warpgroup and stage.
//
// Copy ring: NSTAGE = 4 stages, each the raw weights of the three kw taps
// (3 x BK x (BM + 8) bf16) and one input row of BN + 2 positions + up to 7
// of alignment per channel, then NBBUF = 2 transposed input buffers:
// 79,488 bytes of dynamic shared memory. While stage s is multiplied,
// stage s+1 is transposed into the other buffer and stages s+2 and s+3
// are in flight.
// - Weights: one TMA bulk copy per stage (a (136, 16, 3) box of pk seen as
//   (Cout, Cin, 9), zeros past Cout and Cin). Where TMA cannot address pk
//   (Cout % 8 != 0, or pk not 16-byte aligned), plain loads.
// - Input rows: cp.async in 16-byte chunks from the 16-byte boundary at or
//   below the row's start (0-7 elements, per channel); a chunk across a
//   channel's start or end is copied element by element with plain loads,
//   zeros outside the channel and past Cin.
//
// Bound on the H100 (examples/kernel_bounds.py, chip_smoke.py [4l]):
// 2*9*B*h*w*Cin*Cout operations at the dense bf16 peak of 989 TFLOP/s,
// 0.703 ms at up1 (B=64, 24x24, 1024 -> 4*256), 0.176 ms at up2 (48x48,
// 256 -> 4*64) and at up3 (96x96, 64 -> 4*64); the bytes (bf16 input,
// weights and output once) take 0.04-0.11 ms: operations-bound. This
// first version keeps the float32 route's structure and is not tuned:
// one block of 256 threads per SM, a barrier per stage, scalar 2-byte
// output stores.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint16_t bf16_t;   // raw bfloat16 bits

constexpr int BM = 128;      // output channels per block (M)
constexpr int BN = 128;      // flat positions per block (N)
constexpr int BK = 16;       // input channels per stage: one wgmma depth
constexpr int NSTAGE = 4;    // stages in the copy ring
constexpr int NBBUF = 2;     // transposed input buffers
constexpr int THREADS = 256; // two warpgroups
constexpr int WS = BM + 8;   // raw weight row stride in elements
constexpr int XS = BN + 16;  // raw input row: BN + 2 taps + 7 alignment
constexpr int XCHUNKS = XS / 8;       // 16-byte chunks per raw input row
constexpr int W_ELEMS = 3 * BK * WS;              // ws[kw][c][m]
constexpr int STAGE_ELEMS = W_ELEMS + BK * XS;    // + xs[c][u]
constexpr int BROWS = BN + 2;         // transposed rows: the tile + shifts
constexpr int BQ = (BROWS + 6) * 8;   // elements per 8-channel half
constexpr int BBUF_ELEMS = 2 * BQ;    // [half][row][8 channels]
// + 128: the dynamic shared memory is aligned up to 128 bytes for TMA
constexpr int SMEM_BYTES =
    (NSTAGE * STAGE_ELEMS + NBBUF * BBUF_ELEMS) * 2 + 128;

static_assert(XS >= BN + 2 + 7 && XS % 8 == 0, "row: tile, shifts, align");
static_assert((STAGE_ELEMS * 2) % 128 == 0, "TMA slots 128-byte aligned");
static_assert((WS * 2) % 16 == 0, "TMA box rows of whole 16 bytes");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, of which the first `bytes` (16 or 0) come from
// src and the rest are zero.
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA data in this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The box of `map` at coordinates (c0, c1, c2) into dst, completing on bar.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// Elements between element q of the channel starting at `row` and the
// 16-byte boundary at or below it (0-7).
__device__ __forceinline__ int misalign(const bf16_t* row, int q) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 1) +
                          static_cast<uintptr_t>(q)) & 7;
}

// wgmma descriptor of a K-major B tile without swizzle: rows (positions)
// 16 bytes apart, 8-row groups SBO = 128 bytes apart, the two 8-channel
// halves of K LBO = BQ elements apart.
__device__ __forceinline__ uint64_t b_desc(const bf16_t* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((BQ * 2) >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous wgmmas that write them.
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a (64x16 bf16, registers) * B (16x128 bf16, K-major descriptor);
// d starts from zero when `accumulate` is 0.
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Two bf16 values as one register, `lo` in the low half (the lower K index).
__device__ __forceinline__ uint32_t pack(bf16_t lo, bf16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

template <bool TMA_W>
__global__ void __launch_bounds__(THREADS, 1)
phase_conv_bf16_kernel(const bf16_t* __restrict__ xp,  // (B, Cin, h+2, w+2)
                       const bf16_t* __restrict__ pk,  // (3, 3, Cin, Cout)
                       bf16_t* __restrict__ out,       // (B, Cout, h, w)
                       int Cin, int Cout, int h, int w,
                       const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16_t* smem = reinterpret_cast<bf16_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  bf16_t* bbuf = smem + NSTAGE * STAGE_ELEMS;
  __shared__ uint64_t wbar[NSTAGE];   // ring slot s: stage s's weights

  const int wp = w + 2;
  const int L = (h + 2) * wp;    // flat input length of one channel
  const int P = h * wp;          // flat output positions, phantoms included
  const int p0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const bf16_t* xb = xp + (long long)b * Cin * L;
  const int nstages = 3 * ((Cin + BK - 1) / BK);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row / column group
  const int wrow = warp * 16;   // this warp's 16 of the block's channels

  // Stage s: input channels [BK*(s/3), +BK), tap row kh = s % 3, into ring
  // slot s % NSTAGE.
  auto load = [&](int s) {
    bf16_t* ws = smem + (s % NSTAGE) * STAGE_ELEMS;
    bf16_t* xs = ws + W_ELEMS;
    const int ci0 = (s / 3) * BK, kh = s % 3;
    // ws[kw][c][m] = pk[kh][kw][ci0 + c][co0 + m]
    if (TMA_W) {
      if (threadIdx.x == 0) {
        mbar_expect(&wbar[s % NSTAGE], W_ELEMS * 2);
        tma_load3(ws, &wmap, co0, ci0, 3 * kh, &wbar[s % NSTAGE]);
      }
      __syncwarp();
    } else {
      for (int e = threadIdx.x; e < 3 * BK * BM; e += THREADS) {
        const int m = e % BM, c = (e / BM) % BK, kw = e / (BK * BM);
        const int ci = ci0 + c, co = co0 + m;
        ws[(kw * BK + c) * WS + m] =
            ci < Cin && co < Cout
                ? pk[((long long)(kh * 3 + kw) * Cin + ci) * Cout + co]
                : bf16_t(0);
      }
    }
    // xs[c][u] = xp_flat[b, ci0 + c, q0 - a + u], a = misalign(row, q0)
    const int q0 = p0 + kh * wp;
    for (int e = threadIdx.x; e < BK * XCHUNKS; e += THREADS) {
      const int k = e % XCHUNKS, c = e / XCHUNKS, ci = ci0 + c;
      bf16_t* dst = xs + c * XS + 8 * k;
      const bf16_t* row = xb + (long long)ci * L;
      const int r = q0 - misalign(row, q0) + 8 * k;   // first element, >= -7
      if (ci >= Cin || r >= L) {
        cp16(dst, xp, 0);
      } else if (r >= 0 && r + 8 <= L) {
        cp16(dst, row + r, 16);
      } else {   // a chunk across the channel's start or end, elementwise
        for (int u = 0; u < 8; ++u)
          dst[u] = r + u >= 0 && r + u < L ? row[r + u] : bf16_t(0);
      }
    }
  };

  // Stage s's raw input rows, transposed: bb[half][row] holds channels
  // 8*half + (0..7) of position q0 + row.
  auto transpose_pass = [&](int s) {
    const bf16_t* xs = smem + (s % NSTAGE) * STAGE_ELEMS + W_ELEMS;
    bf16_t* bb = bbuf + (s % NBBUF) * BBUF_ELEMS;
    const int ci0 = (s / 3) * BK;
    const int q0 = p0 + (s % 3) * wp;
    for (int e = threadIdx.x; e < 2 * BROWS; e += THREADS) {
      const int half = e / BROWS, row = e % BROWS;
      bf16_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = 8 * half + u;
        v[u] = xs[c * XS + misalign(xb + (long long)(ci0 + c) * L, q0) + row];
      }
      *reinterpret_cast<uint4*>(bb + half * BQ + row * 8) =
          make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                     pack(v[6], v[7]));
    }
  };

  if (TMA_W && threadIdx.x == 0) {
    for (int i = 0; i < NSTAGE; ++i) mbar_init(&wbar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t a[2][4];   // A of two kw taps in flight

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nstages) load(s);
    cp_commit();
  }
  cp_wait<NSTAGE - 2>();
  __syncthreads();
  transpose_pass(0);

  for (int s = 0; s < nstages; ++s) {
    cp_wait<NSTAGE - 3>();   // this thread's copies of stage s+1 landed
    if (TMA_W)               // stage s's weights (parity: the slot's use)
      mbar_wait(&wbar[s % NSTAGE], (s / NSTAGE) & 1);
    // the transposed stores of stage s reach the wgmmas (async proxy), and
    // all reads of the slot the next TMA overwrites come before it;
    // everyone's copies landed; every warpgroup's wgmmas of stage s-1 are
    // done with the buffer that stage s+1 is transposed into
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const bf16_t* ws = smem + (s % NSTAGE) * STAGE_ELEMS;
    const bf16_t* bb = bbuf + (s % NBBUF) * BBUF_ELEMS;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      // A[m][k] = ws[kw][k][m]: rows wrow + g (+8), channels 2t, 2t+1
      // (+8)
      const bf16_t* wk = ws + kw * BK * WS + wrow + g;
      uint32_t* ak = a[kw % 2];
      ak[0] = pack(wk[(2 * t) * WS], wk[(2 * t + 1) * WS]);
      ak[1] = pack(wk[(2 * t) * WS + 8], wk[(2 * t + 1) * WS + 8]);
      ak[2] = pack(wk[(2 * t + 8) * WS], wk[(2 * t + 9) * WS]);
      ak[3] = pack(wk[(2 * t + 8) * WS + 8], wk[(2 * t + 9) * WS + 8]);
      wg_fence();
      reg_fence(part);
      wgmma_bf16(part, ak, b_desc(bb + 8 * kw), kw > 0);  // fresh per stage
      wg_commit();
      reg_fence(part);
      wg_wait<1>();   // tap kw-1 is done: its A registers are free
      if (kw == 0) {  // behind the first wgmma: next copies, next transpose
        if (s + NSTAGE - 1 < nstages) load(s + NSTAGE - 1);
        cp_commit();
        if (s + 1 < nstages) transpose_pass(s + 1);
      }
    }
    wg_wait<0>();
    reg_fence(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  cp_wait<0>();

  // acc[4n + r]: channel wrow + g (+8 for r >= 2), position 8n + 2t (+1
  // for odd r)
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + 8 * n + 2 * t + r;
      const int i = p / wp, j = p - i * wp;
      if (p >= P || j >= w) continue;   // past the map, or a phantom column
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int co = co0 + wrow + g + 8 * hf;
        if (co < Cout)
          out[(((long long)b * Cout + co) * h + i) * w + j] =
              __bfloat16_as_ushort(
                  __float2bfloat16_rn(acc[4 * n + 2 * hf + r]));
      }
    }
  }
}

template <bool TMA_W>
int launch(const bf16_t* xp, const bf16_t* pk, bf16_t* out, int B, int Cin,
           int Cout, int h, int w, cudaStream_t stream) {
  // the buffers exceed the 48 KB of static shared memory: raise the
  // kernel's dynamic limit once per device (before any graph capture: the
  // first call of a process is eager)
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(phase_conv_bf16_kernel<TMA_W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  CUtensorMap wmap{};
  if (TMA_W) {   // pk as (Cout, Cin, 9), boxes of (WS, BK, 3)
    static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
    if (encode == nullptr) {
      cudaDriverEntryPointQueryResult found;
      err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                    reinterpret_cast<void**>(&encode),
                                    cudaEnableDefault, &found);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (found != cudaDriverEntryPointSuccess)
        return static_cast<int>(cudaErrorSymbolNotFound);
    }
    const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
    const cuuint64_t strides[2] = {(cuuint64_t)Cout * 2,
                                   (cuuint64_t)Cin * Cout * 2};
    const cuuint32_t box[3] = {WS, BK, 3};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
               const_cast<bf16_t*>(pk), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((h * (w + 2) + BN - 1) / BN, (Cout + BM - 1) / BM, B);
  phase_conv_bf16_kernel<TMA_W><<<grid, THREADS, SMEM_BYTES, stream>>>(
      xp, pk, out, Cin, Cout, h, w, wmap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns a CUDA error
// code (0 on success); the caller raises on a non-zero result. Requires
// contiguous bfloat16 tensors, B in [1, 65535], h, w, Cin, Cout >= 1 and
// Cin * (h+2) * (w+2) < 2^31 (checked by the Python wrapper).
extern "C" int phase_conv_bf16_launch(const void* xp, const void* pk,
                                      void* out, int B, int Cin, int Cout,
                                      int h, int w, void* stream) {
  // TMA needs a 16-byte aligned base and strides of whole 16 bytes
  const bool tma_w =
      Cout % 8 == 0 && (reinterpret_cast<uintptr_t>(pk) & 15) == 0;
  const bf16_t* x = static_cast<const bf16_t*>(xp);
  const bf16_t* k = static_cast<const bf16_t*>(pk);
  bf16_t* o = static_cast<bf16_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tma_w ? launch<true>(x, k, o, B, Cin, Cout, h, w, s)
               : launch<false>(x, k, o, B, Cin, Cout, h, w, s);
}
