// The decoder's 3x3 VALID convolution of a pre-padded map, as an implicit
// GEMM in flat spatial space on the tensor cores (wgmma), in
// split-precision TF32.
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
// for p = i*wp + j < h*wp. Every tap is a shift of one flat map. The columns
// j in {w, w+1} are phantoms (their taps run across a row end) and are not
// stored: the kernel writes only j < w, straight into out[b, co, i, j]
// (B, Cout, h, w), so no slice copy follows. The bias stays outside, as in
// JAX (models/layers.py:109).
//
// Arithmetic: 3xTF32. Every float32 operand a is split into hi = rna(a) and
// lo = rna(a - hi), both TF32 (rna: to nearest, ties away, as
// cvt.rna.tf32.f32 rounds, here as (bits + 0x1000) & ~0x1fff). Each product
// is taken as hi*lo + lo*hi + hi*hi on the tensor cores; lo*lo (below
// 2^-22 of the product) is dropped. The tensor cores truncate as they
// accumulate, and summed over all 9*Cin products in one accumulator that
// bias grows with Cin (examples/gpu_tensor_peaks.py measures it). So each
// stage's products (16 channels x 3 taps) go into a fresh accumulator that
// is added to the running float32 sum with a rounded FADD: ~1e-6 of the
// largest output against the nine-matmul plain version, as float32 FFMA
// gives. One TF32 product alone misses chip_smoke.py's 1e-4 gate by 3x.
//
// Instruction: wgmma.mma_async m64n128k8 .tf32, A (the weights) from
// registers, B (the input) from shared memory. wgmma reads B K-major: the
// 8 channels of one position as two 16-byte halves. So each stage's input
// rows are split and transposed once into that layout without a swizzle
// (positions 16 bytes apart, both halves LBO apart), and a tap's shift of
// one or two positions is a move of 16 or 32 bytes of the descriptor's
// start: the three kw taps read one buffer. (A swizzled tile cannot be
// entered 4 or 8 bytes in; here a shift is always whole rows.) Each warp
// splits its 16 rows of A in registers per 8-channel step.
//
// Tiles. A block computes BM = 128 output channels (M, two warpgroups of
// 64) x BN = 128 flat positions (N) of one image; grid: position tiles,
// channel tiles, batch. K runs over (input channel chunk of BK = 16, tap row
// kh); per stage a warpgroup issues 3 kw x 2 channel steps x 3 = 18 wgmmas,
// two steps in flight (two sets of A registers). 64 accumulators and 64
// stage sums a thread (168 registers with TMA weights, 196 without): one
// block of 256 threads per SM.
//
// Copy ring. NSTAGE = 4 stages, each the raw weights of the three kw taps
// (3 x BK x (BM + 8): the 8 extra columns give the rows a conflict-free
// stride) and one input row of BN + 2 positions, + up to 3 of alignment,
// per channel; then NBBUF = 2 split, transposed input buffers: 174,720
// bytes of dynamic shared memory. While stage s is multiplied, stage s+1
// is split into the other buffer and stages s+2 and s+3 are in flight; one
// __syncthreads per stage. The split of stage s+1 and the copies of stage
// s+3 are issued behind stage s's first wgmmas, so the tensor cores are
// not idle while they run.
// - Weights: one TMA bulk copy per stage (cp.async.bulk.tensor, a (136,
//   16, 3) box of pk seen as (Cout, Cin, 9)), completing on the ring slot's
//   mbarrier; the box's parts past Cout and Cin arrive as zeros. One copy
//   in place of 1,536 16-byte cp.asyncs a stage: those cost more than
//   anything else in a stage (up1 at B=64 on an H100 at 700 W: 9.20 ms
//   with them, 8.27 ms with TMA). Where TMA
//   cannot address pk (Cout % 4 != 0, or pk not 16-byte aligned), 4-byte
//   cp.asyncs with zero fill.
// - Input rows: cp.async. A row starts at p0 + kh*wp, anywhere relative to
//   16 bytes, and at ragged shapes a channel's base is unaligned too (5x7
//   map: L = 63): the row is copied from the 16-byte boundary below its
//   start, in whole 16-byte chunks, and read at that offset (0-3 floats,
//   per channel). A chunk across a channel's start or end is copied as
//   4-byte cp.asyncs, and what lies outside the channel is zero-filled
//   (src-size 0), as are channels past Cin.
// Nothing is padded in a copy in device memory.
//
// Shared-memory banks: raw weight and input rows are 136 floats apart (8
// mod 32), so a warp's A fragment load touches 32 distinct banks; the split
// buffer's four channel quads are 552 floats apart (8 mod 32), so the
// transposing 16-byte stores of a warp fill all banks.
//
// Bounds on the H100 (B=64; chip_smoke.conv_bound_ms). FFMA: 2*9*B*h*w*Cin*
// Cout operations at 67 TFLOP/s, 10.38 ms at up1 (24x24, 1024 -> 4*256),
// 2.60 ms at up2 (48x48, 256 -> 4*64) and at up3 (96x96, 64 -> 4*64). This
// kernel's own arithmetic: three TF32 products per product at 494.7 TFLOP/s
// dense, 4.22 ms at up1, 1.05 ms at up2 and at up3. The bytes (input,
// weights, output once) take 0.11-0.23 ms: operations-bound.
//
// What held the FFMA version back, and what this design does:
// - No overlap (all threads staged each 4-channel chunk through registers,
//   then waited at two barriers): the copy ring keeps two stages in flight
//   and one being split behind the one being multiplied, one barrier per
//   16 channels and tap row.
// - 10 shared loads per 64 FFMAs: a warp loads 4 words and a warpgroup
//   issues 3 wgmmas (196,608 multiply-adds) per 8-channel step.
// - The FFMA ceiling (cuDNN already ran at 65% of it): the products run on
//   the tensor cores, whose 3xTF32 bound is 2.5x lower than the FFMA bound.
// Left for later: the flat space adds (w+2)/w of work (8.3% at w=24), and
// the one block per SM still waits at each stage's barrier.
//
// Host side: the TMA descriptor of pk is encoded per launch
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library links against the runtime only) and passed as a __grid_constant__
// parameter.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output channels per block (M)
constexpr int BN = 128;      // flat positions per block (N)
constexpr int BK = 16;       // input channels per stage
constexpr int KSTEPS = BK / 8;   // wgmma depth 8: channel steps per kw tap
constexpr int NSTAGE = 4;    // stages in the cp.async ring
constexpr int NBBUF = 2;     // split input buffers
constexpr int THREADS = 256; // two warpgroups
constexpr int WS = BM + 8;   // raw weight row stride in floats (8 mod 32)
constexpr int XS = BN + 8;   // raw input row: BN + 2 taps + 3 alignment
constexpr int XCHUNKS = XS / 4;       // 16-byte chunks per raw input row
constexpr int W_FLOATS = 3 * BK * WS;             // ws[kw][c][m]
constexpr int STAGE_FLOATS = W_FLOATS + BK * XS;  // + xs[c][u]
constexpr int BROWS = BN + 2;         // split input rows: the tile + shifts
constexpr int BQ = (BROWS + 8) * 4;   // floats per channel quad (8 mod 32)
// one split buffer: [hi / lo][channel step ks][K half][row][4 channels]
constexpr int BBUF_FLOATS = 2 * KSTEPS * 2 * BQ;
// + 128: the dynamic shared memory is aligned up to 128 bytes for TMA
constexpr int SMEM_BYTES =
    (NSTAGE * STAGE_FLOATS + NBBUF * BBUF_FLOATS) * 4 + 128;

static_assert(WS % 32 == 8 && XS % 32 == 8 && BQ % 32 == 8,
              "conflict-free shared-memory access");
static_assert(XS >= BN + 2 + 3, "row holds the tile, kw shifts, alignment");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, of which the first `bytes` (16 or 0) come from
// src and the rest are zero.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes to shared memory from src, or zero when `bytes` is 0.
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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
__device__ __forceinline__ void tma_load3(float* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// Floats between element q of the channel starting at `row` and the 16-byte
// boundary at or below it.
__device__ __forceinline__ int misalign(const float* row, int q) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) +
                          static_cast<uintptr_t>(q)) & 3;
}

// a rounded to TF32, to nearest with ties away from zero (cvt.rna's
// rounding): add half of the 13 dropped bits to the magnitude, then clear
// them; a carry moves into the exponent as it should.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32, as the tensor cores read them.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// wgmma descriptor of a K-major B tile without swizzle: rows (positions)
// 16 bytes apart, 8-row groups SBO = 128 bytes apart, the two 4-channel
// halves of K LBO = one channel quad apart.
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((BQ * 4) >> 4) << 16) |
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

// d (+)= a (64x8 TF32, registers) * B (8x128 TF32, descriptor); d starts
// from zero when `accumulate` is 0.
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

template <bool TMA_W>
__global__ void __launch_bounds__(THREADS, 1)
phase_conv_kernel(const float* __restrict__ xp,   // (B, Cin, h+2, w+2)
                  const float* __restrict__ pk,   // (3, 3, Cin, Cout)
                  float* __restrict__ out,        // (B, Cout, h, w)
                  int Cin, int Cout, int h, int w,
                  const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ __align__(128) float smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* bbuf = smem + NSTAGE * STAGE_FLOATS;
  __shared__ uint64_t wbar[NSTAGE];   // ring slot s: stage s's weights

  const int wp = w + 2;
  const int L = (h + 2) * wp;    // flat input length of one channel
  const int P = h * wp;          // flat output positions, phantoms included
  const int p0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const float* xb = xp + (long long)b * Cin * L;
  const int nstages = 3 * ((Cin + BK - 1) / BK);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row / column group
  const int wrow = warp * 16;   // this warp's 16 of the block's channels

  // Stage s: input channels [BK*(s/3), +BK), tap row kh = s % 3, into ring
  // slot s % NSTAGE.
  auto load = [&](int s) {
    float* ws = smem + (s % NSTAGE) * STAGE_FLOATS;
    float* xs = ws + W_FLOATS;
    const int ci0 = (s / 3) * BK, kh = s % 3;
    // ws[kw][c][m] = pk[kh][kw][ci0 + c][co0 + m]
    if (TMA_W) {
      if (threadIdx.x == 0) {
        mbar_expect(&wbar[s % NSTAGE], W_FLOATS * 4);
        tma_load3(ws, &wmap, co0, ci0, 3 * kh, &wbar[s % NSTAGE]);
      }
      __syncwarp();
    } else {
      for (int e = threadIdx.x; e < 3 * BK * BM; e += THREADS) {
        const int m = e % BM, c = (e / BM) % BK, kw = e / (BK * BM);
        const int ci = ci0 + c, co = co0 + m;
        const bool ok = ci < Cin && co < Cout;
        cp4(ws + (kw * BK + c) * WS + m,
            ok ? pk + ((long long)(kh * 3 + kw) * Cin + ci) * Cout + co : pk,
            ok ? 4 : 0);
      }
    }
    // xs[c][u] = xp_flat[b, ci0 + c, q0 - a + u], a = misalign(row, q0)
    const int q0 = p0 + kh * wp;
    for (int e = threadIdx.x; e < BK * XCHUNKS; e += THREADS) {
      const int k = e % XCHUNKS, c = e / XCHUNKS, ci = ci0 + c;
      float* dst = xs + c * XS + 4 * k;
      const float* row = xb + (long long)ci * L;
      const int r = q0 - misalign(row, q0) + 4 * k;   // first element, >= -3
      if (ci >= Cin || r >= L) {
        cp16(dst, xp, 0);
      } else if (r >= 0 && r + 4 <= L) {
        cp16(dst, row + r, 16);
      } else {   // a chunk across the channel's start or end, elementwise
        for (int u = 0; u < 4; ++u) {
          const bool ok = r + u >= 0 && r + u < L;
          cp4(dst + u, ok ? row + r + u : xp, ok ? 4 : 0);
        }
      }
    }
  };

  // Stage s's raw input rows, split and transposed: bb[hl][ks][half][row]
  // holds channels 8*ks + 4*half + (0..3) of position q0 + row.
  auto split_pass = [&](int s) {
    const float* xs = smem + (s % NSTAGE) * STAGE_FLOATS + W_FLOATS;
    float* bb = bbuf + (s % NBBUF) * BBUF_FLOATS;
    const int ci0 = (s / 3) * BK;
    const int q0 = p0 + (s % 3) * wp;
    for (int e = threadIdx.x; e < 2 * KSTEPS * BROWS; e += THREADS) {
      const int quad = e / BROWS, row = e % BROWS;   // quad = 2*ks + half
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * quad + u;
        split_tf32(
            xs[c * XS + misalign(xb + (long long)(ci0 + c) * L, q0) + row],
            hi[u], lo[u]);
      }
      *reinterpret_cast<uint4*>(bb + quad * BQ + row * 4) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(bb + (2 * KSTEPS + quad) * BQ + row * 4) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
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
  uint32_t ah[2][4], al[2][4];   // A of two channel steps in flight

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nstages) load(s);
    cp_commit();
  }
  cp_wait<NSTAGE - 2>();
  __syncthreads();
  split_pass(0);

  for (int s = 0; s < nstages; ++s) {
    cp_wait<NSTAGE - 3>();   // this thread's copies of stage s+1 landed
    if (TMA_W)               // stage s's weights (parity: the slot's use)
      mbar_wait(&wbar[s % NSTAGE], (s / NSTAGE) & 1);
    // the split stores of stage s reach the wgmmas (async proxy), and all
    // reads of the slot the next TMA overwrites come before it; everyone's
    // copies landed; every warpgroup's wgmmas of stage s-1 are done with
    // the buffer that stage s+1 is split into
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const float* ws = smem + (s % NSTAGE) * STAGE_FLOATS;
    const float* bb = bbuf + (s % NBBUF) * BBUF_FLOATS;
#pragma unroll
    for (int j = 0; j < 3 * KSTEPS; ++j) {   // step j = (kw, ks)
      const int kw = j / KSTEPS, ks = j % KSTEPS;
      const float* wk = ws + (kw * BK + 8 * ks) * WS + wrow + g;
      uint32_t* a_hi = ah[j % 2];
      uint32_t* a_lo = al[j % 2];
      split_tf32(wk[t * WS], a_hi[0], a_lo[0]);
      split_tf32(wk[t * WS + 8], a_hi[1], a_lo[1]);
      split_tf32(wk[(t + 4) * WS], a_hi[2], a_lo[2]);
      split_tf32(wk[(t + 4) * WS + 8], a_hi[3], a_lo[3]);
      const uint64_t b_hi = b_desc(bb + 2 * ks * BQ + 4 * kw);
      const uint64_t b_lo = b_desc(bb + (2 * KSTEPS + 2 * ks) * BQ + 4 * kw);
      wg_fence();
      reg_fence(part);
      wgmma_tf32(part, a_hi, b_lo, j > 0);   // a fresh sum per stage
      wgmma_tf32(part, a_lo, b_hi, 1);
      wgmma_tf32(part, a_hi, b_hi, 1);
      wg_commit();
      reg_fence(part);
      wg_wait<1>();   // step j-1 is done: its A registers are free
      if (j == 0) {   // behind the first wgmmas: next copies, next split
        if (s + NSTAGE - 1 < nstages) load(s + NSTAGE - 1);
        cp_commit();
        if (s + 1 < nstages) split_pass(s + 1);
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
              acc[4 * n + 2 * hf + r];
      }
    }
  }
}

template <bool TMA_W>
int launch(const float* xp, const float* pk, float* out, int B, int Cin,
           int Cout, int h, int w, cudaStream_t stream) {
  // the buffers exceed the 48 KB of static shared memory: raise the
  // kernel's dynamic limit once per device (before any graph capture: the
  // first call of a process is eager)
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(phase_conv_kernel<TMA_W>,
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
    const cuuint64_t strides[2] = {(cuuint64_t)Cout * 4,
                                   (cuuint64_t)Cin * Cout * 4};
    const cuuint32_t box[3] = {WS, BK, 3};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
               const_cast<float*>(pk), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((h * (w + 2) + BN - 1) / BN, (Cout + BM - 1) / BM, B);
  phase_conv_kernel<TMA_W><<<grid, THREADS, SMEM_BYTES, stream>>>(
      xp, pk, out, Cin, Cout, h, w, wmap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns a CUDA error
// code (0 on success); the caller raises on a non-zero result. Requires
// contiguous float32 tensors, B in [1, 65535], h, w, Cin, Cout >= 1 and
// Cin * (h+2) * (w+2) < 2^31 (checked by the Python wrapper).
extern "C" int phase_conv_launch(const float* xp, const float* pk, float* out,
                                 int B, int Cin, int Cout, int h, int w,
                                 void* stream) {
  // TMA needs a 16-byte aligned base and strides of whole 16 bytes
  const bool tma_w =
      Cout % 4 == 0 && (reinterpret_cast<uintptr_t>(pk) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tma_w ? launch<true>(xp, pk, out, B, Cin, Cout, h, w, s)
               : launch<false>(xp, pk, out, B, Cin, Cout, h, w, s);
}
