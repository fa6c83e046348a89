// The decoder's 3x3 VALID convolution of a pre-padded map in bfloat16: the
// bf16 route of kernel 6, an implicit GEMM in flat spatial space on the
// tensor cores (wgmma, bf16 products, float32 sums).
//
// Replaces the Pallas TPU kernel `_conv_kernel`
// (densefusion_tpu/ops/phase_conv.py:72) for bf16 operands, as the JAX
// package runs it under bf16 compute: bf16 x bf16 products summed in
// float32 (`preferred_element_type=jnp.float32`, :96) and rounded once to
// bf16 (`acc.astype(o_ref.dtype)`, :104). With xp the (B, Cin, h+2, w+2)
// padded input, stored channels-last (the JAX kernel's NHWC), pk the
// (3, 3, Cin, Cout) HWIO kernel, wp = w + 2 and
// xp_flat[b, q, c] = xp[b, c, q / wp, q % wp]:
//
//   out_flat[b, co, p] = bf16(sum_{kh, kw, ci}
//                        xp_flat[b, p + kh*wp + kw, ci] * pk[kh, kw, ci, co])
//
// for p = i*wp + j < h*wp, stored to the (B, Cout, h, w) NCHW output; the
// phantom columns j in {w, w+1} are not stored, and the bias stays outside,
// as in JAX (models/layers.py:109). The float32 route is csrc/phase_conv.cu
// (3xTF32); this file shares no code with it, so that route's source and
// build stay as they were.
//
// Arithmetic: a bf16 x bf16 product is exact in float32, so there is no
// truncation bias to fold away (the float32 route's reason for a fresh
// accumulator per stage): every product goes into one float32 accumulator
// chain from the first stage to the last, rounded once to bf16 (round to
// nearest even). On an H100 every output lies within 1 bf16 ulp of the
// plain version (float32 sums in another order, one rounding) at every
// decoder and ragged shape, up1's K = 9 x 1024 included (chip_smoke.py
// [4l], tests/test_torch_cuda.py), so the one chain is kept.
//
// GEMM: M = Cout (BM = 128 a tile, 64 per consumer warpgroup), N = an
// image's flat positions p (BN of them a tile; the phantom columns are
// computed and not stored), K = (channel chunk of BKC = 32, kh, kw). A
// stage is one (chunk, kh): 3 kw x 2 wgmma m64nBNk16 a warpgroup.
// BN is 256, 240 or 208, whichever leaves the fewest positions computed on
// the busiest SM (rounds of tiles over the SMs times BN): 208 at up1 (3
// tiles of 8 rows of 26 an image, none ragged), 240 at up2 (10 an image,
// exact), 256 at up3.
// Both operands come from shared memory by descriptor, in 64-byte rows
// with the 64-byte swizzle, each written by TMA straight from pk and from
// the map:
// - B (the input) is K-major: a position's 32 channels are one 64-byte
//   row (the channels-last map makes it one TMA box of 32 channels x
//   (BN / 2 + 8) positions, two a stage), so nothing is transposed. A kw
//   shift of one position moves the descriptor's start one row into a
//   swizzle pattern, with the base offset left 0, and the three kw taps
//   read one buffer of BN + 16 rows.
// - A (the weights) is M-major (tnspA, allowed for bf16): pk's rows hold
//   Cout contiguous, so a box of 32 output channels x 32 input channels x
//   3 kw taps is [kw][ci][32 co] in 64-byte rows; four boxes make the 128
//   channels.
// Why 64-byte rows: each copy then reads whole 32-byte sectors of L2. An
// unswizzled layout needs 16-byte rows (8 channels), each of which fetched
// a sector and used half of it; the copies alone then took as long as the
// whole kernel. Why both operands by descriptor: A fragments loaded into
// registers (ldmatrix) inside the pipeline made ptxas serialize the
// wgmmas (its C7513 warning).
//
// Pipeline: persistent blocks, one a SM, walk the tiles (output channels
// fastest, so the blocks in flight share their input rows in L2) through a
// ring of NSTAGE = 5 stages (41,984 bytes each at BN = 256) with full and
// empty mbarriers. One producer warp issues every copy and runs ahead into
// the next tile while the consumers store this one; two consumer
// warpgroups issue their 6 wgmmas a stage back to back and keep one stage
// in flight (wgmma.wait_group 1), each warp releasing the slot of the
// stage before. No __syncthreads in the main loop.
// Epilogue: each consumer warp rounds its 16 channels x 64 positions at a
// time into a staging buffer of its own, then stores them channel by
// channel, two positions a lane, so a warp store covers 128 contiguous
// bytes of the flat map less its phantom columns. Stored straight from the
// accumulator fragments (8 channels x 16 bytes a warp store) the output,
// 302 MB at up3, took most of that shape's time.
// Where the time goes now: examples/gpu_phase_conv_bf16_probe.py times
// the kernel against copies of itself without the wgmmas, the copies or
// the stores.
//
// L2 bytes per operation: a stage reads 24,576 bytes of weights and
// 2 * (BN / 2 + 8) * 64 of input from L2 for 2 * 128 * BN * 32 * 3
// operations: 150 FLOP a byte at BN = 256, 131 at 208, where the earlier
// 128 x 128 tile read 92. At the dense bf16 peak the SMs would pull
// 6.6-7.5 TB/s from L2 at these tiles. A 2-block cluster that multicast
// each weight box to both blocks (one third fewer bytes a stage) was exact
// but slower at every shape, and was not kept.
// Copy paths: where TMA cannot address an operand (Cin % 8 != 0 for the
// input, Cout % 8 != 0 for the weights, or a base not 16-byte aligned) the
// producer warp loads it with plain loads into the same swizzled layout,
// zeros past Cin, Cout and the map; TMA fills zeros past them itself.
// Registers: ptxas holds the 288 threads to 168 registers a thread; the
// build's -Xptxas -v shows no spills.
//
// Bound on the H100 (examples/kernel_bounds.py, chip_smoke.py [4l]):
// 2*9*B*h*w*Cin*Cout operations at the dense bf16 peak of 989 TFLOP/s,
// 0.703 ms at up1 (B=64, 24x24, 1024 -> 4*256), 0.176 ms at up2 (48x48,
// 256 -> 4*64) and at up3 (96x96, 64 -> 4*64); the bytes (bf16 input,
// weights and output once) take 0.04-0.11 ms: operations-bound.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint16_t bf16_t;   // raw bfloat16 bits

constexpr int BM = 128;      // output channels per tile (M)
constexpr int BKC = 32;      // input channels per stage: one 64-byte row
constexpr int NSTAGE = 5;    // stages in the ring
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 32;    // + the producer warp
constexpr int MG = 32;       // output channels per weight row (64 bytes)
constexpr int MG_ELEMS = 3 * BKC * MG;     // one box: [kw][ci][32 co]
constexpr int A_ELEMS = (BM / MG) * MG_ELEMS;   // sa[co / 32][kw][ci][co % 32]
constexpr int A_BYTES = A_ELEMS * 2;
constexpr int EPW = 64;                    // positions a warp stages at once
constexpr int ESTRIDE = EPW + 8;           // its row stride: no bank conflicts
constexpr int E_ELEMS = 16 * ESTRIDE;      // one warp's staging buffer

// The shape of a tile BN positions wide: the input rows it reads (BN + 2
// shifts, in two TMA boxes of XBOX) and the ring.
template <int BN>
struct Tile {
  static constexpr int XBOX = BN / 2 + 8;       // positions per input box
  static constexpr int XROWS = 2 * XBOX;
  static constexpr int B_ELEMS = XROWS * BKC;   // sb[row][ci]
  static constexpr int B_BYTES = B_ELEMS * 2;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  // + the consumer warps' staging buffers; + 1024: the dynamic shared
  // memory is aligned up to the swizzle's span
  static constexpr int SMEM_BYTES =
      (NSTAGE * STAGE_ELEMS + (CONSUMERS / 32) * E_ELEMS) * 2 + 1024;
  static_assert(BN % 16 == 0 && BN <= 256 && XROWS >= BN + 2,
                "rows: tile and shifts");
  static_assert((MG_ELEMS * 2) % 512 == 0 && (XBOX * BKC * 2) % 512 == 0 &&
                    (A_BYTES % 1024) == 0 && (STAGE_ELEMS * 2) % 1024 == 0,
                "TMA destinations on whole 8-row (512-byte) swizzle "
                "patterns");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA data in this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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

// The box of `map` at coordinates (c0, c1) / (c0, c1, c2) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

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

// Generic-proxy stores to shared memory made visible to the async proxy
// (the wgmmas' reads).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 64-byte swizzle of a byte offset from a 1024-byte aligned base, as
// TMA writes it: the 16-byte unit (bits 4-5) XOR bits 7-8.
__device__ __forceinline__ int swz64(int o) { return o ^ (((o >> 7) & 3) << 4); }

// wgmma descriptor of a tile in 64-byte swizzled rows (layout type 2): LBO
// and SBO in bytes. The base offset (bits 49-51) stays 0: the swizzle is
// that of the absolute address, as TMA wrote it on pattern-aligned
// buffers, so a start one or two rows into a pattern reads the right bytes
// (measured: exact at every kw; the PTX formula (addr >> 7) & 7 gave
// wrong sums).
__device__ __forceinline__ uint64_t desc(const bf16_t* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)2 << 62);
}

// A, M-major: 32-channel (64-byte) rows along M, LBO = one box apart; K
// rows 64 bytes apart, 8-row groups SBO = 512 bytes apart.
__device__ __forceinline__ uint64_t a_desc(const bf16_t* p) {
  return desc(p, MG_ELEMS * 2, 512);
}

// B, K-major: a position's 32 channels in one 64-byte row, 8-row groups
// SBO = 512 bytes apart (LBO unused).
__device__ __forceinline__ uint64_t b_desc(const bf16_t* p) {
  return desc(p, 16, 512);
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

// d += A (64x16 bf16, M-major descriptor) * B (16xN bf16, K-major
// descriptor), both 64-byte swizzled: the one instruction at the three tile
// widths.
template <int N>
struct Wgmma;

template <>
struct Wgmma<208> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103}, "
        "%104, %105, p, 1, 1, 1, 0;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<240> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119}, "
        "%120, %121, p, 1, 1, 1, 0;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 1, 0;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int BN, bool TMA_X, bool TMA_W>
__global__ void __launch_bounds__(THREADS, 1)
phase_conv_bf16_kernel(const bf16_t* __restrict__ xp,  // (B, h+2, w+2, Cin)
                       const bf16_t* __restrict__ pk,  // (3, 3, Cin, Cout)
                       bf16_t* __restrict__ out,       // (B, Cout, h, w)
                       int B, int Cin, int Cout, int h, int w,
                       const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap) {
  typedef Tile<BN> T;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16_t* smem = reinterpret_cast<bf16_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ uint64_t full[NSTAGE], empty[NSTAGE];

  const int wp = w + 2;
  const int L = (h + 2) * wp;    // flat positions of one padded image
  const int P = h * wp;          // flat output positions, phantoms included
  const int nco = (Cout + BM - 1) / BM;
  const int per_image = (P + BN - 1) / BN;
  const int ntiles = B * per_image * nco;
  const int nstages = 3 * ((Cin + BKC - 1) / BKC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // tile t: output channels co0 = (t % nco) * BM (fastest: the blocks in
  // flight share their input rows), image b, positions p0 .. p0 + BN - 1
  auto decode = [&](int t, int& co0, int& b, int& p0) {
    co0 = (t % nco) * BM;
    const int r = t / nco;
    b = r / per_image;
    p0 = (r - b * per_image) * BN;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < NSTAGE; ++i) {
      mbar_init(&full[i], 1);                 // the producer's arrival
      mbar_init(&empty[i], CONSUMERS / 32);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // Producer. Stage s of a tile: input channels [BKC*(s/3), +BKC), tap
    // row kh = s % 3; the block's it-th stage goes to ring slot
    // it % NSTAGE.
    int it = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int co0, b, p0;
      decode(t, co0, b, p0);
      for (int s = 0; s < nstages; ++s, ++it) {
        const int slot = it % NSTAGE;
        if (it >= NSTAGE) mbar_wait(&empty[slot], ((it / NSTAGE) - 1) & 1);
        bf16_t* sa = smem + slot * T::STAGE_ELEMS;
        bf16_t* sb = sa + A_ELEMS;
        const int ci0 = (s / 3) * BKC, kh = s % 3;
        // the flat batch position of B's row 0; rows past the image feed
        // only outputs that are not stored
        const int q0 = b * L + p0 + kh * wp;
        if (!TMA_W) {   // sa[m / 32][kw][c][m % 32] = pk[kh][kw][ci0 + c][co0 + m]
          for (int e = lane; e < A_ELEMS; e += 32) {
            const int u = e % MG, c = (e / MG) % BKC,
                      kw = (e / (MG * BKC)) % 3, grp = e / MG_ELEMS;
            const int ci = ci0 + c, co = co0 + MG * grp + u;
            sa[swz64(2 * e) / 2] =
                ci < Cin && co < Cout
                    ? pk[((long long)(kh * 3 + kw) * Cin + ci) * Cout + co]
                    : bf16_t(0);
          }
        }
        if (!TMA_X) {   // sb[r][c] = xp_flat[q0 + r, ci0 + c]
          for (int e = lane; e < T::B_ELEMS; e += 32) {
            const int c = e % BKC, r = e / BKC;
            const int ci = ci0 + c, q = q0 + r;
            sb[swz64(2 * e) / 2] =
                ci < Cin && q < B * L ? xp[(long long)q * Cin + ci]
                                      : bf16_t(0);
          }
        }
        if (!TMA_W || !TMA_X) fence_async_smem();
        __syncwarp();
        if (lane == 0) {
          mbar_expect(&full[slot],
                      (TMA_W ? A_BYTES : 0) + (TMA_X ? T::B_BYTES : 0));
          if (TMA_W) {
#pragma unroll
            for (int k = 0; k < BM / MG; ++k)
              tma_load3(sa + k * MG_ELEMS, &wmap, co0 + MG * k, ci0, 3 * kh,
                        &full[slot]);
          }
          if (TMA_X) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
              tma_load2(sb + r * T::XBOX * BKC, &xmap, ci0, q0 + r * T::XBOX,
                        &full[slot]);
          }
        }
      }
    }
    return;
  }

  // Consumers: warp w computes output channels co0 + 16w + (0..15), its
  // warpgroup the 64 from co0 + 64 (w / 4).
  const int g = lane >> 2, tq = lane & 3;   // fragment row / column group
  const int a_off = (warp / 4) * (64 / MG) * MG_ELEMS;   // its 64 channels
  bf16_t* stage = smem + NSTAGE * T::STAGE_ELEMS + warp * E_ELEMS;
  float acc[BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int co0, b, p0;
    decode(t, co0, b, p0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < nstages; ++s, ++it) {
      const int slot = it % NSTAGE;
      mbar_wait(&full[slot], (it / NSTAGE) & 1);
      const bf16_t* sa = smem + slot * T::STAGE_ELEMS + a_off;
      const bf16_t* sb = smem + slot * T::STAGE_ELEMS + A_ELEMS;
      wg_fence();
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          Wgmma<BN>::run(acc, a_desc(sa + (kw * BKC + 16 * j) * MG),
                         b_desc(sb + kw * BKC + 16 * j));
      wg_commit();
      wg_wait<1>();   // the stage before is done with its slot
      if (s > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % NSTAGE]);
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % NSTAGE]);

    // acc[4n + 2hf + r]: channel co0 + 16 warp + g + 8hf, position
    // p0 + 8n + 2tq + r of image b. Each pass: the warp's 16 channels x EPW
    // positions [pa, pb) into its staging buffer, then along output rows.
    const int co_w = co0 + 16 * warp;
    bf16_t* ob = out + (long long)b * Cout * h * w;
#pragma unroll
    for (int ps = 0; ps < (BN + EPW - 1) / EPW; ++ps) {
      const int pa = p0 + EPW * ps;
      if (pa >= P) break;
      const int pb = min(min(pa + EPW, p0 + BN), P);
      __syncwarp();   // the last pass's reads are done
#pragma unroll
      for (int nn = 0; nn < EPW / 8; ++nn) {
        const int n = (EPW / 8) * ps + nn;
        if (n < BN / 8) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<__nv_bfloat162*>(
                stage + (g + 8 * hf) * ESTRIDE + 8 * nn + 2 * tq) =
                __floats2bfloat162_rn(acc[4 * n + 2 * hf],
                                      acc[4 * n + 2 * hf + 1]);
        }
      }
      __syncwarp();
      // lane l stores positions pa + 2l and pa + 2l + 1 of each channel: a
      // warp store covers 128 contiguous bytes of the flat map, less the
      // phantom columns (w even: a pair lies in one row, both or neither)
      const int q = pa + 2 * lane, nr = min(16, Cout - co_w);
      const bf16_t* src = stage + 2 * lane;
      if (w % 2 == 0) {
        const int i = q / wp, j = q - i * wp;
        if (q < pb && j < w) {
          bf16_t* dst = ob + ((long long)co_w * h + i) * w + j;
#pragma unroll 4
          for (int r = 0; r < nr; ++r)
            *reinterpret_cast<uint32_t*>(dst + (long long)r * h * w) =
                *reinterpret_cast<const uint32_t*>(src + r * ESTRIDE);
        }
      } else {
        for (int u = 0; u < 2; ++u) {
          const int i = (q + u) / wp, j = q + u - i * wp;
          if (q + u >= pb || j >= w) continue;
          bf16_t* dst = ob + ((long long)co_w * h + i) * w + j;
          for (int r = 0; r < nr; ++r)
            dst[(long long)r * h * w] = src[r * ESTRIDE + u];
        }
      }
    }
  }
}

// A tiled bf16 tensor map of `rank` dims, 64-byte swizzled; zeros outside.
int encode(CUtensorMap* map, int rank, const void* base,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&fn),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess)
      return static_cast<int>(cudaErrorSymbolNotFound);
  }
  const cuuint32_t unit[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
         const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The SMs of the current device (cached per device).
int sm_count(int dev) {
  static int sms[64] = {};
  if (dev < 64 && sms[dev] > 0) return sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n < 1)
    n = 1;
  if (dev < 64) sms[dev] = n;
  return n;
}

template <int BN, bool TMA_X, bool TMA_W>
int launch(const bf16_t* xp, const bf16_t* pk, bf16_t* out, int B, int Cin,
           int Cout, int h, int w, int dev, int blocks, cudaStream_t stream) {
  typedef Tile<BN> T;
  // the ring exceeds the 48 KB of static shared memory: raise the
  // kernel's dynamic limit once per device (before any graph capture: the
  // first call of a process is eager)
  static bool raised[64] = {};
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        phase_conv_bf16_kernel<BN, TMA_X, TMA_W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  CUtensorMap xmap{}, wmap{};
  if (TMA_X) {   // xp as (Cin, B*(h+2)*(w+2)), boxes of (BKC, XBOX)
    const cuuint64_t dims[2] = {(cuuint64_t)Cin,
                                (cuuint64_t)B * (h + 2) * (w + 2)};
    const cuuint64_t strides[1] = {(cuuint64_t)Cin * 2};
    const cuuint32_t box[2] = {BKC, T::XBOX};
    const int e = encode(&xmap, 2, xp, dims, strides, box);
    if (e != 0) return e;
  }
  if (TMA_W) {   // pk as (Cout, Cin, 9), boxes of (MG, BKC, 3)
    const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
    const cuuint64_t strides[2] = {(cuuint64_t)Cout * 2,
                                   (cuuint64_t)Cin * Cout * 2};
    const cuuint32_t box[3] = {MG, BKC, 3};
    const int e = encode(&wmap, 3, pk, dims, strides, box);
    if (e != 0) return e;
  }
  phase_conv_bf16_kernel<BN, TMA_X, TMA_W>
      <<<blocks, THREADS, T::SMEM_BYTES, stream>>>(xp, pk, out, B, Cin, Cout,
                                                   h, w, xmap, wmap);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bn(const bf16_t* xp, const bf16_t* pk, bf16_t* out, int B,
              int Cin, int Cout, int h, int w, int dev, int blocks,
              cudaStream_t stream) {
  // TMA needs a 16-byte aligned base and strides of whole 16 bytes
  const bool tma_x =
      Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(xp) & 15) == 0;
  const bool tma_w =
      Cout % 8 == 0 && (reinterpret_cast<uintptr_t>(pk) & 15) == 0;
  if (tma_x)
    return tma_w ? launch<BN, true, true>(xp, pk, out, B, Cin, Cout, h, w,
                                          dev, blocks, stream)
                 : launch<BN, true, false>(xp, pk, out, B, Cin, Cout, h, w,
                                           dev, blocks, stream);
  return tma_w ? launch<BN, false, true>(xp, pk, out, B, Cin, Cout, h, w,
                                         dev, blocks, stream)
               : launch<BN, false, false>(xp, pk, out, B, Cin, Cout, h, w,
                                          dev, blocks, stream);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns a CUDA error
// code (0 on success); the caller raises on a non-zero result. Requires a
// channels-last xp ((B, h+2, w+2, Cin) in memory) and a contiguous pk and
// out, all bfloat16, h, w, Cin, Cout >= 1, B >= 1, Cin * (h+2) * (w+2)
// < 2^31 and B * (h+2) * (w+2) < 2^31 - 2^10 (checked by the Python
// wrapper).
extern "C" int phase_conv_bf16_launch(const void* xp, const void* pk,
                                      void* out, int B, int Cin, int Cout,
                                      int h, int w, void* stream) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(dev);
  // the tile width with the fewest positions on the busiest SM: rounds of
  // tiles over the SMs times BN (the wider on a tie)
  const int widths[3] = {256, 240, 208};
  const long long P = (long long)h * (w + 2), nco = (Cout + BM - 1) / BM;
  int bn = 256;
  long long best = -1, tiles_bn = 0;
  for (int k = 0; k < 3; ++k) {
    const long long tiles = B * ((P + widths[k] - 1) / widths[k]) * nco;
    const long long cost = (tiles + sms - 1) / sms * widths[k];
    if (best < 0 || cost < best) {
      best = cost;
      bn = widths[k];
      tiles_bn = tiles;
    }
  }
  const int blocks = static_cast<int>(tiles_bn < sms ? tiles_bn : sms);
  const bf16_t* x = static_cast<const bf16_t*>(xp);
  const bf16_t* k = static_cast<const bf16_t*>(pk);
  bf16_t* o = static_cast<bf16_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 208)
    return launch_bn<208>(x, k, o, B, Cin, Cout, h, w, dev, blocks, s);
  if (bn == 240)
    return launch_bn<240>(x, k, o, B, Cin, Cout, h, w, dev, blocks, s);
  return launch_bn<256>(x, k, o, B, Cin, Cout, h, w, dev, blocks, s);
}
