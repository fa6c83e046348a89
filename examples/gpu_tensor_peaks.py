#!/usr/bin/env python3
"""What the tensor cores give kernel 6's 3xTF32 arithmetic on this card.

    python3 examples/gpu_tensor_peaks.py [out.json]

Four measurements, each a small CUDA kernel built here with ``nvcc``
(``sm_90a``) and timed with CUDA events after a warm-up:

1. the TF32 rate of ``mma.sync.m16n8k8`` (8 independent accumulators a
   warp, no loads), the instruction of a first design of kernel 6;
2. the TF32 rate of ``wgmma.mma_async.m64n128k8`` with A from registers and
   B from shared memory (two warpgroups a block, one block per SM, three
   wgmmas per group and one group in flight, as ``csrc/phase_conv.cu``
   issues them);
3. the rate of splitting a float32 into two TF32 parts with
   ``cvt.rna.tf32.f32`` and with the same rounding by integer add and mask
   (the kernel's), in splits per nanosecond per SM, alone on the card;
4. the error of 3xTF32 dot products of length 9*1024 (up1's reduction) on
   the tensor cores, as a share of the largest result against a float64
   reference: all products into one accumulator, and a fresh accumulator
   per 8-deep step added with a rounded float32 FADD.

Prints one JSON object and, given a path, writes it there.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from densefusion_tpu_torch.ops import build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t rna_int(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ uint32_t rna_cvt(float a) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void mma_peak(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = rna_int(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = rna_int(1e-3f * (threadIdx.x - i));
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c) mma(d[c], a, b);
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ void wgmma(float* d, const uint32_t* a,
                                      uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      WGMMA_ACCS "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WGMMA_OUTS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__global__ void __launch_bounds__(256, 1)
wgmma_peak(float* out, int iters) {
  __shared__ __align__(128) float b[2 * 138 * 4];
  for (int i = threadIdx.x; i < 2 * 138 * 4; i += blockDim.x)
    b[i] = __uint_as_float(rna_int(1e-3f * i));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(b));
  const uint64_t desc = ((addr & 0x3FFFF) >> 4) |
                        ((uint64_t)((138 * 16) >> 4) << 16) |
                        ((uint64_t)(128 >> 4) << 32);
  float d[64] = {};
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = rna_int(1e-3f * (threadIdx.x + i));
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma(d, a, desc);
    wgmma(d, a, desc);
    wgmma(d, a, desc);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// 8 independent values a thread, each split once per iteration and
// nudged so the loop cannot be folded
__global__ void split_rate(float* out, int iters, int use_cvt) {
  float x[8];
  uint32_t acc = 0;
  for (int i = 0; i < 8; ++i) x[i] = 1.0f + 1e-3f * (threadIdx.x + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t hi = use_cvt ? rna_cvt(x[i]) : rna_int(x[i]);
      const float rest = x[i] - __uint_as_float(hi);
      const uint32_t lo = use_cvt ? rna_cvt(rest) : rna_int(rest);
      acc += hi ^ lo;
      x[i] = __uint_as_float(__float_as_uint(x[i]) + 1u);
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = __uint_as_float(acc);
}

// One warp a block: C (16 x 8) = A (16 x K) B (K x 8) in 3xTF32, B given
// as Bt (8 x K). fresh = 0: every product into one accumulator; fresh = 1:
// a fresh accumulator per 8-deep step, added with a rounded FADD.
__global__ void dot_3xtf32(const float* A, const float* Bt,
                                      float* C, int K, int fresh) {
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  A += (long long)blockIdx.x * 16 * K;
  Bt += (long long)blockIdx.x * 8 * K;
  float acc[4] = {}, part[4];
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {A[g * K + k0 + t], A[(g + 8) * K + k0 + t],
                         A[g * K + k0 + t + 4], A[(g + 8) * K + k0 + t + 4]};
    const float bv[2] = {Bt[g * K + k0 + t], Bt[g * K + k0 + t + 4]};
    uint32_t ah[4], al[4], bh[2], bl[2];
    for (int i = 0; i < 4; ++i) {
      ah[i] = rna_int(av[i]);
      al[i] = rna_int(av[i] - __uint_as_float(ah[i]));
    }
    for (int i = 0; i < 2; ++i) {
      bh[i] = rna_int(bv[i]);
      bl[i] = rna_int(bv[i] - __uint_as_float(bh[i]));
    }
    float* d = fresh ? part : acc;
    if (fresh) part[0] = part[1] = part[2] = part[3] = 0.f;
    mma(d, ah, bl);
    mma(d, al, bh);
    mma(d, ah, bh);
    if (fresh)
      for (int i = 0; i < 4; ++i) acc[i] += part[i];
  }
  float* c = C + blockIdx.x * 128;
  c[g * 8 + 2 * t] = acc[0];
  c[g * 8 + 2 * t + 1] = acc[1];
  c[(g + 8) * 8 + 2 * t] = acc[2];
  c[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

extern "C" int run_mma_peak(float* out, int blocks, int iters, void* s) {
  mma_peak<<<blocks, 256, 0, (cudaStream_t)s>>>(out, iters);
  return (int)cudaGetLastError();
}
extern "C" int run_wgmma_peak(float* out, int blocks, int iters, void* s) {
  wgmma_peak<<<blocks, 256, 0, (cudaStream_t)s>>>(out, iters);
  return (int)cudaGetLastError();
}
extern "C" int run_split_rate(float* out, int blocks, int iters, int use_cvt,
                              void* s) {
  split_rate<<<blocks, 256, 0, (cudaStream_t)s>>>(out, iters, use_cvt);
  return (int)cudaGetLastError();
}
extern "C" int run_dot(const float* A, const float* Bt, float* C, int n,
                       int K, int fresh, void* s) {
  dot_3xtf32<<<n, 32, 0, (cudaStream_t)s>>>(A, Bt, C, K, fresh);
  return (int)cudaGetLastError();
}
"""


def source() -> str:
    accs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    return (SOURCE.replace("WGMMA_ACCS", f'"{accs}"')
            .replace("WGMMA_OUTS", outs))


def load() -> ctypes.CDLL:
    out = build.BUILD / "examples"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "tensor_peaks.cu", out / "libtensor_peaks.so"
    cu.write_text(source())
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def entry(lib, name: str, nargs_ptr: int, nargs_int: int):
    """``lib.name`` with ``nargs_ptr`` pointers, then ``nargs_int`` ints,
    then the stream; called with the current stream, raising on an error."""
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    lib = load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 256, device="cuda")
    result = {"card": cs.card_line(), "sms": sms}

    iters = 4096
    mma_peak = entry(lib, "run_mma_peak", 1, 2)
    ms = cs.cuda_ms(lambda: mma_peak(out.data_ptr(), 4 * sms, iters),
                    iters=5, warmup=2)
    flops = 2 * 16 * 8 * 8 * 8 * iters * 4 * sms * 8   # 8 chains, 8 warps
    result["mma_sync_tf32_tflops"] = flops / ms / 1e9

    wgmma_peak = entry(lib, "run_wgmma_peak", 1, 2)
    ms = cs.cuda_ms(lambda: wgmma_peak(out.data_ptr(), sms, iters),
                    iters=5, warmup=2)
    flops = 2 * 64 * 128 * 8 * 3 * iters * sms * 2      # 2 warpgroups
    result["wgmma_rs_tf32_tflops"] = flops / ms / 1e9
    result["dense_tf32_peak_tflops"] = cs.PEAK_TF32_FLOPS / 1e12

    split = entry(lib, "run_split_rate", 1, 3)
    rates = {}
    for name, use_cvt in (("cvt.rna", 1), ("integer add and mask", 0)):
        ms = cs.cuda_ms(lambda: split(out.data_ptr(), 8 * sms, iters,
                                      use_cvt), iters=5, warmup=2)
        rates[name] = 8 * iters * 8 * sms * 256 / (ms * 1e6) / sms
    result["splits_per_ns_per_sm"] = rates

    # 3xTF32 dot products of up1's depth: inputs N(0, 1), weights N(0, 1/K)
    k, n = 9 * 1024, 256
    rng = np.random.default_rng(cs.SEED)
    a = rng.standard_normal((n, 16, k)).astype(np.float32)
    bt = (rng.standard_normal((n, 8, k)) / np.sqrt(k)).astype(np.float32)
    want = np.einsum("nik,njk->nij", a.astype(np.float64),
                     bt.astype(np.float64))
    dot = entry(lib, "run_dot", 3, 3)
    a_d, bt_d = torch.from_numpy(a).cuda(), torch.from_numpy(bt).cuda()
    c = torch.empty((n, 16, 8), device="cuda")
    errs = {}
    for name, fresh in (("one accumulator", 0),
                        ("fresh per 8-deep step + FADD", 1)):
        dot(a_d.data_ptr(), bt_d.data_ptr(), c.data_ptr(), n, k, fresh)
        got = c.cpu().numpy().astype(np.float64)
        errs[name] = float(np.abs(got - want).max() / np.abs(want).max())
    result["3xtf32_dot_K9216_rel_err"] = errs

    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(text)


if __name__ == "__main__":
    main()
