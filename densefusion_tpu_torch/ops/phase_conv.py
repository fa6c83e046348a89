"""The decoder's 3x3 VALID convolution of a pre-padded map.

Counterpart of ``densefusion_tpu/ops/phase_conv.py``. Its TPU kernel,
``_conv_kernel`` (``densefusion_tpu/ops/phase_conv.py:72``), becomes the
hand-written Hopper kernel ``csrc/phase_conv.cu`` (wrapper
:data:`phase_conv_kernel`): nine shifted products in flat spatial space,
split-precision TF32 (3xTF32) on the tensor cores into float32 sums, the
two phantom columns per row never stored.

Three routes compute the same function:

- the library convolution, ``F.conv2d`` (the JAX package's
  ``conv3x3_valid_xla``, which leaves it to XLA);
- the kernel's function in plain PyTorch (:func:`conv3x3_valid_plain`, nine
  float32 matmuls), which the CPU tests use and ``chip_smoke.py`` holds the
  kernel to;
- the kernel, through an autograd Function whose forward launches it on
  CUDA tensors (the plain version on CPU tensors) and whose backward is the
  library convolution's, as the JAX package's backward is XLA's
  (``_conv3x3_bwd``). A CUDA tensor launches the kernel or raises.

``"auto"`` is :func:`auto_backend` of the input's device: the kernel on
CUDA, the library convolution on the CPU. Measured, as the JAX package
chose its own ``"auto"`` (XLA, because its Pallas kernel lost on the v5e):
on an NVIDIA H100 80GB HBM3 at 700 W the kernel beat cuDNN's float32
``F.conv2d`` (TF32 off) at all three of the decoder's phase-conv shapes at
B=64 (``chip_smoke.py`` [6]; up1 24x24x1024->1024: 8.26 against 15.57 ms,
up2 48x48x256->256: 2.16 against 4.12 ms, up3 96x96x64->256: 2.43 against
4.05 ms). On the CPU there is no kernel.

The public :func:`conv3x3_valid` keeps the JAX package's NHWC / HWIO
signature; the port's NCHW decoder calls :func:`conv3x3_valid_nchw`, which
pays no transpose.

The kernel route takes float32 or bfloat16 operands, both of one type (the
JAX kernel's ``result_type(xp, pk)``, ``densefusion_tpu/ops/phase_conv.py:
96``). bfloat16 launches its own kernel, ``csrc/phase_conv_bf16.cu``
(wrapper :data:`phase_conv_bf16_kernel`, counted apart): bf16 products on
the tensor cores, float32 sums, the output rounded once to bf16, as the
Pallas kernel's ``preferred_element_type=jnp.float32`` dot and its final
``astype`` compute it. Its plain version upcasts to float32, runs the nine
float32 matmuls and rounds once. The bf16 kernel takes its padded map
channels-last (the JAX kernel's NHWC; the public NHWC
:func:`conv3x3_valid`'s NCHW view already is), so a position's channels
are one row of its K-major tile and nothing is transposed; its wrapper
raises on any other layout, and :func:`replicate_pad` writes the decoder's
padded map so in the one copy the pad makes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from densefusion_tpu_torch.ops import build

BACKENDS = ("auto", "library", "kernel")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _library_nchw(xp: torch.Tensor, pk: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` of the padded NCHW map with the HWIO kernel, VALID."""
    return F.conv2d(xp, pk.permute(3, 2, 0, 1))


def conv3x3_valid_plain_nchw(xp: torch.Tensor,
                             pk: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: xp (B, Cin, h+2, w+2), pk (3, 3, Cin,
    Cout) -> (B, Cout, h, w). Nine shifted matmuls over the flat map into
    one sum, ``out_flat[p] = sum_{kh,kw} pk[kh,kw]^T xp_flat[p + kh*(w+2) +
    kw]``, then the phantom columns dropped. The flat range stops two short
    of ``h*(w+2)`` (the last row's phantoms), so no tap reads past the map.
    bfloat16 operands are summed in float32 and rounded once, as the bf16
    kernel sums them."""
    if xp.dtype == torch.bfloat16:
        # the bf16 kernel's arithmetic: exact products, float32 sums, one
        # rounding
        return conv3x3_valid_plain_nchw(xp.float(), pk.float()).to(xp.dtype)
    b, cin, hp, wp = xp.shape
    h, w = hp - 2, wp - 2
    n = h * wp - 2
    xf = xp.reshape(b, cin, hp * wp)
    acc = None
    for kh in range(3):
        for kw in range(3):
            off = kh * wp + kw
            part = torch.matmul(pk[kh, kw].t(), xf[:, :, off:off + n])
            acc = part if acc is None else acc + part
    acc = F.pad(acc, (0, 2))
    return acc.reshape(b, pk.shape[-1], h, wp)[..., :w]


def conv3x3_valid_plain(xp: torch.Tensor, pk: torch.Tensor) -> torch.Tensor:
    """:func:`conv3x3_valid_plain_nchw` on an NHWC map: xp (B, h+2, w+2,
    Cin), pk (3, 3, Cin, Cout) -> (B, h, w, Cout)."""
    return _nhwc(conv3x3_valid_plain_nchw(_nchw(xp), pk))


def conv3x3_valid_library(xp: torch.Tensor, pk: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` of an NHWC map, VALID: xp (B, h+2, w+2, Cin), pk (3, 3,
    Cin, Cout) -> (B, h, w, Cout); the counterpart of ``conv3x3_valid_xla``."""
    return _nhwc(_library_nchw(_nchw(xp), pk))


class PhaseConvKernel(build.Kernel):
    """ctypes wrapper of kernel 6 for one operand type: ``csrc/phase_conv.cu``
    (float32, 3xTF32; xp contiguous NCHW) or ``csrc/phase_conv_bf16.cu``
    (bfloat16; xp channels-last)."""

    def __init__(self, dtype: torch.dtype, source: str,
                 layout: torch.memory_format = torch.contiguous_format):
        super().__init__(source, source, f"{source}_launch",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5)
        self.dtype = dtype
        self.layout = layout

    def __call__(self, xp: torch.Tensor, pk: torch.Tensor) -> torch.Tensor:
        """xp (B, Cin, h+2, w+2) in this kernel's layout and pk (3, 3, Cin,
        Cout) contiguous, CUDA tensors of this kernel's type on one device
        -> (B, Cout, h, w) of that type, contiguous."""
        for name, t, fmt in (("xp", xp, self.layout),
                             ("pk", pk, torch.contiguous_format)):
            if t.dtype != self.dtype or t.dim() != 4 \
                    or not t.is_contiguous(memory_format=fmt):
                what = "channels-last" if fmt == torch.channels_last \
                    else "contiguous"
                raise ValueError(f"{self.name} kernel: {name} must be a "
                                 f"{what} {self.dtype} rank-4 tensor, "
                                 f"got {t.dtype} {tuple(t.shape)}")
        bsz, cin, hp, wp = xp.shape
        cout = pk.shape[-1]
        if pk.shape[:3] != (3, 3, cin) or hp < 3 or wp < 3 or cout < 1 \
                or cin < 1 or not 1 <= bsz <= 65535 \
                or cin * hp * wp >= 2 ** 31:
            raise ValueError(f"{self.name} kernel: need xp (B, Cin, h+2, w+2) "
                             "with h, w, Cin >= 1, 1 <= B <= 65535, Cin*(h+2)"
                             "*(w+2) < 2^31 and pk (3, 3, Cin, Cout), got "
                             f"{tuple(xp.shape)} and {tuple(pk.shape)}")
        # the channels-last kernel counts the batch's flat positions (its
        # TMA rows) in 32 bits
        if self.layout == torch.channels_last \
                and bsz * hp * wp >= 2 ** 31 - 2 ** 10:
            raise ValueError(f"{self.name} kernel: need B*(h+2)*(w+2) < "
                             f"2^31 - 2^10, got {tuple(xp.shape)}")
        dev = build.cuda_device(self.name, xp, pk)
        out = torch.empty((bsz, cout, hp - 2, wp - 2), dtype=self.dtype,
                          device=dev)
        self.launch(dev, xp.data_ptr(), pk.data_ptr(), out.data_ptr(), bsz,
                    cin, cout, hp - 2, wp - 2)
        return out


phase_conv_kernel = PhaseConvKernel(torch.float32, "phase_conv")
phase_conv_bf16_kernel = PhaseConvKernel(torch.bfloat16, "phase_conv_bf16",
                                         torch.channels_last)
# the kernel route's kernel per operand type
KERNELS = {k.dtype: k for k in (phase_conv_kernel, phase_conv_bf16_kernel)}


class KernelConv3x3(torch.autograd.Function):
    """The kernel route: forward is the kernel of the operands' type
    (:data:`KERNELS`) on CUDA tensors and its plain version on CPU tensors;
    backward is the library convolution's input and weight gradients on the
    same tensors, in their type, so they equal the library route's
    (``_conv3x3_bwd``, ``densefusion_tpu/ops/phase_conv.py:156``)."""

    @staticmethod
    def forward(ctx, xp, pk):
        if xp.dtype != pk.dtype or xp.dtype not in KERNELS:
            raise ValueError(f"phase_conv kernel route: xp and pk must both "
                             f"be float32 or both bfloat16, got {xp.dtype} "
                             f"and {pk.dtype}")
        ctx.save_for_backward(xp, pk)
        if xp.device.type == "cpu":
            return conv3x3_valid_plain_nchw(xp, pk)
        kernel = KERNELS[xp.dtype]
        if kernel.layout == torch.contiguous_format:
            xp = xp.contiguous()
        # else the map stays as it came: the wrapper raises on another layout
        return kernel(xp, pk.contiguous())

    @staticmethod
    def backward(ctx, g):
        xp, pk = ctx.saved_tensors
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g, xp, pk.permute(3, 2, 0, 1), None, [1, 1], [0, 0], [1, 1],
            False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, (None if gw is None else gw.permute(2, 3, 1, 0))


def auto_backend(device: torch.device) -> str:
    """The route ``"auto"`` takes on ``device``: ``"kernel"`` on CUDA,
    ``"library"`` elsewhere (the measured reason is in the module
    docstring)."""
    return "kernel" if torch.device(device).type == "cuda" else "library"


def replicate_pad(x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """``x`` (B, C, h, w) padded by one with its edge values: the map that
    :func:`conv3x3_valid_nchw` on ``backend`` takes. For the bf16 kernel
    (:data:`phase_conv_bf16_kernel`) it is written channels-last in the
    pad's one copy: (B, h, w, C) seen as one 5-D volume, whose replicate pad
    of its first two spatial axes stores the channels innermost. Otherwise
    it is ``F.pad``'s contiguous map, as before."""
    if backend == "auto":
        backend = auto_backend(x.device)
    kernel = KERNELS.get(x.dtype)
    if backend == "kernel" and kernel is not None \
            and kernel.layout == torch.channels_last:
        return F.pad(_nhwc(x)[None], (0, 0, 1, 1, 1, 1),
                     mode="replicate")[0].permute(0, 3, 1, 2)
    return F.pad(x, (1, 1, 1, 1), mode="replicate")


def conv3x3_valid_nchw(xp: torch.Tensor, pk: torch.Tensor,
                       backend: str = "auto") -> torch.Tensor:
    """:func:`conv3x3_valid` on an NCHW map: xp (B, Cin, h+2, w+2), pk (3, 3,
    Cin, Cout) HWIO -> (B, Cout, h, w)."""
    if backend == "auto":
        backend = auto_backend(xp.device)
    if backend == "kernel":
        return KernelConv3x3.apply(xp, pk)
    if backend == "library":
        return _library_nchw(xp, pk)
    raise ValueError(f"unknown conv backend {backend!r}; one of {BACKENDS}")


def conv3x3_valid(xp: torch.Tensor, pk: torch.Tensor,
                  backend: str = "auto") -> torch.Tensor:
    """VALID 3x3 convolution of a pre-padded NHWC map.

    xp (B, h+2, w+2, Cin), already padded by 1 (edge or zero); pk (3, 3,
    Cin, Cout) HWIO -> (B, h, w, Cout), differentiable in both. The backend
    names map onto the JAX package's:

    ==========  =========  ===============================================
    port        JAX        route
    ==========  =========  ===============================================
    "auto"      "auto"     :func:`auto_backend` of the input's device
    "library"   "xla"      the library convolution
    "kernel"    "pallas"   :class:`KernelConv3x3`: ``csrc/phase_conv.cu`` on
                           CUDA tensors, its plain version on CPU tensors;
                           the library's backward
    ==========  =========  ===============================================
    """
    return _nhwc(conv3x3_valid_nchw(_nchw(xp), pk, backend))
