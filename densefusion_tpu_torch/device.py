"""Device resolution and float32 precision policy.

Every entry point of the port runs on CUDA unless its caller asks for the
CPU (``device="cpu"``, as the tests do). There is no silent fallback: without
a card and without ``device="cpu"``, :func:`resolve_device` raises.

Precision: a float32 matmul on the card runs in full float32 by default, but
cuDNN runs float32 convolutions in TF32 unless told otherwise. This slice
holds the port to full float32 on the card (its CUDA results are compared
with its CPU ones), so resolving a CUDA device turns TF32 off for both.
"""

from __future__ import annotations

import torch


def full_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def precision_policy() -> dict:
    """The float32 policy in force, as recorded beside every measurement."""
    return {"matmul_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_tf32": bool(torch.backends.cudnn.allow_tf32)}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises when the requested device is CUDA and no
    card is present. A CUDA device also sets the full-float32 policy."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "densefusion_tpu_torch runs on CUDA and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        full_f32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run_record(dev: torch.device, dtype: str = "float32") -> dict:
    """What a measurement is kept beside: the device, the card's name and
    power limit (None on the CPU), the float32 policy and the compute
    type."""
    cuda = torch.device(dev).type == "cuda"
    return {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "card": card_line() if cuda else None,
            "precision": precision_policy(), "dtype": dtype}
