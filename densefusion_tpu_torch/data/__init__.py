"""Host-side sample schema and assembly (numpy)."""

from densefusion_tpu_torch.data.schema import (
    PoseSample, collate, normalize_image, to_device,
)
from densefusion_tpu_torch.data.common import (
    assemble_sample, choose_mask_pixels, resize_bilinear_np,
)

__all__ = ["PoseSample", "collate", "normalize_image", "to_device",
           "assemble_sample", "choose_mask_pixels", "resize_bilinear_np"]
