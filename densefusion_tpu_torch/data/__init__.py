"""Data plane (host-side numpy and the host library
:mod:`densefusion_tpu_torch.native`): the sample schema and its assembly,
the LineMOD, YCB-Video and customCAD readers, augmentation, the synthetic
scene generators, and the batch loader. Batches go to the card through
:func:`to_device`.

SegNet's samples are full frames and label maps (``SegSample``); the
FallingThings tools read FAT scenes (``FATScene``).

The sample schema is the reference's six-tensor contract plus ``sym`` /
``valid`` flags::

    points (N, 3) f32 meters | choose (N,) i32 | img (H, W, 3) f32 normalized
    target (M, 3) f32 | model_points (M, 3) f32 | obj_idx () i32
    sym () bool | valid () bool

Every crop is resized to one canonical size with ``choose`` remapped to it,
so every sample of a dataset has the same shapes.
"""

from densefusion_tpu_torch.data.schema import (
    PoseSample, collate, normalize_image, to_device, IMAGENET_MEAN,
    IMAGENET_STD,
)
from densefusion_tpu_torch.data.augment import resize_bilinear_np
from densefusion_tpu_torch.data.common import (
    assemble_sample, choose_mask_pixels, pinhole_point_fn,
    subsample_model_points,
)
from densefusion_tpu_torch.data.ply import read_ply_vertices, write_ply
from densefusion_tpu_torch.data.linemod import (
    LineModDataset, LINEMOD_OBJLIST, LINEMOD_SYM,
)
from densefusion_tpu_torch.data.ycb import (
    YCBDataset, YCBPoseCNNEvalDataset, YCB_SYM,
)
from densefusion_tpu_torch.data.cad import CADDataset, UnityDepthRayMap
from densefusion_tpu_torch.data.seg import (
    SegSample, SegDataset, LinemodSegDataset, collate_seg, seg_to_device,
)
from densefusion_tpu_torch.data.loader import BatchLoader, PrefetchIterator
from densefusion_tpu_torch.data.fat import (
    FATScene, verify_scene as verify_fat_scene,
)
from densefusion_tpu_torch.data.synthetic import (
    delete_point_holes, generate_cad_style_dataset, generate_fat_style_scene,
    generate_linemod_style_dataset, generate_ycb_style_dataset,
)

__all__ = [
    "PoseSample", "collate", "normalize_image", "to_device",
    "IMAGENET_MEAN", "IMAGENET_STD", "resize_bilinear_np",
    "assemble_sample", "choose_mask_pixels", "pinhole_point_fn",
    "subsample_model_points", "read_ply_vertices", "write_ply",
    "LineModDataset", "LINEMOD_OBJLIST", "LINEMOD_SYM",
    "YCBDataset", "YCBPoseCNNEvalDataset", "YCB_SYM",
    "CADDataset", "UnityDepthRayMap",
    "SegSample", "SegDataset", "LinemodSegDataset", "collate_seg",
    "seg_to_device", "BatchLoader", "PrefetchIterator",
    "FATScene", "verify_fat_scene",
    "delete_point_holes", "generate_cad_style_dataset",
    "generate_fat_style_scene",
    "generate_linemod_style_dataset", "generate_ycb_style_dataset",
]
