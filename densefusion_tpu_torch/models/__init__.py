"""Networks: PSPNet embedding CNN, PoseNet, PoseRefineNet, SegNet."""

from densefusion_tpu_torch.models.resnet import DilatedResNet
from densefusion_tpu_torch.models.pspnet import PSPNet, PSPModule, PSPUpsample
from densefusion_tpu_torch.models.posenet import PoseNet, DenseFusionFeat
from densefusion_tpu_torch.models.refiner import PoseRefineNet, RefineFeat
from densefusion_tpu_torch.models.segnet import SegNet

__all__ = ["DilatedResNet", "PSPNet", "PSPModule", "PSPUpsample", "PoseNet",
           "DenseFusionFeat", "PoseRefineNet", "RefineFeat", "SegNet"]
