"""Kernel 6 (``csrc/phase_conv.cu``, ``phase_conv_kernel``) in the traced
segment of a serving or evaluation cell: the summed bound of its launches
over their summed device time. Each PoseNet forward launches it three
times, at the decoder's three stages; the bound counts each product once
at the configuration's peak."""

from perfbench import counts
from perfbench.metrics_common import roofline_pct


def read(run):
    if run.trace is None:
        return None
    per_forward = [counts.conv3x3_bound_s(*shape,
                                          peak_flops=run.config["peak_flops"])
                   for shape in counts.decoder_convs(
                       run.config["crop_size"], run.traffic["batch"],
                       run.config["decoder_widths"])]
    return roofline_pct(run.trace.kernels(r"\bphase_conv_kernel\b"),
                        per_forward)
