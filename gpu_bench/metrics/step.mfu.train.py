"""The whole training step's share of the card's peak: the model's
operations over the live tokens of every step that ended in the window
(the forward's products, x3 for the backward, no recompute; the reference's
`step_flops`), over the window's time and the peak of the configuration's
precision. float32's peak is 3xTF32's 165 TFLOP/s, the rate the attention
kernels' bounds use: a float32-accurate product runs no faster on this card."""

from harness.roofline import peak_share

SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "train_examples_per_s"
# dense peaks of one H100 SXM (NVIDIA's data sheet), by the configuration's precision
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}


def read(run):
    return peak_share(run, PEAK_FLOPS)
