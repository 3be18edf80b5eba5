"""The whole predict's share of the card's peak: the model's forward
operations over the live tokens of every query that ended in the window
(the reference's `forward_flops`), over the window's time and the peak of
the configuration's precision (float32 as 3xTF32's 165 TFLOP/s)."""

from harness.roofline import peak_share

SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "serve_candidates_per_s"
# dense peaks of one H100 SXM (NVIDIA's data sheet), by the configuration's precision
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}


def read(run):
    return peak_share(run, PEAK_FLOPS)
