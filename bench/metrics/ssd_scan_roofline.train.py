"""ssd_scan's least time (ssd_flops at the 495 TFLOP/s TF32 peak, one pass, or its float32 bytes at 3.35 TB/s) over the device time of its three kernels, in the traced training steps."""
from harness import readers

LAYER = "kernels/ssd_scan"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    return readers.roofline(ctx, "train", "ssd_scan")
