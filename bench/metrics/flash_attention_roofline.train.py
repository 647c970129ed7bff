"""flash_attention's least time (unmasked causal pairs at 989 TFLOP/s bf16, or its bytes at 3.35 TB/s) over its kernels' device time, in the traced training steps (forward and remat recompute)."""
from harness import readers

LAYER = "kernels/flash_attention"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    return readers.roofline(ctx, "train", "flash_attention")
