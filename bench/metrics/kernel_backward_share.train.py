"""Device time of the kernels inside the program's "flash_attention backward" and "ssd_scan backward" spans (the plain backwards of the two kernels) over the traced steps' kernel time."""
from harness import readers

LAYER = "kernels/ops backward Functions"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    return readers.span_share(ctx, "train", ("flash_attention backward", "ssd_scan backward"))
