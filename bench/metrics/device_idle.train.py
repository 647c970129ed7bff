"""Share of the traced training steps' wall time in which no kernel, copy or fill ran on the device."""
from harness import readers

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    return readers.device_idle(ctx, "train")
