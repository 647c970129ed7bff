"""Device time of the kernels inside the program's "adamw" span over the traced steps' kernel time."""
from harness import readers

LAYER = "optim/adamw"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    return readers.span_share(ctx, "train", ("adamw",))
