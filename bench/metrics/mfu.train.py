"""Model FLOPs of the training window (3x the forward: forward and backward, remat's recompute not counted) over the card's bf16 peak times the window."""
from harness import readers

LAYER = "train/step (the whole train step)"
SOURCE = "host_clock"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    return readers.mfu(ctx, "train")
