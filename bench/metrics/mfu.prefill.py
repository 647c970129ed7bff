"""Model FLOPs of the prefill window (the forward over every prompt) over the card's bf16 peak times the window."""
from harness import readers

LAYER = "serving/prefill (the whole prefill)"
SOURCE = "host_clock"
UNIT = "%"
MOVES = "ttft_p95_ms"


def read(ctx):
    return readers.mfu(ctx, "prefill")
