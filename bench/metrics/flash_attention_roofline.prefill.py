"""flash_attention's least time over its kernels' device time, in the traced prefill batches."""
from harness import readers

LAYER = "kernels/flash_attention"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "ttft_p95_ms"


def read(ctx):
    return readers.roofline(ctx, "prefill", "flash_attention")
