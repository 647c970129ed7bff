"""Share of the traced prefill batches' wall time in which no kernel, copy or fill ran on the device."""
from harness import readers

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "ttft_p95_ms"


def read(ctx):
    return readers.device_idle(ctx, "prefill")
