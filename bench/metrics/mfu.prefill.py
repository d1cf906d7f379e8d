"""Model FLOPs of the window's prefill calls over the window's seconds,
as a share of one H100's bf16 peak (``harness/flops.py``)."""
from harness import flops


def read(run):
    if run.device.type != "cuda":
        return None
    f = sum(flops.model_flops(run.structure, r.rows, r.seq)
            for r in run.records)
    return 100.0 * f / run.window_s / flops.PEAK_BF16_FLOPS
