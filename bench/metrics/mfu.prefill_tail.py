"""``mfu.prefill`` over the batches of the cycle's longest prompt length
only, over their summed wall time: the batches that hold the requests past
the 95th percentile of time to first token."""
from harness import flops


def read(run):
    if run.device.type != "cuda":
        return None
    top = max(r.seq for r in run.records)
    tail = [r for r in run.records if r.seq == top]
    f = sum(flops.model_flops(run.structure, r.rows, r.seq) for r in tail)
    wall = sum(r.first - r.dispatched for r in tail)
    return 100.0 * f / wall / flops.PEAK_BF16_FLOPS
