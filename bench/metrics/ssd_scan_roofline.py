"""ssd_scan's share of its roofline in the traced turn of the cycle: the
sum over its calls, one a Mamba layer a batch, of each call's bound
(``harness/ssd.py``'s work at the card's peaks, at the batch's B and S,
in bf16) over the summed device time of the trace's records of functions
named ``ssd_*`` (the kernel's four). None off a CUDA device, for a
configuration with no Mamba layer, when the trace is not whole, or unless
the trace holds 4 such records a Mamba layer a batch."""
from harness import flops, ssd, timing


def read(run):
    st, p = run.structure.get("ssm"), run.profile
    if run.device.type != "cuda" or not st or not p or not p["complete"]:
        return None
    events = p["events"]
    if timing.count(events, "ssd_") < 4 * st["layers"] * len(p["batches"]):
        return None
    spent = timing.kernel_s(events, "ssd_")
    bound = sum(st["layers"] * flops.bound_s(*ssd.work(st, b.rows, b.seq))
                for b in p["batches"])
    return 100.0 * bound / spent if spent > 0 else None
