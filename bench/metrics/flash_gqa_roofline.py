"""flash_gqa's share of its roofline in the traced turn of the cycle: the
sum over its calls of each call's bound (``flops.flash_work`` at the
card's peaks, at the shape the batch passes each attention layer: B, S,
heads, kv heads, head dims, causal, bf16) over the summed device time of
the trace's records of functions named ``flash_gqa*``. Not reported when
the trace is not whole."""
from harness import flops, timing


def read(run):
    p = run.profile
    if not p or not p["complete"]:
        return None
    spent = timing.kernel_s(p["events"], "flash_gqa")
    bound = sum(a["layers"] * flops.bound_s(*flops.flash_work(a, b.rows,
                                                               b.seq))
                for b in p["batches"] for a in run.structure["attention"])
    return 100.0 * bound / spent if spent > 0 else None
