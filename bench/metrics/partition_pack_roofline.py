"""partition_pack's share of its roofline in the traced turn of the
cycle: one call a MoE layer packs each request's S x top_k entries (one
int32 token number each) over the batch's B x experts partitions at the
capacity of its length; the bound is ``flops.pack_bytes`` at the card's
bandwidth, over the summed device time of the trace's records of
functions named ``pp_*`` (the kernel's). None for a configuration with no
MoE layer, or when the trace is not whole."""
from harness import flops, timing


def read(run):
    moe, p = run.structure["moe"], run.profile
    if not moe or not p or not p["complete"]:
        return None
    spent = timing.kernel_s(p["events"], "pp_")
    E, k = moe["experts"], moe["top_k"]
    bound = sum(moe["layers"] * flops.bound_s(0, flops.pack_bytes(
        b.rows * b.seq * k, 4, b.rows * E, flops.expert_capacity(b.seq, moe)))
        for b in p["batches"])
    return 100.0 * bound / spent if spent > 0 else None
