"""Model FLOPs of the window's prefill calls of a hybrid configuration
over the window's seconds, as a share of one H100's bf16 peak: the
matrix products, attention and head of ``flops.model_flops`` (routed
experts at the entries held here on average, the reference's
``structure``) plus each Mamba layer's SSD work (``harness/ssd.py``).
None for a configuration with no Mamba layer."""
from harness import flops, ssd


def read(run):
    st = run.structure
    if run.device.type != "cuda" or not st.get("ssm"):
        return None
    f = sum(flops.model_flops(st, r.rows, r.seq)
            + st["ssm"]["layers"] * ssd.work(st["ssm"], r.rows, r.seq)[0]
            for r in run.records)
    return 100.0 * f / run.window_s / flops.PEAK_BF16_FLOPS
