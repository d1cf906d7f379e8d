"""Share of a short traced window of prefill batches in which the card
ran no kernel and no copy: 1 - (union of the profiler's device intervals
/ the window's span). Not reported when the trace is not whole (fewer
flash_gqa or partition_pack records than the window's calls launch)."""


def read(run):
    p = run.profile
    if run.device.type != "cuda" or not p or not p["complete"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
