"""The share of the expert einsums' rows that hold an entry, over the
traced turn: 100 x the program's counters ``moe.kept`` (entries that got a
slot) / ``moe.slots`` (B x experts x capacity), summed over its MoE calls
while the profiler recorded. The turn is the only profiled part of a run.
None for a configuration with no MoE layer, unless the trace is whole and
holds a ``model.prefill`` span a batch, or where the program keeps no such
counters."""
from harness import spans


def read(run):
    if not run.structure["moe"] or spans.prefill_profile(run) is None:
        return None
    try:
        from repro_torch.obs.spans import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("moe.slots"):
        return None
    return 100.0 * c.get("moe.kept", 0) / c["moe.slots"]
