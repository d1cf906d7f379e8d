"""The host's own work in the prefill call per second of card work, over
the traced turn: 100 x the summed time of the program's ``model.prefill``
spans, less the time inside CUDA runtime and driver calls within them
(launches, syncs, copies), over the turn's busy seconds of the card. Near
100 the host paces the card. None unless the trace is whole and holds a
``model.prefill`` span a batch (``harness/spans.py``)."""
from harness import spans


def read(run):
    p = spans.prefill_profile(run)
    if p is None:
        return None
    own_us = sum(s.time_range.elapsed_us() - spans.runtime_us(p["events"], s)
                 for s in spans.ranges(p["events"], spans.PREFILL))
    return 100.0 * own_us * 1e-6 / p["busy_s"]
