"""Kernel launches a prefill call, over the traced turn: the CUDA runtime
and driver launch records (``cudaLaunchKernel*``, ``cuLaunchKernel*``)
inside the program's ``model.prefill`` spans, over the number of spans.
None unless the trace is whole and holds a span a batch
(``harness/spans.py``)."""
from harness import spans


def read(run):
    p = spans.prefill_profile(run)
    if p is None:
        return None
    pre = spans.ranges(p["events"], spans.PREFILL)
    n = len(spans.inside(p["events"], pre,
                         lambda e: spans.LAUNCH.match(e.name) is not None))
    return n / len(pre)
