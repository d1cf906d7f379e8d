"""Device milliseconds of the traced turn launched inside the program's
Mamba-2 mixers: the records whose innermost span is ``model.mixer`` or one
of its children (``harness/spans.py``). None unless the trace is whole and
holds a ``model.prefill`` span a batch, or where no record falls under a
``model.mixer`` span (a program that marks none)."""
from harness import spans


def read(run):
    ms = spans.span_ms(run, lambda name: spans.under(name, "model.mixer"))
    return ms or None
