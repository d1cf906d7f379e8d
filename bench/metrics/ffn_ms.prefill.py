"""Device milliseconds of the traced turn launched inside the program's
MLP and MoE blocks: the records whose innermost span is ``model.ffn`` or
one of its children (``harness/spans.py``). None unless the trace is whole
and holds a ``model.prefill`` span a batch."""
from harness import spans


def read(run):
    return spans.span_ms(run, lambda name: spans.under(name, "model.ffn"))
