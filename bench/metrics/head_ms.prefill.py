"""Device milliseconds of the traced turn in the program's LM head: the
records whose innermost span is ``model.head`` (the last position's
logits) (``harness/spans.py``). None unless the trace is whole and holds a
``model.prefill`` span a batch."""
from harness import spans


def read(run):
    return spans.span_ms(run, lambda name: name == "model.head")
