"""Device milliseconds of the traced turn in the program's glue: the
records whose innermost span ends in ``.norm``, ``.rope`` or ``.act``
(norms, rope and the q/k concatenations, activations), or is
``model.cache`` (the cache stack) (``harness/spans.py``). None unless the
trace is whole and holds a ``model.prefill`` span a batch."""
from harness import spans


def read(run):
    return spans.span_ms(run, spans.is_glue)
