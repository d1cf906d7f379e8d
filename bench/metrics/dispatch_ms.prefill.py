"""Device milliseconds of the traced turn in the MoE's data movement: the
records whose innermost span is ``model.ffn.dispatch`` (the ids,
partition_pack, the row gather) or ``model.ffn.combine`` (the unpack, the
weights, the k-sum) (``harness/spans.py``). None for a configuration with
no MoE layer, or unless the trace is whole and holds a ``model.prefill``
span a batch."""
from harness import spans

MOVES = ("model.ffn.dispatch", "model.ffn.combine")


def read(run):
    if not run.structure["moe"]:
        return None
    return spans.span_ms(run, lambda name: name in MOVES)
