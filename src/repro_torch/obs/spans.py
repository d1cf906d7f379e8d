"""Spans and counters of the port's model code, on the profiler's timeline.

``span(name)`` marks a range of the program. While a torch profiler
records, it is ``torch.profiler.record_function(name)``: the range lands
on the same Kineto/CUPTI timeline as the card's kernel records, so each
device record can be put down to the span that launched it, and the
program keeps no clock of its own. Otherwise it is one shared null
context: no allocation, no torch op. Tracing is on exactly when someone
profiles (``bench/run.py --trace 1``, ``launch/profile_serve.py``, an
operator's own ``torch.profiler``); no switch turns it on.

Counters are kept only while the profiler records, on the device where
their values are, with no read-back to the host inside a call;
``counters()`` returns the totals and resets them.

The spans, each read by a ``bench/metrics`` reader over the traced turn
(``bench/harness/spans.py`` attributes the device records):

  model.prefill       the prefill step (``launch/steps.py``)
  model.attn          an attention block (GQA or MLA), whole
  model.attn.norm     its norms (MLA's ``kv_ln`` too)
  model.attn.rope     rope and the concatenations that assemble q/k heads
  model.ffn           an MLP or MoE block, whole
  model.ffn.norm      its norm
  model.ffn.act       every SwiGLU / GELU in it
  model.ffn.dispatch  the MoE dispatch (ids, partition_pack, row gather)
  model.ffn.combine   the MoE combine (on one device the moe_combine
                      kernel on the card, its plain version on the CPU)
  model.mixer         a Mamba-2 mixer, whole (``models/mamba2.py``)
  model.mixer.norm    its pre-norm
  model.mixer.conv    the causal conv and its SiLU
  model.mixer.ssd     the ``ssd_scan`` call and the D skip
  model.mixer.gate    y * silu(z) and the gated RMSNorm
  model.norm          the final norm
  model.head          the LM head over the last position
  model.cache         the prefill's cache stack and length

and the counters, summed over MoE calls and prefills:

  moe.kept            entries that got a slot (device int64)
  moe.slots           slots computed, B·E·C (host int; E the experts held
                      here); the drop share is 1 - kept / (B·S·k)
  moe.combine_kernel  one-device MoE calls whose combine took the
                      moe_combine kernel (host int)
  moe.local           routed entries whose expert is held here (device
                      int64), where only a share of the experts is
  ssm.state_bytes     bytes of the Mamba layers' states a prefill hands
                      off (host int; granite-4.0-h's family)
  attn.kv_bytes       bytes of the attention layers' K/V it hands off
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_totals: dict[str, torch.Tensor | int] = {}


def recording() -> bool:
    """Whether a torch profiler records now."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else the
    shared null context."""
    if recording():
        return torch.profiler.record_function(name)
    return _NULL


def spanned(name: str):
    """Decorator: the function's every call inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a tensor, summed on its device, or a host int) to
    counter ``name``. Callers test ``recording()`` first, so that the
    value is not computed when nothing records."""
    have = _totals.get(name)
    if isinstance(value, torch.Tensor):
        value = value.to(torch.int64)
    _totals[name] = value if have is None else have + value


def counters() -> dict[str, int]:
    """The counters' totals since the last call, read to the host; then
    reset."""
    out = {k: int(v) for k, v in _totals.items()}
    _totals.clear()
    return out
