"""The program's spans in a trace (``harness/spans.py``) and the per-layer
metrics that read them, on synthetic profiler records: the attribution of
device records to the innermost span, each reader's arithmetic, and each
reader's None where the trace is not whole, holds no span of the
program, or comes from another device than CUDA."""
import dataclasses
import types

import pytest
import torch

from harness import cell as C
from harness import spans as SP

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
READERS = ["enqueue_share.prefill", "launches.prefill",
           "attention_ms.prefill", "ffn_ms.prefill", "glue_ms.prefill",
           "dispatch_ms.prefill", "slot_fill.prefill", "head_ms.prefill"]


@dataclasses.dataclass
class Range:
    start: float
    end: float

    def elapsed_us(self):
        return self.end - self.start


@dataclasses.dataclass
class Ev:
    """The fields of a torch.profiler FunctionEvent the harness reads."""
    name: str
    start: float
    end: float
    id: int = 0
    device_type: object = CPU
    thread: int = 1
    is_user_annotation: bool = False
    linked_correlation_id: int = 0

    @property
    def time_range(self):
        return Range(self.start, self.end)


def span(name, a, b, id_=0):
    return Ev(name, a, b, id_, is_user_annotation=True)


def kernel(name, a, b, id_, linked=0):
    return Ev(name, a, b, id_, CUDA, linked_correlation_id=linked)


def trace():
    """One prefill (host 0-100 us): attention (10-40) with its norm
    (12-16), an FFN (40-80) with its dispatch (50-60), the cache (82-88),
    the head (90-94);
    the harness's own argmax after it. Host ids of ops and of runtime
    calls overlap, as the profiler's do."""
    return [
        span("bench.prefill", 0, 101),
        span("model.prefill", 0, 100, 1),
        span("model.attn", 10, 40, 2),
        span("model.attn.norm", 12, 16, 3),
        Ev("cudaLaunchKernel", 13, 14, 11),           # the norm's kernel
        Ev("aten::mm", 20, 30, 4),
        Ev("cudaLaunchKernelExC", 25, 27, 12),        # the mm's GEMM
        Ev("aten::copy_", 32, 38, 11),                # id as a runtime's
        span("model.ffn", 40, 80, 5),
        span("model.ffn.dispatch", 50, 60, 6),
        Ev("cuLaunchKernel", 52, 53, 13),             # a bare launch
        Ev("cudaStreamSynchronize", 70, 75, 14),
        span("model.cache", 82, 88, 7),
        Ev("cudaMemcpyAsync", 83, 84, 15),
        span("model.head", 90, 94, 10),
        Ev("cudaLaunchKernelExC", 91, 92, 18),
        Ev("cudaLaunchKernel", 95, 96, 16),           # inside the step only
        Ev("aten::argmax", 101, 104, 8),
        Ev("cudaLaunchKernel", 102, 103, 17),         # outside every span
        # the card: the norm 100-110, the GEMM 110-210, the copy linked
        # to its op alone 210-220, the pack 220-250, the cache's copy
        # 250-260, a stray kernel 260-261, the argmax 262-264, the head
        # 264-266
        kernel("void rms<float>(float*)", 100, 110, 11),
        kernel("nvjet_gemm", 110, 210, 12),
        kernel("Memcpy DtoD (Device -> Device)", 210, 220, 99, linked=11),
        kernel("void pp_place<true>(int)", 220, 250, 13),
        kernel("Memcpy HtoD (Pageable -> Device)", 250, 260, 15),
        kernel("void stray(int)", 260, 261, 16),
        kernel("void argmax(int)", 262, 264, 17),
        kernel("nvjet_head", 264, 266, 18),
        # device-side user ranges are not device records
        Ev("model.attn", 100, 220, 2, CUDA, is_user_annotation=True),
    ]


def run_of(events, device="cuda", complete=True, batches=1, moe=True):
    profile = {"events": events, "complete": complete, "busy_s": 165e-6,
               "batches": [object()] * batches}
    return types.SimpleNamespace(
        device=torch.device(device), profile=profile,
        structure={"moe": {"experts": 4} if moe else None})


def reader(name):
    return C.metric_reader(C.BENCH, name)


def test_attribution_takes_the_innermost_span_of_the_launch():
    got = {d.name: s for d, s in SP.attribute(trace())}
    assert got == {
        "void rms<float>(float*)": "model.attn.norm",
        "nvjet_gemm": "model.attn",
        "Memcpy DtoD (Device -> Device)": "model.attn",   # by its op
        "void pp_place<true>(int)": "model.ffn.dispatch",
        "Memcpy HtoD (Pageable -> Device)": "model.cache",
        "void stray(int)": "model.prefill",
        "nvjet_head": "model.head",
        "void argmax(int)": None}


def test_a_launch_on_another_thread_is_not_in_the_span():
    ev = trace()
    for e in ev:
        if e.name == "cudaLaunchKernelExC":
            e.thread = 2
    got = {d.name: s for d, s in SP.attribute(ev)}
    assert got["nvjet_gemm"] is None


def test_device_ms_by_span():
    by = SP.device_s(trace())
    assert by["model.attn"] == pytest.approx(110e-6)
    assert by[None] == pytest.approx(2e-6)
    assert sum(by.values()) == pytest.approx(165e-6)


def test_readers_arithmetic():
    run = run_of(trace())
    assert reader("attention_ms.prefill").read(run) == pytest.approx(0.120)
    assert reader("ffn_ms.prefill").read(run) == pytest.approx(0.030)
    assert reader("dispatch_ms.prefill").read(run) == pytest.approx(0.030)
    # the norm's 10 us and the cache's 10 us
    assert reader("glue_ms.prefill").read(run) == pytest.approx(0.020)
    assert reader("head_ms.prefill").read(run) == pytest.approx(0.002)
    # 5 launch records in the step: the norm's, the GEMM's, the pack's,
    # the head's, the stray one's; not the argmax's
    assert reader("launches.prefill").read(run) == 5
    # 100 us of the step less 1 + 2 + 1 + 5 + 1 + 1 + 1 us of runtime
    # calls, over 165 us of card
    assert reader("enqueue_share.prefill").read(run) == pytest.approx(
        100.0 * 88 / 165)


def test_launches_are_a_mean_per_call():
    ev = trace() + [span("model.prefill", 200, 300, 9),
                    Ev("cudaLaunchKernel", 210, 211, 40)]
    assert reader("launches.prefill").read(run_of(ev, batches=2)) == 3


def test_slot_fill_reads_the_programs_counters():
    from repro_torch.obs import spans
    spans.counters()
    spans.count("moe.kept", torch.tensor(30))
    spans.count("moe.kept", torch.tensor(15))
    spans.count("moe.slots", 40)
    spans.count("moe.slots", 40)
    assert reader("slot_fill.prefill").read(run_of(trace())) == \
        pytest.approx(100.0 * 45 / 80)
    assert spans.counters() == {}                 # read and reset
    assert reader("slot_fill.prefill").read(run_of(trace())) is None


@pytest.mark.parametrize("name", READERS)
def test_none_unless_the_trace_holds_the_programs_spans(name):
    def slots():
        from repro_torch.obs import spans
        spans.counters()
        spans.count("moe.kept", 1)
        spans.count("moe.slots", 2)
    read = reader(name).read
    slots()
    assert read(run_of(trace())) is not None
    no_spans = [e for e in trace() if not e.name.startswith("model.")]
    for run in (run_of(trace(), complete=False),
                run_of(trace(), device="cpu"),
                run_of(no_spans),
                run_of(trace(), batches=2)):       # fewer spans than batches
        slots()
        assert read(run) is None
    run = run_of(trace())
    run.profile = None
    assert read(run) is None
    from repro_torch.obs import spans
    spans.counters()


@pytest.mark.parametrize("name", ["dispatch_ms.prefill",
                                  "slot_fill.prefill"])
def test_moe_readers_are_none_without_moe(name):
    assert reader(name).read(run_of(trace(), moe=False)) is None
