"""The frozen arithmetic against values worked out by hand from the
published sizes of both configurations."""
import json

import pytest

from harness import cell as C
from harness import flops


def structure(name):
    conf = json.loads((C.BENCH / "configs" / f"{name}.json").read_text())
    return C.reference(C.BENCH, conf["reference"]).structure(conf)


def test_glm4_9b_counts():
    st = structure("glm4-9b")
    # a layer: wq 4096x4096, wk and wv 4096x256, wo 4096x4096, the MLP
    # 3 x 4096 x 13696 = 203,948,032; 40 layers
    assert st["matmul_params"] == 8_157_921_280
    assert st["head_params"] == 4096 * 151552 == 620_756_992
    assert st["attention"] == [{"layers": 40, "heads": 32, "kv_heads": 2,
                                "d_qk": 128, "d_v": 128}]
    assert st["moe"] is None
    # B 2, S 8192: 2 x 8,157,921,280 x 16,384 = 267,314,764,103,680,
    # attention 2 x 32 x 256 x 33,558,528 pairs x 2 x 40 =
    # 43,985,833,820,160, the head 2 x 620,756,992 x 2 = 2,483,027,968
    assert flops.model_flops(st, 2, 8192) == 311_307_081_351_168


def test_deepseek_v2_lite_counts():
    st = structure("deepseek-v2-lite-16b")
    # MLA a layer: wq 2048x3072, w_dkv 2048x576, w_uk and w_uv 512x2048,
    # wo 2048x2048 = 13,762,560; the MoE layer: router 2048x64 and 6
    # routed + 2 shared experts of 3 x 2048 x 1408 = 69,337,088;
    # 27 MLA, 1 dense MLP 3 x 2048 x 10944, 26 MoE
    assert st["matmul_params"] == 2_241_593_344
    assert st["moe"] == {"layers": 26, "experts": 64, "top_k": 6,
                         "capacity_factor": 1.5, "align": 8}
    assert st["attention"][0] == {"layers": 27, "heads": 16,
                                  "kv_heads": 16, "d_qk": 192, "d_v": 128}
    # B 8, S 2048: attention 2 x 16 x 320 x 2,098,176 x 8 x 27 =
    # 4,640,829,603,840; head 2 x 2048 x 102400 x 8
    assert flops.model_flops(st, 8, 2048) == 78_096_715_743_232


@pytest.mark.parametrize("S, cap", [(128, 24), (2048, 288), (8192, 1152)])
def test_expert_capacity(S, cap):
    st = structure("deepseek-v2-lite-16b")
    assert flops.expert_capacity(S, st["moe"]) == cap


def test_kernel_work():
    att = structure("glm4-9b")["attention"][0]
    f, b = flops.flash_work(att, 2, 8192)
    assert f == 2 * 32 * 256 * 33_558_528 * 2 == 1_099_645_845_504
    assert b == (2 * 8192 * 32 * 256 + 2 * 8192 * 2 * 256) * 2 \
        == 285_212_672
    assert flops.bound_s(f, b) == pytest.approx(1_099_645_845_504 / 989e12)
    # 8 requests of 2048 x 6 entries over 8 x 64 partitions of 288 slots
    assert flops.pack_bytes(98304, 4, 512, 288) == 1_771_520


def _record(name, start_us, end_us, device=True):
    from types import SimpleNamespace

    import torch
    kind = torch.autograd.DeviceType.CUDA if device \
        else torch.autograd.DeviceType.CPU
    span = SimpleNamespace(start=start_us, end=end_us,
                           elapsed_us=lambda: end_us - start_us)
    return SimpleNamespace(name=name, device_type=kind, time_range=span,
                           is_user_annotation=False)


@pytest.mark.parametrize("metric,config,prefix", [
    ("flash_gqa_roofline", "glm4-9b", "flash_gqa"),
    ("partition_pack_roofline", "deepseek-v2-lite-16b", "pp_")])
def test_rooflines_read_the_traced_kernels(metric, config, prefix):
    """A roofline is the turn's summed bound over the device time of the
    trace's records of its kernel, and only those; nothing from a trace
    that is not whole."""
    from types import SimpleNamespace

    from harness.traffic import Batch
    st = structure(config)
    batches = [Batch(2048, 8), Batch(4096, 4), Batch(8192, 2)]
    events = [_record(f"void {prefix}x<128, 128>(float*)", 0, 3000),
              _record(f"void {prefix}y(int)", 5000, 6000),
              _record("void ampere_bf16_gemm(int)", 6000, 90000),
              _record(f"{prefix}host_side", 0, 90000, device=False)]
    if prefix == "pp_":
        want = sum(26 * flops.bound_s(0, flops.pack_bytes(
            b.rows * b.seq * 6, 4, b.rows * 64,
            flops.expert_capacity(b.seq, st["moe"]))) for b in batches)
    else:
        want = sum(40 * flops.bound_s(*flops.flash_work(
            st["attention"][0], b.rows, b.seq)) for b in batches)
    reader = C.metric_reader(C.BENCH, metric)
    run = SimpleNamespace(structure=st, profile={
        "events": events, "batches": batches, "complete": True})
    assert reader.read(run) == pytest.approx(100 * want / 4e-3)
    run.profile["complete"] = False
    assert reader.read(run) is None
