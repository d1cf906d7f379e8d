"""The traffic generator: the cycle and its batching repeat exactly, and a
seed gives the same prompts."""
import json

import pytest
import torch

from harness import cell as C
from harness import traffic


def test_cycles_and_batches_are_fixed():
    long = traffic.load(C.BENCH / "traffic" / "prefill_long.json")
    short = traffic.load(C.BENCH / "traffic" / "prefill_short.json")
    assert [(b.seq, b.rows) for b in traffic.cycle(long)] == \
        [(2048, 8), (4096, 4), (8192, 2)]
    assert [(b.seq, b.rows) for b in traffic.cycle(short)] == \
        [(128, 128), (256, 64), (512, 32)]
    seen = [traffic.batch_at(long, i) for i in range(9)]
    assert seen == traffic.cycle(long) * 3
    assert all(b.seq * b.rows == 16384 for b in seen)


def test_prompts_repeat_with_the_seed():
    mix = {"batch_tokens": 64, "cycle": [8, 16], "tokens": {"dist":
                                                             "uniform"}}
    a = traffic.token_pool(mix, 512, 4, 2 ** 31 + 9, "cpu")
    b = traffic.token_pool(mix, 512, 4, 2 ** 31 + 9, "cpu")
    c = traffic.token_pool(mix, 512, 4, 2 ** 31 + 10, "cpu")
    assert a.shape == (4, 64) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 512


def test_only_uniform_token_ids_are_generated(tmp_path):
    mix = {"name": "skewed", "loop": "closed", "batch_tokens": 64,
           "cycle": [8], "tokens": {"dist": "zipf"}, "why": "skewed"}
    (tmp_path / "skewed.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="zipf"):
        traffic.load(tmp_path / "skewed.json")


def test_end_to_end_arithmetic():
    """Tokens over the window; the 95th percentile over requests, each
    request its batch's time to first token."""
    from harness.main import Rec, end_to_end
    recs = [Rec(i, s, 16384 // s, t, t + 0.01, t + d, None)
            for i, (s, t, d) in enumerate([(2048, 0.0, 0.5), (4096, 0.5, 0.5),
                                           (8192, 1.0, 1.0)])]
    out = end_to_end(recs, 2.0)
    assert out["prefill_tokens_per_s"] == 3 * 16384 / 2.0
    # 14 requests: 12 at 500 ms, 2 at 1000 ms; the inclusive 95th
    # percentile lies between the 13th and 14th smallest
    assert out["ttft_p95_ms"] == 1000.0


def test_the_sample_holds_a_longest_request():
    from harness import check
    reqs = [(j, r, s) for j, s in enumerate([2048, 4096, 8192] * 4)
            for r in range(16384 // s)]
    for seed in range(20):
        pick = check.sample(reqs, seed)
        assert any(s == 8192 for _, _, s in pick)
        assert sum(s for _, _, s in pick) <= check.SAMPLE_TOKENS
        assert pick == check.sample(reqs, seed)
    assert check.sample(reqs, 1) != check.sample(reqs, 2)


def test_the_handoff_keeps_the_last_caches(tmp_path):
    """Each prefill's KV cache stays on the device until
    ``kv_handoff_tokens`` later prompt tokens have been served: full from
    the window's start, the oldest let go first, emptied before the
    reference runs."""
    import _smoke
    from harness.main import Pool
    root = _smoke.tree(tmp_path)
    pool = Pool(root, "glm4-9b-smoke.smoke", 3, "cpu")
    assert pool.handoff.maxlen == 4
    pool.warm()
    seqs = [c["kv"]["k"].shape[2] for c in pool.handoff]
    assert seqs == [32, 8, 16, 32]     # the cycle 8, 16, 32, ending on 32
    recs, held, _ = pool.window(0.0)
    assert len(pool.handoff) == 4 and pool.handoff[-1]["kv"]["k"].shape[2] \
        == recs[-1].seq
    pool.sampled(recs, held, 3)
    assert len(pool.handoff) == 0
