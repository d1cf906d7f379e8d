"""The port's journaled coordinator failover (``faults/journal.py`` behind
``Session.run_with_failover``, ``Session.failover`` and
``make_engine(journal=...)``, device="cpu") against the reference's.

A coordinator killed after ``kill_after`` event pops fails over to a fresh
one over the same store, which replays under the §3.2 immutability audit
(every re-PUT byte-identical). The result, the journal's checkpoints and
its final frontier must equal the reference's and those of a run with no
kill."""
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as RE  # noqa: E402
from repro.core.session import Session as RSession  # noqa: E402
from repro.faults import journal as RJ  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core.session import Session as PSession  # noqa: E402
from repro_torch.faults import journal as PJ  # noqa: E402

from _torch_query_parity import OPTS, result_sig, same_rows  # noqa: E402

EVERY = 16                          # journal checkpoint interval


def _no_kill(q: str):
    """The port's uninterrupted run with a journal: (result, journal)."""
    journal = PJ.Journal(EVERY)
    coord, _ = PE.make_engine(device="cpu", journal=journal, **OPTS)
    return coord.run_query(PE.build_plan(q)), journal


@pytest.mark.parametrize("at", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("q", ["q12", "q3"])
def test_run_with_failover_matches_reference(q, at):
    whole, whole_j = _no_kill(q)
    kill = max(1, int(at * whole_j.count))
    want, want_j = RSession(**OPTS).run_with_failover(
        q, kill_after=kill, checkpoint_every=EVERY)
    got, got_j = PSession(device="cpu", **OPTS).run_with_failover(
        q, kill_after=kill, checkpoint_every=EVERY)
    assert result_sig(got) == result_sig(want, strict=False)
    assert result_sig(got) == result_sig(whole)
    same_rows(got.result, want.result)
    same_rows(got.result, whole.result)
    assert got_j.replaying and got_j.entries == want_j.entries
    assert got_j.frontier == want_j.frontier == whole_j.frontier
    assert got_j.entries == whole_j.entries


def test_legacy_shim_matches_reference():
    """``faults.journal.run_with_failover`` over a coordinator factory
    gives what ``Session.run_with_failover`` and the reference give."""
    spec = ("q6", {"scan": 4})

    def make(E, **kw):
        return lambda journal: E.make_engine(journal=journal, **OPTS,
                                             **kw)[0]

    want, want_j = RJ.run_with_failover(make(RE), RE.build_plan(*spec),
                                        kill_after=30)
    got, got_j = PJ.run_with_failover(make(PE, device="cpu"),
                                      PE.build_plan(*spec), kill_after=30)
    sess, sess_j = PSession(device="cpu", **OPTS).run_with_failover(
        spec, kill_after=30)
    assert result_sig(got) == result_sig(want, strict=False) == \
        result_sig(sess)
    assert got_j.entries == want_j.entries == sess_j.entries
    assert got_j.frontier == want_j.frontier == sess_j.frontier
    with pytest.raises(ValueError, match="nothing was killed"):
        PJ.run_with_failover(make(PE, device="cpu"), PE.build_plan(*spec),
                             kill_after=10 ** 9)


def test_divergent_replay_is_refused():
    """Failing over onto another seed walks another event sequence: the
    port's journal refuses it, as the reference's does."""
    journal = PJ.Journal(8)
    coord, _ = PE.make_engine(device="cpu", journal=journal, **OPTS)
    journal.arm_kill(40)
    with pytest.raises(PJ.CoordinatorKilled):
        coord.run_query(PE.build_plan("q6"))
    journal.resume()
    other, _ = PE.make_engine(device="cpu", journal=journal,
                              **{**OPTS, "seed": OPTS["seed"] + 1})
    with pytest.raises(PJ.JournalDivergence):
        other.run_query(PE.build_plan("q6"))
