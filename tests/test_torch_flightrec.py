"""The port's black-box flight recorder (node/flightrec.py), on the cases
of tests/test_flightrec.py.

The contracts: ring overflow keeps NEWEST events, the auto-dump
fires exactly once per failing transition (re-arming when the verdict
recovers), dumps are valid JSON with monotonic timestamps and a counter
snapshot, the kill switch makes the step path free, and the consensus
receive routine's crash hook records + dumps before re-raising."""

from __future__ import annotations

import glob
import json
import os

import pytest

from tendermint_tpu_torch.node.flightrec import FlightRecorder
from tests.test_torch_consensus import host_device  # noqa: F401 — autouse: CPU gateway defaults


class TestRing:
    def test_overflow_keeps_newest(self):
        rec = FlightRecorder(ring=16)
        for i in range(50):
            rec.record("step", height=i)
        evs = rec.events()
        assert len(evs) == 16
        assert [e["height"] for e in evs] == list(range(34, 50))
        assert rec.recorded == 50

    def test_events_last_slice(self):
        rec = FlightRecorder(ring=64)
        for i in range(10):
            rec.record("step", height=i)
        assert [e["height"] for e in rec.events(last=3)] == [7, 8, 9]

    def test_timestamps_monotonic(self):
        rec = FlightRecorder(ring=64)
        for i in range(100):
            rec.record("step", height=i)
        ts = [e["t"] for e in rec.events()]
        assert ts == sorted(ts)

    def test_kill_switch_costs_nothing_on_the_step_path(self):
        rec = FlightRecorder(ring=64)
        rec.set_enabled(False)
        for i in range(100):
            rec.record("step", height=i)
        rec.note_health("failing")
        rec.note_vote_dup("peer")
        rec.note_height_age(999.0, 1.0)
        rec.note_exception("consensus", RuntimeError("boom"))
        assert rec.recorded == 0
        assert rec.events() == []
        assert rec.dumps == 0, "a disabled recorder must write NOTHING"
        # and env-knob construction honors the same switch
        os.environ["TENDERMINT_FLIGHTREC_DISABLE"] = "1"
        try:
            assert FlightRecorder().enabled is False
        finally:
            del os.environ["TENDERMINT_FLIGHTREC_DISABLE"]


class TestAutoDump:
    def test_failing_transition_dumps_exactly_once_per_episode(self, tmp_path):
        rec = FlightRecorder(home=str(tmp_path), ring=32)
        rec.record("step", height=1)
        rec.note_health("ok")
        assert rec.dumps == 0
        rec.note_health("failing")
        rec.note_health("failing")   # repeated observation: same episode
        assert rec.dumps == 1
        rec.note_health("degraded")  # episode cleared: latch re-arms
        rec.note_health("failing")
        assert rec.dumps == 2
        files = glob.glob(str(tmp_path / "flightrec" / "dump-*health_failing*"))
        assert len(files) == 2

    def test_wedge_dump_once_per_episode_and_waived_in_fastsync(self, tmp_path):
        rec = FlightRecorder(home=str(tmp_path), ring=8)
        rec.note_height_age(120.0, 60.0, waived=True)   # fast sync: no dump
        assert rec.dumps == 0
        rec.note_height_age(120.0, 60.0)
        rec.note_height_age(130.0, 60.0)
        assert rec.dumps == 1
        rec.note_height_age(1.0, 60.0)                  # a commit re-arms
        rec.note_height_age(80.0, 60.0)
        assert rec.dumps == 2

    def test_dump_is_valid_json_with_monotonic_times_and_counters(
        self, tmp_path
    ):
        rec = FlightRecorder(home=str(tmp_path), ring=32)
        rec.counters_fn = lambda: {
            "peer_vote_gossip_picks": 10, "peer_vote_gossip_sends": 4,
        }
        for i in range(20):
            rec.record("step", height=5, round=0, step=i % 8)
        path = rec.dump("unit")
        assert path is not None and os.path.exists(path)
        with open(path) as f:
            payload = json.load(f)
        assert payload["reason"] == "unit"
        assert payload["counters"]["peer_vote_gossip_picks"] == 10
        ts = [e["t"] for e in payload["events"]]
        assert ts == sorted(ts) and len(ts) == 20
        assert payload["recorded_total"] == 20

    def test_two_dumps_in_one_second_get_distinct_files(self, tmp_path):
        rec = FlightRecorder(home=str(tmp_path), ring=8)
        p1 = rec.dump("same")
        p2 = rec.dump("same")
        assert p1 != p2 and os.path.exists(p1) and os.path.exists(p2)

    def test_dump_without_home_counts_but_never_raises(self):
        rec = FlightRecorder(ring=8)
        rec.record("step", height=1)
        assert rec.dump("nohome") is None
        assert rec.dumps == 1 and rec.dump_failures == 0

    def test_counter_provider_failure_costs_the_section_not_the_dump(
        self, tmp_path
    ):
        rec = FlightRecorder(home=str(tmp_path), ring=8)

        def boom():
            raise RuntimeError("mid-teardown")

        rec.counters_fn = boom
        path = rec.dump("provider_down")
        with open(path) as f:
            assert json.load(f)["counters"] == {}

    def test_exception_note_records_and_dumps(self, tmp_path):
        rec = FlightRecorder(home=str(tmp_path), ring=8)
        rec.note_exception("consensus", RuntimeError("boom"))
        assert rec.dumps == 1
        [ev] = [e for e in rec.events() if e["kind"] == "exception"]
        assert ev["thread"] == "consensus"
        assert "RuntimeError: boom" in ev["err"]


class TestConsensusCrashHook:
    def test_receive_routine_escape_dumps_then_reraises(self, tmp_path):
        """An exception ESCAPING the receive routine (not the per-item
        catch) must land in the ring + a dump before the thread dies."""
        from tendermint_tpu_torch.consensus.state import ConsensusState

        rec = FlightRecorder(home=str(tmp_path), ring=8)

        class _CS:
            flightrec = rec

            def _receive_routine(self, max_steps):
                raise RuntimeError("wedged interpreter state")

        with pytest.raises(RuntimeError, match="wedged"):
            ConsensusState.receive_routine(_CS(), 0)
        assert rec.dumps == 1
        assert any(e["kind"] == "exception" for e in rec.events())
        files = glob.glob(
            str(tmp_path / "flightrec" / "dump-*exception_consensus*")
        )
        assert len(files) == 1


class TestHealthIntegration:
    def test_health_report_feeds_the_recorder(self, tmp_path, monkeypatch):
        """node/health.health_report routes its verdict through
        note_health — the scrape path IS a dump trigger."""
        from tendermint_tpu_torch.node.health import health_report

        rec = FlightRecorder(home=str(tmp_path), ring=8)

        class _RS:
            height = 4

        class _CS:
            wal = None

            def height_age_s(self):
                return 0.1

            def pipeline_poisoned(self):
                return True  # -> failing

            def get_round_state(self):
                return _RS()

        class _BC:
            fast_sync = False

        class _SW:
            def num_peers(self):
                return (1, 1, 0)

        class _MP:
            def size(self):
                return 0

        class _Node:
            consensus_state = _CS()
            blockchain_reactor = _BC()
            sw = _SW()
            mempool = _MP()
            flightrec = rec

        report = health_report(_Node())
        assert report["status"] == "failing"
        assert rec.dumps == 1
        assert [e for e in rec.events() if e["kind"] == "health"]
        # second evaluation: same episode, no second dump
        health_report(_Node())
        assert rec.dumps == 1
