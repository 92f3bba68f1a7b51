"""The port's tx-lifecycle tracing (libs/txtrace.py + the tx_trace RPC), on
the cases of tests/test_txtrace.py but its two ops/txtrace cross-node
join cases (the tool is not in the port).

Contracts under test: the sampling knobs (first-K-per-height + 1-in-N),
keep-first stamp semantics, span TELESCOPING (stamped spans through
block_commit sum exactly to the commit latency), the bounded
active/ring tables (eviction seals, never drops silently), the kill
switch, the per-stage histograms, the mempool stamp sites, and the
consensus vote-duplicate counters."""

from __future__ import annotations

import threading
import time

import pytest

from tendermint_tpu_torch.libs import telemetry
from tendermint_tpu_torch.libs.txtrace import STAGES, TxTraceRecorder, txtrace_hists
from tests.test_torch_consensus import host_device  # noqa: F401 — autouse: CPU gateway defaults


def _tx(i: int) -> bytes:
    return b"txtrace-%04d=v" % i


class TestSampling:
    def test_first_k_per_height_plus_one_in_n(self):
        rec = TxTraceRecorder(first_k=2, sample_n=10)
        decisions = [rec.maybe_trace(_tx(i)) for i in range(25)]
        # first 2 sampled (the K window), then the countdown samples
        # every 10th submission after the burst
        assert decisions[0] and decisions[1]
        assert decisions[2:11] == [False] * 9
        assert decisions[11] is True  # the 1-in-10 countdown fired
        assert decisions[12:21] == [False] * 9
        assert decisions[21] is True
        assert rec.sampled == sum(decisions)

    def test_commit_resets_the_first_k_window(self):
        rec = TxTraceRecorder(first_k=1, sample_n=0)
        assert rec.maybe_trace(_tx(0))
        assert not rec.maybe_trace(_tx(1))
        rec.commit([_tx(0)], height=5)
        assert rec.maybe_trace(_tx(2)), "commit must re-arm first-K"

    def test_sample_n_zero_disables_the_modulo_arm(self):
        rec = TxTraceRecorder(first_k=0, sample_n=0)
        assert not any(rec.maybe_trace(_tx(i)) for i in range(50))
        assert rec.stats()["active"] == 0

    def test_kill_switch(self):
        rec = TxTraceRecorder(first_k=8, sample_n=1)
        rec.set_enabled(False)
        assert not rec.maybe_trace(_tx(0))
        rec.stamp(_tx(0), "mempool_admit")
        assert rec.stats() == {
            "sampled": 0, "completed": 0, "rejected": 0, "evicted": 0,
            "active": 0,
        }


class TestSpans:
    def test_spans_telescope_to_the_end_to_end_latencies(self):
        """The acceptance-bar arithmetic: stamped spans through
        block_commit sum EXACTLY to the commit latency (a bench asserts
        within 10% against the live node to guard the stamp sites)."""
        rec = TxTraceRecorder(first_k=1, sample_n=0)
        t0 = 1000.0
        assert rec.maybe_trace(_tx(0), at=t0)
        rec.stamp(_tx(0), "sig_gate", at=t0 + 0.010)
        rec.stamp(_tx(0), "mempool_admit", at=t0 + 0.015)
        rec.stamp(_tx(0), "p2p_broadcast", at=t0 + 0.020)
        rec.stamp_present([_tx(0)], "proposal", at=t0 + 0.100)
        rec.commit([_tx(0)], height=7, at=t0 + 0.200)
        rec.stamp_present([_tx(0)], "apply", at=t0 + 0.250)
        rec.delivered([_tx(0)], at=t0 + 0.260)

        [t] = rec.last(5)
        assert t["outcome"] == "committed" and t["height"] == 7
        assert t["commit_latency_s"] == pytest.approx(0.200)
        assert t["visible_latency_s"] == pytest.approx(0.260)
        commit_spans = sum(
            t["spans"][s] for s in STAGES
            if s in t["spans"] and STAGES.index(s) <= STAGES.index(
                "block_commit")
        )
        assert commit_spans == pytest.approx(t["commit_latency_s"], rel=1e-9)
        assert sum(t["spans"].values()) == pytest.approx(
            t["visible_latency_s"], rel=1e-9
        )
        # stage order in the record follows the canonical order
        stamped = [s for s in STAGES if s in t["stages"]]
        instants = [t["stages"][s] for s in stamped]
        assert instants == sorted(instants)

    def test_stamps_are_keep_first(self):
        rec = TxTraceRecorder(first_k=1, sample_n=0)
        rec.maybe_trace(_tx(0), at=10.0)
        rec.stamp(_tx(0), "proposal", at=11.0)
        rec.stamp(_tx(0), "proposal", at=99.0)  # re-proposed round
        rec.commit([_tx(0)], height=1, at=12.0)
        rec.delivered([_tx(0)], at=13.0)
        assert rec.last(1)[0]["stages"]["proposal"] == 11.0

    def test_untraced_stamps_are_no_ops(self):
        rec = TxTraceRecorder(first_k=1, sample_n=0)
        rec.stamp(_tx(5), "mempool_admit")      # nothing in flight
        rec.maybe_trace(_tx(0))
        rec.stamp(_tx(5), "mempool_admit")      # in flight, wrong tx
        assert rec.stats()["active"] == 1
        assert rec.last(5) == []


class TestBounds:
    def test_active_bound_evicts_oldest_as_sealed(self):
        rec = TxTraceRecorder(first_k=100, sample_n=0, max_active=3)
        for i in range(5):
            assert rec.maybe_trace(_tx(i))
        assert rec.stats()["active"] == 3
        assert rec.evicted == 2
        evicted = [t for t in rec.last(10) if t["outcome"] == "evicted"]
        assert {t["hash"] for t in evicted} == {
            rec._ring[0].hash.hex().upper(), rec._ring[1].hash.hex().upper()
        }

    def test_ring_keeps_newest(self):
        rec = TxTraceRecorder(first_k=100, sample_n=0, ring=4)
        for i in range(8):
            rec.maybe_trace(_tx(i), at=float(i))
            rec.commit([_tx(i)], height=i + 1, at=float(i) + 0.5)
            rec.delivered([_tx(i)], at=float(i) + 0.6)
        got = rec.last(10)
        assert len(got) == 4
        assert [t["height"] for t in got] == [8, 7, 6, 5]  # newest first

    def test_reject_seals_with_outcome(self):
        rec = TxTraceRecorder(first_k=1, sample_n=0)
        rec.maybe_trace(_tx(0))
        rec.reject(_tx(0), "bad_sig")
        assert rec.stats()["active"] == 0 and rec.rejected == 1
        assert rec.last(1)[0]["outcome"] == "bad_sig"


class TestMetrics:
    def test_seal_feeds_the_histograms(self):
        reg = telemetry.Registry()
        rec = TxTraceRecorder(first_k=1, sample_n=0)
        rec.metrics_registry = reg
        rec.maybe_trace(_tx(0), at=0.0)
        rec.stamp(_tx(0), "mempool_admit", at=0.010)
        rec.commit([_tx(0)], height=1, at=0.050)
        rec.delivered([_tx(0)], at=0.060)
        hists = txtrace_hists(reg)
        child = hists["stage"].labels(stage="mempool_admit")
        assert child.count == 1
        assert child.sum == pytest.approx(0.010)
        assert hists["commit"].count == 1
        assert hists["commit"].sum == pytest.approx(0.050)
        assert hists["visible"].sum == pytest.approx(0.060)

    def test_concurrent_stamps_never_corrupt(self):
        rec = TxTraceRecorder(first_k=1000, sample_n=0, max_active=1000)
        txs = [_tx(i) for i in range(64)]
        for t in txs:
            rec.maybe_trace(t)

        def worker(stage):
            for t in txs:
                rec.stamp(t, stage)

        threads = [
            threading.Thread(target=worker, args=(s,))
            for s in ("sig_gate", "mempool_admit", "p2p_broadcast")
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rec.commit(txs, height=1)
        rec.delivered(txs)
        assert rec.completed == 64
        for tr in rec.last(64):
            assert set(tr["stages"]) >= {
                "rpc_ingress", "sig_gate", "mempool_admit", "p2p_broadcast",
                "block_commit", "event_delivery",
            }


class TestMempoolIntegration:
    def _mempool(self):
        from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
        from tendermint_tpu_torch.abci.client import LocalClient
        from tendermint_tpu_torch.config import test_config
        from tendermint_tpu_torch.mempool import Mempool
        from tendermint_tpu_torch.proxy.app_conn import AppConnMempool

        mp = Mempool(
            test_config().mempool,
            AppConnMempool(LocalClient(KVStoreApp(), threading.RLock())),
        )
        mp.txtrace = TxTraceRecorder(first_k=4, sample_n=0)
        return mp

    def test_check_tx_stamps_ingress_and_admit(self):
        mp = self._mempool()
        tx = b"k1=v1"
        mp.check_tx(tx)
        deadline = time.monotonic() + 10
        while mp.size() < 1 and time.monotonic() < deadline:
            mp.flush_app_conn()
            time.sleep(0.005)
        assert mp.size() == 1
        [active] = mp.txtrace.active()
        assert active["source"] == "rpc"
        assert "rpc_ingress" in active["stages"]
        assert "mempool_admit" in active["stages"]

    def test_peer_source_tags_the_trace(self):
        mp = self._mempool()
        mp.check_tx(b"k2=v2", source="peer")
        [active] = mp.txtrace.active()
        assert active["source"] == "peer"


class TestRPCAndCLI:
    def test_tx_trace_rpc_handler_filters_by_hash(self):
        from tendermint_tpu_torch.rpc.core.handlers import tx_trace

        rec = TxTraceRecorder(first_k=4, sample_n=0)
        rec.maybe_trace(_tx(0), at=1.0)
        rec.maybe_trace(_tx(1), at=2.0)
        rec.commit([_tx(0)], height=3, at=4.0)
        rec.delivered([_tx(0)], at=5.0)

        class _Node:
            txtrace = rec

        class _Ctx:
            node = _Node()

        res = tx_trace(_Ctx())
        assert len(res["traces"]) == 1 and len(res["active"]) == 1
        want = res["traces"][0]["hash"]
        res2 = tx_trace(_Ctx(), hash=want.lower())
        assert [t["hash"] for t in res2["traces"]] == [want]
        assert res2["active"] == []
        # a context without a node answers empty, never raises
        class _Bare:
            node = None

        assert tx_trace(_Bare()) == {"traces": [], "active": []}


class TestVoteDuplicateCounters:
    def test_peer_duplicate_counted_flat_and_per_peer(self):
        """a gossiped vote begin_add screens as
        already-seen counts on consensus_vote_duplicates AND the
        sender's p2p_peer_vote_duplicates_total series — the 2NxN
        redundancy before-number. Our own re-delivered votes do not
        count (empty peer_id)."""
        from tendermint_tpu_torch.p2p.telemetry import peer_metrics
        from tests.test_torch_consensus import TEST_CHAIN_ID, make_cs_and_stubs
        from tendermint_tpu_torch.types import BlockID
        from tendermint_tpu_torch.types.vote import VOTE_TYPE_PREVOTE

        cs, stubs, prop_idx = make_cs_and_stubs(4)
        reg = telemetry.Registry()
        cs.trace.metrics_registry = reg
        bid = BlockID(b"\x11" * 20)
        voter = next(s for s in stubs if s.index != prop_idx)
        vote = voter.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, bid)
        assert cs.add_vote(vote, "peer-A") is True
        assert cs.vote_duplicates == 0
        # the same vote from two peers: each re-delivery counts against
        # its sender
        assert cs.add_vote(vote, "peer-A") is False
        assert cs.add_vote(vote, "peer-B") is False
        assert cs.vote_duplicates == 2
        fams = peer_metrics(reg)
        assert fams["vote_duplicates"].labels(peer="peer-A").value == 1
        assert fams["vote_duplicates"].labels(peer="peer-B").value == 1
        # our own duplicate (internal redelivery) is not gossip waste
        assert cs.add_vote(vote, "") is False
        assert cs.vote_duplicates == 2


class TestGatedMempoolEdges:
    """Every early exit from the lifecycle on a
    GATED mempool seals or stamps the trace — saturation refusals seal
    (never a false PARKED), gate-bypassing txs still get their admit
    stamp, and the ring serves under concurrent stamping."""

    def _gated_mempool(self, max_backlog=8192, parse=None):
        from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
        from tendermint_tpu_torch.abci.client import LocalClient
        from tendermint_tpu_torch.config import test_config
        from tendermint_tpu_torch.mempool import Mempool
        from tendermint_tpu_torch.mempool.mempool import SigBatcher
        from tendermint_tpu_torch.ops.gateway import Verifier

        from tendermint_tpu_torch.proxy.app_conn import AppConnMempool

        batcher = SigBatcher(
            Verifier(min_tpu_batch=1 << 30, device="cpu"),
            parse if parse is not None else (lambda tx: None),
            max_backlog=max_backlog,
        )
        mp = Mempool(
            test_config().mempool,
            AppConnMempool(LocalClient(KVStoreApp(), threading.RLock())),
            sig_batcher=batcher,
        )
        mp.txtrace = TxTraceRecorder(first_k=8, sample_n=0)
        return mp

    def test_gate_saturation_seals_the_trace(self):
        # max_backlog=0: every parseable tx is refused at submit
        mp = self._gated_mempool(
            max_backlog=0,
            parse=lambda tx: (b"\x00" * 32, tx, b"\x00" * 64),
        )
        mp.check_tx(b"sat=1")
        rec = mp.txtrace
        assert rec.stats()["active"] == 0, "refused tx left in flight"
        [t] = rec.last(5)
        assert t["outcome"] == "gate_saturated"
        assert rec.rejected == 1

    def test_gate_bypassing_tx_still_gets_admit_stamp(self):
        # parse -> None: the tx bypasses the gate to the app directly;
        # the batch-granular admit stamp never covers it, so its own
        # response callback must
        mp = self._gated_mempool(parse=lambda tx: None)
        tx = b"bypass=v"
        mp.check_tx(tx)
        deadline = time.monotonic() + 10
        while mp.size() < 1 and time.monotonic() < deadline:
            mp.flush_app_conn()
            time.sleep(0.005)
        assert mp.size() == 1
        [active] = mp.txtrace.active()
        assert "mempool_admit" in active["stages"], active


class TestUnwantedRoundNotCounted:
    def test_catchup_budget_drop_is_not_a_duplicate(self):
        """A vote dropped because its round is
        beyond the peer's catchup budget was never SEEN — it must not
        inflate the 2NxN redundancy counters."""
        from tests.test_torch_consensus import TEST_CHAIN_ID, make_cs_and_stubs
        from tendermint_tpu_torch.types import BlockID
        from tendermint_tpu_torch.types.vote import VOTE_TYPE_PREVOTE

        cs, stubs, prop_idx = make_cs_and_stubs(4)
        cs.trace.metrics_registry = telemetry.Registry()
        bid = BlockID(b"\x22" * 20)
        voter = next(s for s in stubs if s.index != prop_idx)

        # sign each round ONCE, ascending (the privval's double-sign
        # guard refuses re-signing a lower round); re-deliveries reuse
        # the signed vote object like real gossip does
        def vote_at(round_):
            from tendermint_tpu_torch.types.vote import Vote

            v = Vote(
                validator_address=voter.pv.get_address(),
                validator_index=voter.index,
                height=cs.rs.height,
                round_=round_,
                type_=VOTE_TYPE_PREVOTE,
                block_id=bid,
            )
            return voter.pv.sign_vote(TEST_CHAIN_ID, v)

        v10, v20, v30 = vote_at(10), vote_at(20), vote_at(30)
        # two catchup rounds fit the per-peer budget
        assert cs.add_vote(v10, "peer-C") is True
        assert cs.add_vote(v20, "peer-C") is True
        dup0 = cs.vote_duplicates
        # third distinct round: catchup budget spent -> dropped
        # (HeightVoteSet UNWANTED_ROUND), NOT counted as a duplicate
        assert cs.add_vote(v30, "peer-C") is False
        assert cs.vote_duplicates == dup0
        # a genuine re-delivery still counts
        assert cs.add_vote(v10, "peer-C") is False
        assert cs.vote_duplicates == dup0 + 1


class TestEqualToJax:
    def test_same_stamps_give_equal_traces_hists_and_rpc(self):
        """One sequence of samplings, stamps, gate batches, rejects,
        commits and deliveries, at the same instants, fed to both
        packages' recorders (each with a registry of its own) gives equal
        completed and active traces, stats, txtrace_hists renders and
        tx_trace RPC bodies, whole and filtered by one tx's hash."""
        from tendermint_tpu.libs import telemetry as jtelemetry
        from tendermint_tpu.libs import txtrace as jtxtrace
        from tendermint_tpu.rpc.core import handlers as jhandlers
        from tendermint_tpu_torch.libs import txtrace
        from tendermint_tpu_torch.rpc.core import handlers
        from tendermint_tpu_torch.types.tx import tx_hash

        def drop_wall(rows):
            # completed_at is the wall clock's at the seal
            return [{k: v for k, v in r.items() if k != "completed_at"} for r in rows]

        def run(tel, mod, rpc):
            reg = tel.Registry()
            rec = mod.TxTraceRecorder(ring=6, first_k=3, sample_n=4, max_active=5)
            rec.metrics_registry = reg
            t = 100.0
            for h in range(1, 5):
                txs = [_tx(100 * h + i) for i in range(14)]
                for i, tx in enumerate(txs):
                    rec.maybe_trace(tx, source="peer" if i % 5 == 0 else "rpc", at=t + 0.01 * i)
                rec.stamp_gate_batch([(tx, None) for tx in txs[::2]], at=t + 0.2)
                for tx in txs:
                    rec.stamp(tx, "mempool_admit", at=t + 0.25)
                    rec.stamp(tx, "p2p_broadcast", at=t + 0.3)
                rec.reject(txs[6], "rejected")
                rec.stamp_present(txs[:10], "proposal", at=t + 0.5)
                rec.commit(txs[:10], height=h, at=t + 1.0)
                rec.stamp_present(txs[:10], "apply", at=t + 1.1)
                rec.delivered(txs[:9], at=t + 1.2)
                t += 2.0

            class _Ctx:
                class node:
                    txtrace = rec

            want = tx_hash(_tx(401)).hex()
            whole, one = rpc.tx_trace(_Ctx(), last=10), rpc.tx_trace(_Ctx(), hash=want)
            mod.txtrace_hists(reg)  # create-or-get: the families the seals fed
            return {
                "last": drop_wall(rec.last(10)), "active": drop_wall(rec.active()), "stats": rec.stats(),
                "render": reg.render_prometheus(), "flat": reg.flatten(),
                "rpc": {k: drop_wall(v) for k, v in whole.items()},
                "rpc_one": {k: drop_wall(v) for k, v in one.items()},
            }

        jax_side = run(jtelemetry, jtxtrace, jhandlers)
        port_side = run(telemetry, txtrace, handlers)
        assert port_side["stats"]["completed"] > 0 and port_side["stats"]["evicted"] > 0
        assert port_side["stats"]["rejected"] > 0 and port_side["active"]
        assert port_side["rpc_one"]["traces"] or port_side["rpc_one"]["active"]
        assert "tx_stage_seconds" in port_side["render"]
        for key in jax_side:
            assert port_side[key] == jax_side[key], key
