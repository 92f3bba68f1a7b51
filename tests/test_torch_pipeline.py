"""The port's pipelined execution plane (consensus/pipeline.py and the
deferred apply in consensus/state.py) on the CPU: the cases of
tests/test_pipeline.py.
"""

from __future__ import annotations

import io
import threading
import time

from test_torch_consensus import host_device  # noqa: F401
from test_torch_consensus import EventCollector, new_consensus_state, wait_for_height

from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp, PersistentKVStoreApp
from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.types import GenesisDoc, GenesisValidator, PrivValidatorFS
from tendermint_tpu_torch.types import events as tev

GENESIS_NS = 1_700_000_000_000_000_000


def _det_state(seed: bytes = b"pipeline-test"):
    """Deterministic single-validator genesis: seeded key + pinned
    genesis time, so two runs build byte-identical chains."""
    pv = PrivValidatorFS(gen_priv_key_ed25519(seed), None)
    doc = GenesisDoc(
        genesis_time_ns=GENESIS_NS,
        chain_id="pipeline_chain",
        validators=[GenesisValidator(pv.get_pub_key(), 1, "v0")],
    )
    return State.get_state(MemDB(), doc), pv


def _run_chain(
    pipeline: bool,
    n_heights: int = 4,
    txs: list[bytes] | None = None,
    app=None,
    txs_per_block: int = 0,
    hook=None,
):
    """Commit `n_heights` on a real single-validator ConsensusState and
    return (per-height fingerprints, the stopped cs)."""
    state, pv = _det_state()
    app = app if app is not None else KVStoreApp()
    cs = new_consensus_state(state, pv, app=app)
    cs.pipeline_apply = pipeline
    cs.propose_time_source = lambda h: GENESIS_NS + h * 1_000_000_000
    if txs_per_block:
        cs.config.max_block_size_txs = txs_per_block
    if hook is not None:
        cs.post_apply_hook = hook
    for tx in txs or []:
        res = cs.mempool.check_tx(tx)
        assert res is None or getattr(res, "code", 0) == 0
    blocks = EventCollector(cs.evsw, tev.EVENT_NEW_BLOCK)
    cs.start()
    try:
        assert wait_for_height(cs, n_heights + 1, timeout=30), (
            f"chain stalled at {cs.rs.height} (pipeline={pipeline})"
        )
        # NEW_BLOCK fires post-apply: waiting for the event of height n
        # also guarantees the deferred applies of 1..n completed
        assert blocks.wait_for(n_heights, timeout=30)
    finally:
        cs.stop()
    fps = {}
    for h in range(1, n_heights + 1):
        meta = cs.block_store.load_block_meta(h)
        block = cs.block_store.load_block(h)
        fps[h] = (
            meta.block_id.hash.hex(),
            meta.block_id.parts_header.hash.hex(),
            block.header.app_hash.hex(),
            tuple(tx.hex() for tx in block.data.txs),
        )
    return fps, cs


def test_pipelined_chain_byte_identical_to_serial():
    txs = [f"k{i:03d}=v{i}".encode() for i in range(60)]
    serial_fps, serial_cs = _run_chain(False, n_heights=4, txs=txs,
                                       txs_per_block=20)
    piped_fps, piped_cs = _run_chain(True, n_heights=4, txs=txs,
                                     txs_per_block=20)
    assert piped_fps == serial_fps
    # the serial run never deferred; the pipelined run deferred every
    # height and actually measured joins
    assert serial_cs.pipeline_applies == 0
    assert serial_cs.pipeline_serial_commits >= 4
    assert piped_cs.pipeline_applies >= 4
    assert piped_cs.pipeline_serial_commits == 0
    # txs actually landed (saturating the 20-tx blocks first)
    assert len(piped_fps[1][3]) == 20


def test_deferred_apply_overlaps_and_traces():
    txs = [f"t{i:03d}=v".encode() for i in range(40)]
    _, cs = _run_chain(True, n_heights=4, txs=txs, txs_per_block=10)
    traces = cs.trace.last(4)
    assert traces
    for t in traces:
        total = sum(t.segments.values())
        tol = max(0.05 * t.wall_s, 0.005)
        assert abs(total - t.wall_s) <= tol, (t.height, total, t.wall_s)
        # the consensus thread never ran apply inline
        assert "apply" not in t.segments
        if t.height > 1:
            assert "overlap_apply_s" in t.aux, (t.height, t.aux)
            assert "pipeline_join_wait_s" in t.aux, (t.height, t.aux)
    # the operator CLI renders the traces' overlap split, as the JAX
    # package's renders the same traces
    from tendermint_tpu.ops.trace import render as jrender
    from tendermint_tpu_torch.ops.trace import render

    out, jout = io.StringIO(), io.StringIO()
    render([t.to_json() for t in traces], out=out)
    jrender([t.to_json() for t in traces], out=jout)
    text = out.getvalue()
    assert "apply(H-1)" in text
    assert "join wait" in text
    assert text == jout.getvalue()


def test_hook_failure_never_wedges_consensus():
    calls = []

    def bad_hook(state, block):
        calls.append(block.header.height)
        raise RuntimeError("snapshot producer exploded")

    fps, cs = _run_chain(True, n_heights=3, txs=[b"a=1", b"b=2"],
                         hook=bad_hook)
    assert len(fps) == 3
    assert calls, "hook never fired from the executor"
    assert cs._apply_poisoned is None


def test_events_arrive_post_apply_in_order():
    state, pv = _det_state()
    app = KVStoreApp()
    cs = new_consensus_state(state, pv, app=app)
    cs.pipeline_apply = True
    app_heights_at_event = []
    blocks = EventCollector(cs.evsw, tev.EVENT_NEW_BLOCK)

    def on_block(data):
        # NEW_BLOCK for H must observe the app already committed at H —
        # the executor fires it after apply, never before
        app_heights_at_event.append((data.block.header.height, app.height))

    cs.evsw.add_listener_for_event("pipe-test", tev.EVENT_NEW_BLOCK, on_block)
    cs.mempool.check_tx(b"x=1")
    cs.start()
    try:
        assert blocks.wait_for(3, timeout=20)
    finally:
        cs.stop()
    heights = [d.block.header.height for d in blocks.items[:3]]
    assert heights == [1, 2, 3]
    for block_h, app_h in app_heights_at_event:
        assert app_h >= block_h, (block_h, app_h)


def test_valset_change_reconciles_at_join():
    import tempfile

    state, pv = _det_state()
    app = PersistentKVStoreApp(tempfile.mkdtemp(prefix="pipe-val-"))
    cs = new_consensus_state(state, pv, app=app)
    cs.pipeline_apply = True
    pub_hex = pv.get_pub_key().raw.hex()
    cs.mempool.check_tx(f"val:{pub_hex}/5".encode())
    cs.start()
    try:
        assert wait_for_height(cs, 4, timeout=30), (
            f"chain stalled at {cs.rs.height} after the valset change"
        )
    finally:
        cs.stop()
    assert cs.pipeline_valset_reconciles >= 1
    assert cs.state.validators.validators[0].voting_power == 5


def test_failed_apply_poisons_joins_and_wedges():
    state, pv = _det_state()

    class ExplodingApp(KVStoreApp):
        def commit(self):
            if self.height >= 1:  # height 2's commit explodes
                raise RuntimeError("app commit failure")
            return super().commit()

    cs = new_consensus_state(state, pv, app=ExplodingApp())
    cs.pipeline_apply = True
    cs.start()
    try:
        # height 1 commits; apply(2) fails on the executor; the join
        # poisons — the chain must NOT advance past height 3's start
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline and cs._apply_poisoned is None:
            time.sleep(0.05)
        assert cs._apply_poisoned is not None, "apply failure never surfaced"
        wedged_at = cs.rs.height
        time.sleep(0.5)
        assert cs.rs.height == wedged_at, "consensus advanced past a failed apply"
        assert cs.block_store.height() <= wedged_at
    finally:
        cs.stop()


# -- sharded parallel apply (app-level determinism) -----------------------


def _tx_workload():
    txs = []
    for i in range(200):
        txs.append(f"key{i % 37}=value{i}".encode())  # hot keys: last-wins
    txs += [b"plainkey", b"rm:key3", b"key3=resurrected", b"rm:key11",
            b"rm:missing"]
    txs += [f"wide{i}={'x' * 50}".encode() for i in range(64)]
    return txs


def test_sharded_deliver_txs_byte_identical_to_serial():
    txs = _tx_workload()
    serial, sharded = KVStoreApp(), KVStoreApp()
    sharded.shards = 3
    sharded.shard_min_txs = 4
    r1 = [serial.deliver_tx(tx) for tx in txs]
    r2 = sharded.deliver_txs(list(txs))
    assert [r.code for r in r1] == [r.code for r in r2]
    assert sharded.sharded_batches == 1
    assert serial.state == sharded.state
    h1 = serial.commit().data
    h2 = sharded.commit().data
    assert h1 == h2, "sharded apply forked the VersionedTree root"


def test_sharded_deliver_persistent_val_txs_in_order(tmp_path):
    pub_a = gen_priv_key_ed25519(b"val-a").pub_key().raw.hex()
    pub_b = gen_priv_key_ed25519(b"val-b").pub_key().raw.hex()
    txs = [b"k1=v1", f"val:{pub_a}/3".encode(), b"k2=v2",
           f"val:{pub_b}/7".encode(), b"rm:k1",
           f"val:{pub_a}/0".encode(), b"val:junk", b"k3=v3"] * 6
    serial = PersistentKVStoreApp(str(tmp_path / "serial"))
    sharded = PersistentKVStoreApp(str(tmp_path / "sharded"))
    sharded.shards = 2
    sharded.shard_min_txs = 4
    serial.begin_block(b"", None)
    sharded.begin_block(b"", None)
    r1 = [serial.deliver_tx(tx) for tx in txs]
    r2 = sharded.deliver_txs(list(txs))
    assert [r.code for r in r1] == [r.code for r in r2]
    # validator diffs keep TX order (EndBlock payload identity)
    d1 = [(v.pub_key_json, v.power) for v in serial.end_block(1).diffs]
    d2 = [(v.pub_key_json, v.power) for v in sharded.end_block(1).diffs]
    assert d1 == d2 and len(d1) == 18
    assert serial.validators == sharded.validators
    assert serial.state == sharded.state
    assert serial.commit().data == sharded.commit().data


def test_sharded_path_below_floor_stays_serial():
    app = KVStoreApp()
    app.shards = 4
    app.shard_min_txs = 32
    app.deliver_txs([b"a=1", b"b=2"])
    assert app.sharded_batches == 0
    assert app.state == {"a": b"1", "b": b"2"}


def test_pipelined_plus_sharded_chain_matches_serial():
    """The acceptance combination: pipeline + sharded apply through real
    consensus, byte-identical to the fully serial chain."""
    txs = [f"s{i:03d}=v{i}".encode() for i in range(80)]
    serial_fps, _ = _run_chain(False, n_heights=3, txs=txs, txs_per_block=40)

    app = KVStoreApp()
    app.shards = 2
    app.shard_min_txs = 8
    piped_fps, cs = _run_chain(True, n_heights=3, txs=txs,
                               txs_per_block=40, app=app)
    assert piped_fps == serial_fps
    assert app.sharded_batches >= 2, "wide blocks never took the sharded path"


def test_join_wait_telemetry_populates():
    from tendermint_tpu_torch.consensus.pipeline import pipeline_hists

    before = pipeline_hists()["join_wait"].count
    _, cs = _run_chain(True, n_heights=3, txs=[b"m=1"])
    assert cs.pipeline_join_wait_last >= 0.0
    assert pipeline_hists()["join_wait"].count > before
