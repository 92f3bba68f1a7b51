"""The port's delta snapshots (tendermint_tpu_torch/statesync/,
docs/state-tree.md) on tests/test_statesync_delta.py's 17 cases: producer
cadence, deterministic format-2 roots, the delta tamper matrix, delta
chain restore byte-identity vs full-restore vs replay, crash-mid-chain
resume, and the reactor following a delta chain over the loopback net
(tests/test_torch_statesync.py's harness).
"""

from __future__ import annotations

import json
import tempfile
import time

import pytest

from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp, PersistentKVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.rpc.light import LightClient
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.statesync import (
    Manifest,
    Restorer,
    RestoreError,
    SnapshotProducer,
    SnapshotStore,
)
from tendermint_tpu_torch.statesync.devchain import DevChain
from tendermint_tpu_torch.statesync.snapshot import (
    KIND_DELTA,
    KIND_FULL,
    chunk_digest,
)


def wait_until(cond, timeout=30.0, tick=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


def _tx_fn(h: int) -> list[bytes]:
    """Writes, updates, and deletes — so deltas carry all three entry
    classes (the delete rides an absence proof)."""
    txs = [b"k%03d=v%d" % (h, h), b"shared=s%d" % h]
    if h > 4 and h % 2 == 0:
        txs.append(b"rm:k%03d" % (h - 4))
    return txs


def make_light_client(chain, **kw) -> LightClient:
    return LightClient(
        chain.rpc_stub(), chain.genesis_doc.chain_id,
        chain.state.load_validators(1), trusted_height=0, **kw,
    )


def build_delta_home(
    n_heights=12, interval=4, full_every=3, tail=2, chunk_size=2048, app=None,
):
    """(chain, store, producer): a kvstore chain snapshotting every
    `interval` heights with deltas between fulls. With the defaults the
    store holds full@4, delta@8 (base 4), delta@12 (base 8)."""
    chain = DevChain(app if app is not None else KVStoreApp())
    store = SnapshotStore(tempfile.mkdtemp(prefix="delta-snap-"))
    producer = SnapshotProducer(
        store, chain.app, chain.block_store, interval=interval,
        keep_recent=8, chunk_size=chunk_size, full_every=full_every,
    )
    for _ in range(n_heights):
        h = chain.state.last_block_height + 1
        chain.commit_block(_tx_fn(h))
        producer.maybe_snapshot(chain.state)
    chain.build(tail, tx_fn=_tx_fn)
    return chain, store, producer


def load_snapshot(store, height):
    m = store.load_manifest(height)
    assert m is not None
    return m, [store.load_chunk(height, i) for i in range(m.chunks)]


def fresh_restorer(chain, app=None):
    app = app if app is not None else KVStoreApp()
    state_db, block_db = MemDB(), MemDB()
    block_store = BlockStore(block_db)
    r = Restorer(
        chain.genesis_doc, app, state_db, block_store,
        light_client=make_light_client(chain),
    )
    return r, app, state_db, block_store


def chain_items(store, height):
    """The [(manifest, chunks)] chain ending at `height`, base first."""
    items = [load_snapshot(store, height)]
    while items[0][0].kind == KIND_DELTA:
        items.insert(0, load_snapshot(store, items[0][0].base_height))
    return items


# -- producer cadence ---------------------------------------------------------


class TestDeltaProducer:
    def test_full_delta_cadence(self):
        _chain, store, producer = build_delta_home()
        kinds = {h: store.load_manifest(h).kind for h in store.heights()}
        assert kinds == {4: KIND_FULL, 8: KIND_DELTA, 12: KIND_DELTA}
        assert store.load_manifest(8).base_height == 4
        assert store.load_manifest(12).base_height == 8
        assert producer.deltas_taken == 2
        # chain at full_every: the NEXT snapshot must be full again
        assert producer._delta_base(16) is None

    def test_delta_meaningfully_smaller(self):
        chain, store, _producer = build_delta_home(
            n_heights=8, interval=4, full_every=2
        )
        full = store.load_manifest(4)
        delta = store.load_manifest(8)
        assert delta.kind == KIND_DELTA
        # state grows every height, the per-interval change doesn't; at
        # even this tiny scale the delta should undercut the full copy
        assert delta.total_bytes < full.total_bytes * 3  # sanity ceiling
        # the real assertion rides bench_statetree at larger sizes

    def test_payload_excludes_seen_commit_manifest_carries_it(self):
        _chain, store, _p = build_delta_home()
        for h in store.heights():
            m, chunks = load_snapshot(store, h)
            assert m.seen_commit is not None
            joined = b"".join(chunks)
            assert b"seen_commit" not in joined
            # full payloads are byte-sliced; delta chunk 0 is the host
            host = json.loads(joined if m.kind == KIND_FULL else chunks[0])
            assert "seen_commit" not in host["block"]

    def test_replica_roots_identical_despite_divergent_seen_commits(self):
        """THE determinism property (ROADMAP item): replicas whose seen
        commits differ (3-of-4 vs 4-of-4 precommits on a real net) must
        still produce identical manifest ROOTS — the commit rides the
        manifest sidecar, outside the digested bytes."""
        roots, manifests = [], []
        for flip in (False, True):
            chain = DevChain(KVStoreApp())
            chain.build(4, tx_fn=_tx_fn)
            real_store = chain.block_store
            block_store = real_store
            if flip:
                class _DivergentStore:
                    """Same blocks, a different (node-local) seen commit
                    object — modeled by perturbing a signature byte; the
                    producer embeds, it does not verify."""

                    def __getattr__(self, name):
                        return getattr(real_store, name)

                    def load_seen_commit(self, h):
                        seen = real_store.load_seen_commit(h)
                        obj = seen.to_json()
                        tag, sig = obj["precommits"][0]["signature"]
                        flipped = bytearray(bytes.fromhex(sig))
                        flipped[0] ^= 0x01
                        obj["precommits"][0]["signature"] = [
                            tag, flipped.hex().upper()
                        ]
                        from tendermint_tpu_torch.types.block import Commit

                        return Commit.from_json(obj)

                block_store = _DivergentStore()
            store = SnapshotStore(tempfile.mkdtemp(prefix="replica-snap-"))
            producer = SnapshotProducer(
                store, chain.app, block_store, chunk_size=2048, full_every=1
            )
            h = producer.snapshot(chain.state)
            m = store.load_manifest(h)
            roots.append(m.root)
            manifests.append(m.to_json())
        assert roots[0] == roots[1], "seen commit leaked into the digest plane"
        assert manifests[0] != manifests[1]  # the sidecar itself differs

    def test_fallback_to_full_when_base_version_pruned(self):
        chain = DevChain(KVStoreApp())
        store = SnapshotStore(tempfile.mkdtemp(prefix="fb-snap-"))
        producer = SnapshotProducer(
            store, chain.app, chain.block_store, interval=4,
            keep_recent=8, chunk_size=2048, full_every=4,
        )
        for _ in range(4):
            chain.commit_block(_tx_fn(chain.state.last_block_height + 1))
        producer.maybe_snapshot(chain.state)
        # drop the tree's base version: the next snapshot MUST fall back
        chain.app.tree.keep_recent = 1
        chain.app.tree.rollback_to()  # prune trigger on next commit
        for _ in range(4):
            chain.commit_block(_tx_fn(chain.state.last_block_height + 1))
        producer.maybe_snapshot(chain.state)
        assert store.load_manifest(8).kind == KIND_FULL
        assert producer.deltas_taken == 0


# -- delta restore: byte-identity ---------------------------------------------


def _assert_byte_identical(chain, restorer, app, state_db, block_store, height):
    """The acceptance matrix: app hash + state map, block-store metas,
    persisted state — all byte-equal to the source chain at `height`."""
    assert app.height == height
    assert app.app_hash == chain.block_store.load_block_meta(
        height + 1
    ).header.app_hash
    src_app_state_at = {}  # rebuild source state AT height via replay? No:
    # the source chain is PAST height; compare against a replayed app below
    meta = block_store.load_block_meta(height)
    src_meta = chain.block_store.load_block_meta(height)
    assert meta.to_json() == src_meta.to_json()
    st = State.load_state(state_db, chain.genesis_doc)
    assert st.last_block_height == height
    assert st.app_hash == app.app_hash
    assert st.load_validators(height).hash() == chain.state.validators.hash()


def _replay_app_to(chain, height) -> KVStoreApp:
    """Replay the chain's txs from genesis through `height` into a fresh
    app — the from-genesis reference of the acceptance criterion."""
    app = KVStoreApp()
    for h in range(1, height + 1):
        block = chain.block_store.load_block(h)
        for tx in block.data.txs:
            app.deliver_tx(bytes(tx))
        app.commit()
    return app


class TestDeltaRestore:
    def test_chain_restore_byte_identical_to_full_and_replay(self):
        chain, store, _p = build_delta_home()
        items = chain_items(store, 12)
        assert [m.kind for m, _ in items] == [KIND_FULL, KIND_DELTA, KIND_DELTA]

        # -- delta-chain restore
        restorer, app, state_db, block_store = fresh_restorer(chain)
        state = restorer.restore_chain(items)
        assert state is not None and state.last_block_height == 12
        assert restorer.deltas_applied == 2
        _assert_byte_identical(chain, restorer, app, state_db, block_store, 12)

        # -- full restore of the same height, from a replica chain
        chain2 = DevChain(KVStoreApp())
        store2 = SnapshotStore(tempfile.mkdtemp(prefix="full-snap-"))
        producer2 = SnapshotProducer(
            store2, chain2.app, chain2.block_store, chunk_size=2048,
            full_every=1,
        )
        for _ in range(12):
            chain2.commit_block(_tx_fn(chain2.state.last_block_height + 1))
        producer2.snapshot(chain2.state)
        chain2.build(2, tx_fn=_tx_fn)
        assert store2.load_manifest(12).kind == KIND_FULL
        r2, app2, sdb2, bs2 = fresh_restorer(chain2)
        r2.restore(*load_snapshot(store2, 12))
        assert app2.app_hash == app.app_hash
        assert app2.state == app.state
        assert bs2.load_block_meta(12).to_json() == block_store.load_block_meta(12).to_json()

        # -- replay from genesis
        replayed = _replay_app_to(chain, 12)
        assert replayed.app_hash == app.app_hash
        assert replayed.state == app.state
        assert replayed.tree.root_hash() == app.tree.root_hash()

    def test_single_delta_entries_and_proofs_applied(self):
        chain, store, _p = build_delta_home()
        restorer, app, _sdb, _bs = fresh_restorer(chain)
        full_m, full_c = load_snapshot(store, 4)
        restorer.restore(full_m, full_c, seed=False)
        assert app.height == 4
        delta_m, delta_c = load_snapshot(store, 8)
        restorer.restore_delta(delta_m, delta_c)
        assert app.height == 8
        assert restorer.delta_entries_applied > 0
        # deletes actually happened (rm: txs at heights 6 and 8)
        assert "k002" not in app.state and "k004" not in app.state

    def test_crash_mid_chain_resumes(self):
        """A crash after an intermediate link applied (the app persists
        per link) must resume: earlier links skip, the chain completes,
        and the result is byte-identical."""
        chain, store, _p = build_delta_home()
        items = chain_items(store, 12)

        # run 1 "crashes" after the delta@8 link: simulate by applying
        # the first two links only (no seed — the crash window)
        r1, app, state_db, block_store = fresh_restorer(chain)
        r1.restore_step(*items[0], seed=False)
        r1.restore_step(*items[1], seed=False)
        assert app.height == 8 and block_store.height() == 0

        # run 2: a fresh restorer (fresh light walk) over the SAME app/
        # stores — restore_chain must skip to delta@12 and seed
        r2 = Restorer(
            chain.genesis_doc, app, state_db, block_store,
            light_client=make_light_client(chain),
        )
        state = r2.restore_chain(items)
        assert state is not None and state.last_block_height == 12
        assert r2.deltas_applied == 1  # only the final link re-applied
        _assert_byte_identical(chain, r2, app, state_db, block_store, 12)

    def test_unaligned_app_does_not_skip_the_base(self):
        """An app persisted at a height that matches NO chain link must
        not trigger the resume skip (which would blast past the full
        base into a misleading stale-delta error) — it hits the base
        restore's clear 'needs a fresh app' refusal instead."""
        chain, store, _p = build_delta_home()
        items = chain_items(store, 12)  # heights 4, 8, 12
        app = KVStoreApp()
        app.deliver_tx(b"unaligned=1")
        for h in range(5):  # app at height 5: between links
            app.commit()
        restorer, _, _sdb, _bs = fresh_restorer(chain, app=app)
        restorer.app = app
        with pytest.raises(RestoreError, match="fresh app"):
            restorer.restore_chain(items)
        assert app.height == 5  # untouched

    def test_stale_app_cannot_take_delta(self):
        chain, store, _p = build_delta_home()
        delta_m, delta_c = load_snapshot(store, 12)  # bases on 8
        restorer, app, _sdb, _bs = fresh_restorer(chain)
        full_m, full_c = load_snapshot(store, 4)
        restorer.restore(full_m, full_c, seed=False)  # app at 4, not 8
        with pytest.raises(RestoreError, match="stale delta"):
            restorer.restore_delta(delta_m, delta_c)
        assert app.height == 4  # nothing applied

    def test_persistent_app_delta_with_registry_aux(self, tmp_path):
        app = PersistentKVStoreApp(str(tmp_path / "src"))
        chain, store, _p = build_delta_home(app=app)
        items = chain_items(store, 12)
        host = json.loads(items[1][1][0])
        assert host["app_aux"] == {"validators": app.validators}
        assert app.validators, "init_chain should have seeded the registry"
        target = PersistentKVStoreApp(str(tmp_path / "dst"))
        restorer, _, state_db, block_store = fresh_restorer(chain, app=target)
        restorer.restore_chain(items)
        want = app.tree.root_hash(12)  # the source rode past 12 (tail)
        assert target.height == 12 and target.app_hash == want
        assert target.validators == app.validators
        # ...and the persisted home reloads at the delta head
        reloaded = PersistentKVStoreApp(str(tmp_path / "dst"))
        assert reloaded.height == 12 and reloaded.app_hash == want


# -- the delta tamper matrix --------------------------------------------------


def _redigest(manifest: Manifest, chunks: list[bytes]) -> Manifest:
    """An attacker-consistent manifest over tampered chunks (digest
    plane re-rooted; the header/app-hash bindings stay — those the
    attacker does NOT control)."""
    return Manifest(
        height=manifest.height, chain_id=manifest.chain_id,
        chunk_size=manifest.chunk_size,
        total_bytes=sum(len(c) for c in chunks),
        chunk_digests=[chunk_digest(c) for c in chunks],
        header_hash=manifest.header_hash, app_hash=manifest.app_hash,
        format_=manifest.format, kind=manifest.kind,
        base_height=manifest.base_height, seen_commit=manifest.seen_commit,
    )


class TestDeltaTamperMatrix:
    """Each tamper individually refused, with NOTHING applied (the app
    stays at its base height with its base hash)."""

    @pytest.fixture()
    def based(self):
        chain, store, _p = build_delta_home()
        restorer, app, _sdb, _bs = fresh_restorer(chain)
        restorer.restore(*load_snapshot(store, 4), seed=False)
        delta_m, delta_c = load_snapshot(store, 8)
        assert delta_m.chunks >= 2, "need at least one entry chunk"
        return chain, store, restorer, app, delta_m, list(delta_c)

    def _assert_refused(self, restorer, app, manifest, chunks, match):
        base_h, base_hash = app.height, app.app_hash
        with pytest.raises(RestoreError, match=match):
            restorer.restore_delta(manifest, chunks)
        assert app.height == base_h and app.app_hash == base_hash
        assert app.tree.latest_version() == base_h

    def test_corrupt_chunk(self, based):
        _chain, _store, restorer, app, m, chunks = based
        chunks[1] = bytes([chunks[1][0] ^ 0x01]) + chunks[1][1:]
        self._assert_refused(restorer, app, m, chunks, "digest mismatch")
        assert restorer.chunk_digest_failures >= 1

    def test_forged_proof(self, based):
        """Attacker flips an entry's value and re-digests the manifest:
        the proof no longer binds the entry."""
        _chain, _store, restorer, app, m, chunks = based
        grp = json.loads(chunks[1])
        assert grp["sets"], "expected upserts in the first entry chunk"
        grp["sets"][0][1] = b"forged-value".hex().upper()
        chunks[1] = json.dumps(grp, sort_keys=True).encode()
        self._assert_refused(
            restorer, app, _redigest(m, chunks), chunks, "proof"
        )
        assert restorer.delta_proof_failures >= 1

    def test_proof_for_wrong_root(self, based):
        """Proofs lifted from a DIFFERENT tree (valid against some other
        root) must die against the light-bound app hash."""
        chain, _store, restorer, app, m, chunks = based
        other = KVStoreApp()
        other.deliver_tx(b"alien=1")
        other.commit()
        grp = json.loads(chunks[1])
        key_hex, value_hex, _refs = grp["sets"][0]
        other.deliver_tx(
            bytes.fromhex(key_hex) + b"=" + bytes.fromhex(value_hex)
        )
        other.commit()
        alien = other.tree.prove(bytes.fromhex(key_hex))
        assert alien.verify(other.app_hash)  # valid... for the WRONG root
        grp["steps"] = [s.to_json() for s in alien.steps]
        grp["sets"] = [[key_hex, value_hex, list(range(len(alien.steps)))]]
        grp["dels"] = []
        chunks[1] = json.dumps(grp, sort_keys=True).encode()
        self._assert_refused(
            restorer, app, _redigest(m, chunks), chunks, "proof"
        )

    def test_stale_version_delta(self, based):
        """A REPLAYED old delta (base below the app's height) refused;
        re-applying the delta the app is already at is the idempotent
        resume case, not an attack."""
        _chain, store, restorer, app, m, chunks = based
        restorer.restore_delta(m, chunks, seed=False)  # app now at 8
        restorer.restore_delta(m, chunks, seed=False)  # resume: idempotent
        assert app.height == 8
        m12, c12 = load_snapshot(store, 12)
        restorer.restore_delta(m12, c12, seed=False)   # app now at 12
        self._assert_refused(restorer, app, m, chunks, "stale delta")

    def test_omitted_entry_caught_by_root(self, based):
        """Dropping one changed entry passes every per-chunk proof (each
        remaining entry IS in the tree) but the app's recomputed root
        cannot reach the verified hash — completeness enforced."""
        _chain, _store, restorer, app, m, chunks = based
        grp = json.loads(chunks[1])
        assert grp["sets"]
        grp["sets"] = grp["sets"][1:]  # omit one upsert
        chunks[1] = json.dumps(grp, sort_keys=True).encode()
        self._assert_refused(
            restorer, app, _redigest(m, chunks), chunks,
            "refused the delta|verified app hash",
        )


# -- reactor: delta chain over the loopback net -------------------------------


class TestReactorDeltaChain:
    def test_joiner_follows_delta_chain(self):
        from tests.test_torch_statesync import (
            _add_joiner_node,
            _add_server_node,
            _LoopbackNet,
        )

        chain, store, _p = build_delta_home(tail=3)
        target = chain.block_store.height()
        net = _LoopbackNet()
        _add_server_node(net, "honest", chain, store)
        _sw, joiner = _add_joiner_node(net, "joiner", chain)
        for sw in net.nodes.values():
            sw.start()
        net.connect("honest", "joiner")
        try:
            assert wait_until(lambda: joiner["done"], timeout=45), (
                joiner["reactor"].stats()
            )
            assert joiner["done"][0] is not None, "restore fell back"
            assert joiner["done"][0].last_block_height == 12
            assert joiner["app"].height == 12
            # the chain's base + intermediate links were consumed
            assert joiner["reactor"].stats()["chunks_fetched"] >= sum(
                m.chunks for m, _ in chain_items(store, 12)
            )
            # fast-sync tail converges (target-1: the head block needs a
            # successor commit in this consensus-less net)
            assert wait_until(
                lambda: joiner["block_store"].height() >= target - 1,
                timeout=30,
            )
            assert joiner["block_store"].base() == 12
        finally:
            net.stop()
