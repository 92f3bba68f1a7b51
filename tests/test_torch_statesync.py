"""The port's state-sync subsystem (tendermint_tpu_torch/statesync/,
docs/state-sync.md) on tests/test_statesync.py's cases (TestNodeWiring on
a port node with the CPU defaults), and against the JAX package's: the two
producers' manifests and chunks are byte-equal on equal chains, each
package's Restorer restores the other's snapshot to equal states and
store records, and a node of each package state-syncs from a node of the
other over the loopback net and fast-syncs the tail. Last, the port's
rule for a device error (ops.gateway.DeviceError) in a restore: it ends
the restore visibly, bans no peer and falls back to nothing.

Tiers:
- fast (tier 1): chunk framing + manifest decode hardening, the snapshot
  store's CRC/damage contracts, producer determinism + interval gating,
  the restore tamper matrix (every verification gate must individually
  refuse), BlockStore seed/prune + the RPC below-base error, and a small
  p2p net where a fresh node restores over the statesync reactor — with
  a corrupting peer banned mid-download and the chunk re-fetched from an
  honest one — then fast-syncs the tail via start_after_statesync.
- slow: the acceptance soak — a fresh node restores a >=1k-block
  signedkv home from a snapshot and ends byte-identical (app hash,
  block-store contents, every subsequent committed height) to a node
  that fast-synced the same chain from genesis.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

import pytest

from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.rpc.light import LightClient
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.statesync import (
    Manifest,
    Restorer,
    RestoreError,
    SnapshotError,
    SnapshotProducer,
    SnapshotStore,
)
from tendermint_tpu_torch.statesync.devchain import (
    build_kvstore_chain,
    build_signedkv_chain,
)
from tendermint_tpu_torch.statesync.snapshot import (
    CHUNK_MAGIC,
    chunk_digest,
    chunk_digests_root,
    chunk_payload,
    frame_chunk,
    unframe_chunk,
)


def wait_until(cond, timeout=30.0, tick=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


def make_light_client(chain, **kw) -> LightClient:
    """A light client anchored at the chain's genesis validator set,
    verifying against the DevChain's RPC stub."""
    return LightClient(
        chain.rpc_stub(), chain.genesis_doc.chain_id,
        chain.state.load_validators(1), trusted_height=0, **kw,
    )


_chain_cache: dict = {}


def snapshot_chain(n_blocks=20, tail=3, chunk_size=4096, builder=build_kvstore_chain):
    """A chain with a snapshot at height `n_blocks` and `tail` more
    blocks after it (the manifest binds to header H+1, so a snapshot is
    only restorable once the chain extends past it). Memoized per arg
    tuple — the many restore-tamper tests only READ the chain/store
    (they tamper payload copies and restore into fresh targets), and
    rebuilding a signed chain per test is the file's dominant cost."""
    key = (n_blocks, tail, chunk_size, builder)
    if key not in _chain_cache:
        chain = builder(n_blocks)
        store = SnapshotStore(tempfile.mkdtemp(prefix="snapstore-"))
        producer = SnapshotProducer(
            store, chain.app, chain.block_store, chunk_size=chunk_size
        )
        height = producer.snapshot(chain.state)
        chain.build(tail)
        _chain_cache[key] = (chain, store, producer, height)
    return _chain_cache[key]


def fresh_restorer(chain, app=None, **kw):
    """A Restorer over fresh app/state/store targets, light-verifying
    against `chain`. Returns (restorer, app, state_db, block_store)."""
    app = app if app is not None else KVStoreApp()
    state_db, block_db = MemDB(), MemDB()
    block_store = BlockStore(block_db)
    r = Restorer(
        chain.genesis_doc, app, state_db, block_store,
        light_client=kw.pop("light_client", make_light_client(chain)), **kw,
    )
    return r, app, state_db, block_store


def load_snapshot(store, height):
    m = store.load_manifest(height)
    assert m is not None
    return m, [store.load_chunk(height, i) for i in range(m.chunks)]


# -- chunk framing ------------------------------------------------------------


class TestChunkFraming:
    def test_round_trip(self):
        for payload in (b"", b"x", b"hello" * 1000):
            assert unframe_chunk(frame_chunk(payload)) == payload

    def test_bit_flip_detected(self):
        buf = bytearray(frame_chunk(b"payload-bytes" * 64))
        buf[len(buf) // 2] ^= 0x40
        with pytest.raises(SnapshotError, match="crc|length"):
            unframe_chunk(bytes(buf))

    def test_truncation_detected(self):
        buf = frame_chunk(b"payload-bytes" * 64)
        for cut in (1, len(buf) // 2, len(buf) - 1):
            with pytest.raises(SnapshotError):
                unframe_chunk(buf[:cut])

    def test_trailing_garbage_detected(self):
        with pytest.raises(SnapshotError, match="length"):
            unframe_chunk(frame_chunk(b"abc") + b"\x00")

    def test_bad_magic_detected(self):
        buf = frame_chunk(b"abc")
        with pytest.raises(SnapshotError, match="magic"):
            unframe_chunk(b"X" + buf[1:])
        assert buf.startswith(CHUNK_MAGIC)

    def test_chunk_payload_split(self):
        payload = bytes(range(256)) * 10
        chunks = chunk_payload(payload, 1000)
        assert b"".join(chunks) == payload
        assert all(len(c) == 1000 for c in chunks[:-1])
        assert chunk_payload(b"", 1024) == [b""]  # well-formed empty
        with pytest.raises(ValueError):
            chunk_payload(b"x", 0)


# -- manifest decode hardening ------------------------------------------------


class TestManifest:
    def _manifest(self, n_chunks=4) -> Manifest:
        digests = [chunk_digest(bytes([i]) * 100) for i in range(n_chunks)]
        return Manifest(
            height=20, chain_id="devchain", chunk_size=100,
            total_bytes=100 * n_chunks, chunk_digests=digests,
            header_hash=b"\x11" * 20, app_hash=b"\x22" * 20,
        )

    def test_json_round_trip(self):
        m = self._manifest()
        m2 = Manifest.from_json(json.loads(json.dumps(m.to_json())))
        assert m2.root == m.root == chunk_digests_root(m.chunk_digests)
        assert m2.chunk_digests == m.chunk_digests
        assert m2.to_json() == m.to_json()

    def test_root_digest_disagreement_rejected(self):
        obj = self._manifest().to_json()
        obj["root"] = chunk_digests_root([b"\x00" * 20]).hex().upper()
        with pytest.raises(ValueError, match="root"):
            Manifest.from_json(obj)

    def test_tampered_digest_rejected(self):
        # flipping one digest breaks the root binding — the lynchpin of
        # the whole per-chunk verification scheme
        obj = self._manifest().to_json()
        obj["chunk_digests"][0] = ("00" * 20).upper()
        with pytest.raises(ValueError, match="root"):
            Manifest.from_json(obj)

    @pytest.mark.parametrize("mutate", [
        lambda o: o.update(height=0),
        lambda o: o.update(chain_id=7),
        lambda o: o.update(chunk_size=0),
        lambda o: o.update(chunk_digests=[]),
        lambda o: o.update(chunk_digests="zz"),
        lambda o: o.update(chunk_digests=["zz"]),
        lambda o: o.update(header_hash="11"),  # not 20 bytes
        lambda o: o.pop("root"),
    ])
    def test_malformed_fields_rejected(self, mutate):
        obj = self._manifest().to_json()
        mutate(obj)
        with pytest.raises((ValueError, KeyError, TypeError)):
            Manifest.from_json(obj)

    def test_lite_is_discovery_subset(self):
        lite = self._manifest().lite()
        assert set(lite) == {
            "format", "height", "chain_id", "chunks", "total_bytes",
            "root", "header_hash", "kind",
        }


# -- the on-disk store --------------------------------------------------------


class TestSnapshotStore:
    def _store_with(self, heights, chunk_size=64) -> SnapshotStore:
        store = SnapshotStore(tempfile.mkdtemp(prefix="snapstore-"))
        for h in heights:
            payload = (b"%06d" % h) * 100
            chunks = chunk_payload(payload, chunk_size)
            m = Manifest(
                height=h, chain_id="t", chunk_size=chunk_size,
                total_bytes=len(payload),
                chunk_digests=[chunk_digest(c) for c in chunks],
                header_hash=b"\x11" * 20, app_hash=b"\x22" * 20,
            )
            store.save(m, chunks)
        return store

    def test_save_load_heights(self):
        store = self._store_with([10, 20, 30])
        assert store.heights() == [10, 20, 30]
        m = store.load_manifest(20)
        chunks = [store.load_chunk(20, i) for i in range(m.chunks)]
        assert b"".join(chunks) == (b"%06d" % 20) * 100
        assert store.load_manifest(15) is None
        assert store.load_chunk(20, m.chunks + 5) is None

    def test_prune_keeps_newest(self):
        store = self._store_with([10, 20, 30, 40])
        assert store.prune(2) == [10, 20]
        assert store.heights() == [30, 40]
        assert store.prune(0) == [30]  # floor of 1 kept

    def test_damaged_chunk_raises_damaged_manifest_none(self):
        store = self._store_with([10])
        d = os.path.join(store.base_dir, "0000000010")
        chunk0 = os.path.join(d, store.chunk_name(0))
        with open(chunk0, "r+b") as f:
            f.seek(len(CHUNK_MAGIC) + 8 + 3)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0x01]))
        with pytest.raises(SnapshotError):
            store.load_chunk(10, 0)
        with open(os.path.join(d, "manifest.json"), "w") as f:
            f.write("{not json")
        assert store.load_manifest(10) is None
        assert store.load_failures == 1

    def test_half_written_snapshot_not_listed(self):
        store = self._store_with([10])
        # a .tmp assembly dir (crash mid-save) and a dir without a
        # manifest must both be invisible
        os.makedirs(os.path.join(store.base_dir, "0000000099.tmp"))
        os.makedirs(os.path.join(store.base_dir, "0000000098"))
        assert store.heights() == [10]


# -- producer -----------------------------------------------------------------


class TestProducer:
    def test_interval_gating(self):
        chain = build_kvstore_chain(10)
        store = SnapshotStore(tempfile.mkdtemp(prefix="snapstore-"))
        producer = SnapshotProducer(
            store, chain.app, chain.block_store, interval=4, chunk_size=4096
        )
        assert producer.maybe_snapshot(chain.state) is None  # 10 % 4 != 0
        chain.build(2)  # height 12
        assert producer.maybe_snapshot(chain.state) == 12
        assert store.heights() == [12]
        assert producer.stats()["snapshots_taken"] == 1

    def test_retention(self):
        chain = build_kvstore_chain(2)
        store = SnapshotStore(tempfile.mkdtemp(prefix="snapstore-"))
        # full_every=1: all-full snapshots, so retention isn't clamped
        # up to protect a delta chain (that case: test_statesync_delta)
        producer = SnapshotProducer(
            store, chain.app, chain.block_store, interval=2,
            keep_recent=2, chunk_size=4096, full_every=1,
        )
        for _ in range(3):
            assert producer.maybe_snapshot(chain.state) is not None
            chain.build(2)
        assert store.heights() == [4, 6]  # 2 was pruned

    def test_deterministic_across_replicas(self):
        """Two replicas at the same height must serialize byte-identical
        snapshots — the manifest digests (and so the whole p2p protocol)
        depend on it."""
        manifests, chunk_sets = [], []
        for _ in range(2):
            chain = build_kvstore_chain(8)
            store = SnapshotStore(tempfile.mkdtemp(prefix="snapstore-"))
            h = SnapshotProducer(
                store, chain.app, chain.block_store, chunk_size=2048
            ).snapshot(chain.state)
            m, chunks = load_snapshot(store, h)
            manifests.append(m)
            chunk_sets.append(chunks)
        assert manifests[0].root == manifests[1].root
        assert manifests[0].to_json() == manifests[1].to_json()
        assert chunk_sets[0] == chunk_sets[1]

    def test_producer_failure_never_raises(self):
        """maybe_snapshot on a broken producer (app refuses) must count
        the failure and return None — it rides the consensus post-apply
        hook and a raise there would wedge block commit."""
        chain = build_kvstore_chain(4)

        class NoSnapApp:
            def snapshot(self):
                return None

        store = SnapshotStore(tempfile.mkdtemp(prefix="snapstore-"))
        producer = SnapshotProducer(
            store, NoSnapApp(), chain.block_store, interval=4
        )
        assert producer.maybe_snapshot(chain.state) is None
        assert producer.snapshot_failures == 1


# -- restore: the verification gates ------------------------------------------


class TestRestore:
    def test_happy_path_and_reload(self):
        chain, store, _producer, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        restorer, app, state_db, block_store = fresh_restorer(chain)
        state = restorer.restore(manifest, chunks)

        assert state.last_block_height == height
        assert state.app_hash == manifest.app_hash
        assert app.height == height
        # block store is seeded with the REAL block H
        assert block_store.height() == block_store.base() == height
        meta = block_store.load_block_meta(height)
        assert meta.header.hash() == manifest.header_hash
        src_meta = chain.block_store.load_block_meta(height)
        assert meta.to_json() == src_meta.to_json()
        seen = block_store.load_seen_commit(height)
        assert seen.to_json() == chain.block_store.load_seen_commit(height).to_json()
        # the persisted state reloads and serves validator history at H
        st2 = State.load_state(state_db, chain.genesis_doc)
        assert st2 is not None and st2.equals(state)
        assert st2.load_validators(height).hash() == chain.state.validators.hash()
        assert restorer.stats()["restored_height"] == height
        assert restorer.stats()["chunk_digest_failures"] == 0

    def test_corrupt_chunk_rejected(self):
        chain, store, _p, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        assert manifest.chunks >= 2, "need a multi-chunk snapshot"
        bad = bytearray(chunks[1])
        bad[0] ^= 0x01
        chunks[1] = bytes(bad)
        restorer, app, _sdb, block_store = fresh_restorer(chain)
        with pytest.raises(RestoreError, match=r"digest mismatch at \[1\]"):
            restorer.restore(manifest, chunks)
        # nothing was applied
        assert app.height == 0 and block_store.height() == 0
        assert restorer.stats()["chunk_digest_failures"] == 1

    def test_wrong_chunk_count_rejected(self):
        chain, store, _p, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        restorer, *_ = fresh_restorer(chain)
        with pytest.raises(RestoreError, match="chunk"):
            restorer.restore(manifest, chunks[:-1])

    def test_forged_manifest_rejected_at_header_bind(self):
        """A manifest whose root/digests are self-consistent but whose
        header or app hash is forged must die at the light-client bind,
        BEFORE any chunk is even considered."""
        chain, store, _p, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        for field, value in (("header_hash", b"\xee" * 20),
                             ("app_hash", b"\xee" * 20)):
            obj = manifest.to_json()
            obj[field] = value.hex().upper()
            forged = Manifest.from_json(obj)
            restorer, *_ = fresh_restorer(chain)
            with pytest.raises(RestoreError, match="header|app hash"):
                restorer.verify_manifest(forged)

    def test_unverifiable_height_rejected(self):
        """A manifest claiming a height past the served chain cannot be
        light-verified (header H+1 does not exist)."""
        chain, store, _p, height = snapshot_chain(tail=0)  # nothing past H
        manifest, chunks = load_snapshot(store, height)
        restorer, *_ = fresh_restorer(chain)
        with pytest.raises(RestoreError, match="light verification"):
            restorer.restore(manifest, chunks)

    def test_payload_state_tamper_rejected(self):
        """Re-chunk a payload whose embedded state was tampered: the
        manifest re-roots (attacker-controlled), so only the header
        cross-checks can catch it."""
        chain, store, _p, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        obj = json.loads(b"".join(chunks))
        obj["state"]["app_hash"] = ("ee" * 20).upper()
        restorer, *_ = fresh_restorer(chain)
        with pytest.raises(RestoreError, match="app hash|state"):
            restorer.restore(*_rechunk(manifest, obj))

    def test_forged_validators_info_rejected(self):
        """A validators_info record carrying a set the verified headers
        never vouched for must be refused — it would become 'historical
        truth' served to RPC clients."""
        from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
        from tendermint_tpu_torch.types.validator import Validator
        from tendermint_tpu_torch.types.validator_set import ValidatorSet

        chain, store, _p, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        obj = json.loads(b"".join(chunks))
        forged_set = ValidatorSet(
            [Validator.new(gen_priv_key_ed25519().pub_key(), 99)]
        )
        obj["validators_info"][str(height)] = {
            "last_height_changed": height,
            "validator_set": forged_set.to_json(),
        }
        restorer, *_ = fresh_restorer(chain)
        with pytest.raises(RestoreError, match="unverified set"):
            restorer.restore(*_rechunk(manifest, obj))

    def test_tampered_seen_commit_rejected(self):
        # format 2: the seen commit rides the MANIFEST sidecar (outside
        # the digested payload — deterministic roots); it must still be
        # signature-verified against the height-H validator set
        chain, store, _p, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        mobj = json.loads(json.dumps(manifest.to_json()))
        tag, sig_hex = mobj["seen_commit"]["precommits"][0]["signature"]
        sig = bytearray(bytes.fromhex(sig_hex))
        sig[0] ^= 0x01
        mobj["seen_commit"]["precommits"][0]["signature"] = [tag, sig.hex().upper()]
        tampered = Manifest.from_json(mobj)
        restorer, *_ = fresh_restorer(chain)
        with pytest.raises(RestoreError, match="commit"):
            restorer.restore(tampered, chunks)

    def test_format2_manifest_without_seen_commit_refused(self):
        chain, store, _p, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        mobj = manifest.to_json()
        mobj.pop("seen_commit")
        stripped = Manifest.from_json(mobj)
        restorer, *_ = fresh_restorer(chain)
        with pytest.raises(RestoreError, match="seen commit"):
            restorer.restore(stripped, chunks)

    def test_total_bytes_mismatch_rejected(self):
        chain, store, _p, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        obj = manifest.to_json()
        obj["total_bytes"] = manifest.total_bytes + 1
        lying = Manifest.from_json(obj)
        restorer, *_ = fresh_restorer(chain)
        with pytest.raises(RestoreError, match="bytes"):
            # trust path objects to the SIZE claim even when digests match
            restorer._parse_payload(lying, b"".join(chunks))

    def test_used_app_rejected(self):
        chain, store, _p, height = snapshot_chain()
        manifest, chunks = load_snapshot(store, height)
        used = KVStoreApp()
        used.deliver_tx(b"a=b")
        used.commit()
        restorer, *_ = fresh_restorer(chain, app=used)
        with pytest.raises(RestoreError, match="fresh app"):
            restorer.restore(manifest, chunks)

    def test_poisoned_app_state_rejected_before_mutation(self):
        """An app_state whose CLAIMED app_hash matches the verified
        header but whose state map was poisoned must refuse inside the
        app's restore (it recomputes the hash from the map) with nothing
        mutated — the claimed hash alone proves nothing."""
        chain, store, _p, height = snapshot_chain(n_blocks=8, tail=2, chunk_size=2048)
        manifest, chunks = load_snapshot(store, height)
        obj = json.loads(b"".join(chunks))
        app_obj = json.loads(bytes.fromhex(obj["app_state"]))
        app_obj["state"]["poison"] = "ee" * 8
        obj["app_state"] = json.dumps(app_obj, sort_keys=True).encode().hex()
        restorer, app, _sdb, block_store = fresh_restorer(chain)
        with pytest.raises(RestoreError, match="refused"):
            restorer.restore(*_rechunk(manifest, obj))
        assert app.height == 0 and app.state == {}
        assert block_store.height() == 0

    def test_wrong_height_app_state_rejected_before_mutation(self):
        """A self-consistent app_state for the WRONG height must refuse
        before the app mutates (the old path applied first and gated on
        Info afterwards, leaving the app poisoned for later attempts)."""
        chain, store, _p, height = snapshot_chain(n_blocks=8, tail=2, chunk_size=2048)
        manifest, chunks = load_snapshot(store, height)
        obj = json.loads(b"".join(chunks))
        app_obj = json.loads(bytes.fromhex(obj["app_state"]))
        app_obj["height"] = height + 1
        obj["app_state"] = json.dumps(app_obj, sort_keys=True).encode().hex()
        restorer, app, *_ = fresh_restorer(chain)
        with pytest.raises(RestoreError, match="height"):
            restorer.restore(*_rechunk(manifest, obj))
        assert app.height == 0 and app.state == {}
        # the refusal left the app FRESH: the honest snapshot restores
        restorer2, app2, *_ = fresh_restorer(chain, app=app)
        assert restorer2.restore(manifest, chunks).last_block_height == height
        assert app2.height == height

    def test_failed_high_candidate_does_not_poison_lower_snapshots(self):
        """A forged offer above the chain head fails its light walk —
        and must NOT advance the restorer's trust: the honest snapshot
        at a lower height must still verify and restore afterwards (the
        walk rides a clone, adopted only when a manifest binds)."""
        chain, store, _p, height = snapshot_chain(n_blocks=8, tail=2, chunk_size=2048)
        manifest, chunks = load_snapshot(store, height)
        restorer, *_ = fresh_restorer(chain)
        obj = manifest.to_json()
        obj["height"] = height + 100
        forged = Manifest.from_json(obj)
        with pytest.raises(RestoreError, match="light verification"):
            restorer.verify_manifest(forged)
        state = restorer.restore(manifest, chunks)
        assert state.last_block_height == height

    def test_non_dict_app_state_refuses_cleanly(self):
        """app_state whose JSON shape is wrong (non-dict state map /
        non-dict top level) must come back as a RestoreError, not an
        AttributeError crashing the restore driver."""
        chain, store, _p, height = snapshot_chain(n_blocks=8, tail=2, chunk_size=2048)
        manifest, chunks = load_snapshot(store, height)
        base = json.loads(b"".join(chunks))
        app_obj = json.loads(bytes.fromhex(base["app_state"]))
        for poison in ({**app_obj, "state": "oops"}, [1, 2, 3]):
            obj = json.loads(json.dumps(base))
            obj["app_state"] = json.dumps(poison, sort_keys=True).encode().hex()
            restorer, app, *_ = fresh_restorer(chain)
            with pytest.raises(RestoreError, match="refused"):
                restorer.restore(*_rechunk(manifest, obj))
            assert app.height == 0 and app.state == {}

    def test_non_int_state_fields_refuse_cleanly(self):
        """Non-int last_height_validators_changed / block time in the
        embedded state must refuse as RestoreError — max()/time math on
        them used to raise TypeError past the driver's error alphabet."""
        chain, store, _p, height = snapshot_chain(n_blocks=8, tail=2, chunk_size=2048)
        manifest, chunks = load_snapshot(store, height)
        base = json.loads(b"".join(chunks))
        for field, match in (
            ("last_height_validators_changed", "last_height_validators_changed"),
            ("last_block_time", "block time"),
        ):
            obj = json.loads(json.dumps(base))
            obj["state"][field] = "x"
            restorer, app, *_ = fresh_restorer(chain)
            with pytest.raises(RestoreError, match=match):
                restorer.restore(*_rechunk(manifest, obj))
            assert app.height == 0

    def test_interrupted_seed_resumes(self):
        """Crash window: a prior restore persisted the app but died
        before the block store / state seeded. A new attempt with the
        SAME app (already at exactly the verified height/app hash) must
        resume idempotently, not wedge on 'needs a fresh app'."""
        chain, store, _p, height = snapshot_chain(
            n_blocks=8, tail=2, chunk_size=2048
        )
        manifest, chunks = load_snapshot(store, height)
        r1, app, *_ = fresh_restorer(chain)
        r1.restore(manifest, chunks)  # the app half of the crash image
        r2, _app2, state_db, block_store = fresh_restorer(chain, app=app)
        state = r2.restore(manifest, chunks)
        assert state.last_block_height == height
        assert block_store.height() == height
        assert State.load_state(state_db, chain.genesis_doc) is not None
        # resumption is exact-match only: an app at any OTHER height
        # still refuses (test_used_app_rejected covers the mismatch)
        app.height += 1
        r3, *_ = fresh_restorer(chain, app=app)
        try:
            with pytest.raises(RestoreError, match="fresh app"):
                r3.restore(manifest, chunks)
        finally:
            app.height -= 1

    def test_malformed_validators_info_rejected(self):
        """Junk heights, junk pointers, and pointer records that resolve
        to nothing must all refuse before anything applies — a
        non-numeric key used to crash seed_restored AFTER the app and
        block store had already been seeded."""
        chain, store, _p, height = snapshot_chain(n_blocks=8, tail=2, chunk_size=2048)
        manifest, chunks = load_snapshot(store, height)
        base = json.loads(b"".join(chunks))
        cases = [
            ("abc", {"last_height_changed": 1}),
            (str(height + 7), {"last_height_changed": 1}),
            (str(height), {"last_height_changed": "abc"}),
            (str(height), "not-a-dict"),
            # pointer past its own key
            (str(height), {"last_height_changed": height + 1}),
            # pointer-only record pointing at another pointer-only record
            (str(height), {"last_height_changed": height}),
        ]
        for key, rec in cases:
            obj = json.loads(json.dumps(base))
            obj["validators_info"] = {key: rec}
            restorer, app, _sdb, block_store = fresh_restorer(chain)
            with pytest.raises(RestoreError, match="validators_info"):
                restorer.restore(*_rechunk(manifest, obj))
            assert app.height == 0 and block_store.height() == 0, (key, rec)
        # presence too: stripped-empty (or missing H/H+1) validators_info
        # passes every per-record check but must refuse — the restored
        # node's load_validators would raise forever
        for vi in ({}, {str(height): base["validators_info"][str(height)]}):
            obj = json.loads(json.dumps(base))
            obj["validators_info"] = vi
            restorer, app, *_ = fresh_restorer(chain)
            with pytest.raises(RestoreError, match="validators_info"):
                restorer.restore(*_rechunk(manifest, obj))
            assert app.height == 0


def _rechunk(manifest: Manifest, obj: dict):
    """Re-encode a (tampered) payload object into chunks + a manifest
    whose digest plane is CONSISTENT with the bytes — modeling an
    attacker who controls the snapshot but not the header chain."""
    payload = json.dumps(obj, sort_keys=True).encode()
    chunks = chunk_payload(payload, manifest.chunk_size)
    m = Manifest(
        height=manifest.height, chain_id=manifest.chain_id,
        chunk_size=manifest.chunk_size, total_bytes=len(payload),
        chunk_digests=[chunk_digest(c) for c in chunks],
        header_hash=manifest.header_hash, app_hash=manifest.app_hash,
        format_=manifest.format, kind=manifest.kind,
        base_height=manifest.base_height, seen_commit=manifest.seen_commit,
    )
    return m, chunks


# -- BlockStore base/prune + RPC below-base errors ----------------------------


class TestBlockStorePrune:
    def test_prune_to_moves_base_and_deletes(self):
        chain = build_kvstore_chain(10)
        store, db = chain.block_store, chain.block_store_db
        assert store.base() == 1
        assert store.prune_to(6) == 5
        assert store.base() == 6
        assert store.load_block_meta(5) is None
        assert store.load_block(3) is None
        assert store.load_block_meta(6) is not None
        # idempotent + bounded
        assert store.prune_to(6) == 0
        with pytest.raises(ValueError, match="past head"):
            store.prune_to(store.height() + 1)
        # base survives a reopen
        assert BlockStore(db).base() == 6

    def test_save_block_continues_after_seed(self):
        """After seed_snapshot at H, fast sync must be able to append
        H+1 — and a second seed on the now non-empty store must refuse."""
        chain = build_kvstore_chain(5)
        src = chain.block_store
        meta = src.load_block_meta(3)
        parts = [src.load_block_part(3, i)
                 for i in range(meta.block_id.parts_header.total)]
        seen = src.load_seen_commit(3)

        store = BlockStore(MemDB())
        store.seed_snapshot(meta, parts, seen)
        assert (store.base(), store.height()) == (3, 3)
        blk4 = src.load_block(4)
        ps = blk4.make_part_set(
            chain.state.params().block_gossip.block_part_size_bytes
        )
        store.save_block(blk4, ps, src.load_seen_commit(4))
        assert (store.base(), store.height()) == (3, 4)
        with pytest.raises(ValueError, match="non-empty"):
            store.seed_snapshot(meta, parts, seen)

    def test_rpc_below_base_is_clear_error(self):
        from tendermint_tpu_torch.rpc.core.handlers import (
            RPCError,
            block as rpc_block,
            blockchain_info,
            commit as rpc_commit,
        )

        chain = build_kvstore_chain(8)
        chain.block_store.prune_to(5)

        class _Ctx:
            block_store = chain.block_store

        with pytest.raises(RPCError, match="below the store's base"):
            rpc_block(_Ctx(), 3)
        with pytest.raises(RPCError, match="below the store's base"):
            rpc_commit(_Ctx(), 4)
        # in-range queries still serve
        assert rpc_block(_Ctx(), 6)["block"] is not None
        assert rpc_commit(_Ctx(), 6)["header"]["height"] == 6
        # blockchain_info clamps its default window to the base
        info = blockchain_info(_Ctx())
        got = {m["header"]["height"] for m in info["block_metas"]}
        assert min(got) == 5 and max(got) == 8


# -- p2p reactor: serve, restore, ban, hand off -------------------------------
#
# The real Switch rides the encrypted transport (p2p/secret_connection),
# whose `cryptography` dependency is absent on this image — the loopback
# fabric below exercises the REAL reactors (statesync + blockchain, their
# actual receive/serve/ban/handoff logic) over queue-per-node delivery
# threads, stubbing only the wire. The reactors use exactly the Switch
# surface the fabric provides: broadcast, peers.get/list/size,
# stop_peer_for_error, reactor(name), peer.try_send/id.


class _LoopbackPeer:
    def __init__(self, owner: "_LoopbackSwitch", remote: str):
        self._owner = owner
        self._remote = remote
        self.outbound = True

    def id(self) -> str:
        return self._remote

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        remote = self._owner.net.nodes.get(self._remote)
        if remote is None:
            return False
        remote.enqueue(ch_id, self._owner.name, bytes(msg))
        return True


class _PeerSet:
    def __init__(self):
        self._peers: dict = {}

    def get(self, pid):
        return self._peers.get(pid)

    def list(self):
        return list(self._peers.values())

    def size(self) -> int:
        return len(self._peers)


class _LoopbackSwitch:
    def __init__(self, net: "_LoopbackNet", name: str):
        self.net = net
        self.name = name
        self.peers = _PeerSet()
        self._reactors: dict = {}
        self._by_channel: dict = {}
        import queue

        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._deliver_loop, daemon=True, name=f"loopback-{name}"
        )

    def add_reactor(self, name: str, reactor) -> None:
        reactor.set_switch(self)
        self._reactors[name] = reactor
        for ch in reactor.get_channels():
            self._by_channel[ch.id] = reactor

    def reactor(self, name: str):
        return self._reactors.get(name)

    def start(self) -> None:
        self._thread.start()
        for r in self._reactors.values():
            r.start()

    def stop(self) -> None:
        self._q.put(None)
        for r in self._reactors.values():
            r.stop()

    def enqueue(self, ch_id: int, src: str, msg: bytes) -> None:
        self._q.put((ch_id, src, msg))

    def _deliver_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            ch_id, src, msg = item
            peer = self.peers.get(src)
            reactor = self._by_channel.get(ch_id)
            if peer is not None and reactor is not None:
                reactor.receive(ch_id, peer, msg)

    def broadcast(self, ch_id: int, msg: bytes) -> None:
        for peer in self.peers.list():
            peer.try_send(ch_id, msg)

    def stop_peer_for_error(self, peer, reason) -> None:
        self.net.disconnect(self.name, peer.id())

    def _attach(self, remote: str) -> None:
        peer = _LoopbackPeer(self, remote)
        self.peers._peers[remote] = peer
        for r in self._reactors.values():
            r.add_peer(peer)

    def _drop(self, remote: str, reason) -> None:
        peer = self.peers._peers.pop(remote, None)
        if peer is not None:
            for r in self._reactors.values():
                r.remove_peer(peer, reason)


class _LoopbackNet:
    def __init__(self):
        self.nodes: dict = {}

    def add_node(self, name: str) -> _LoopbackSwitch:
        sw = _LoopbackSwitch(self, name)
        self.nodes[name] = sw
        return sw

    def connect(self, a: str, b: str) -> None:
        self.nodes[a]._attach(b)
        self.nodes[b]._attach(a)

    def disconnect(self, a: str, b: str) -> None:
        self.nodes[a]._drop(b, "error")
        if b in self.nodes:
            self.nodes[b]._drop(a, "error")

    def stop(self) -> None:
        for sw in self.nodes.values():
            sw.stop()


def _make_corrupting_reactor_cls():
    from tendermint_tpu_torch.statesync.reactor import STATESYNC_CHANNEL, StateSyncReactor

    class CorruptingReactor(StateSyncReactor):
        """Serves the manifest honestly but every chunk corrupted —
        the digest-mismatch → ban → refetch path's antagonist."""

        def _serve_chunk(self, peer, height, index):
            chunk = self.store.load_chunk(height, index)
            if chunk is None:
                return super()._serve_chunk(peer, height, index)
            evil_bytes = bytes([chunk[0] ^ 0x01]) + chunk[1:]
            peer.try_send(
                STATESYNC_CHANNEL,
                json.dumps({
                    "type": "chunk_response", "height": height,
                    "index": index, "chunk": evil_bytes.hex().upper(),
                }, sort_keys=True).encode(),
            )

    return CorruptingReactor


def _make_forging_reactor_cls():
    from tendermint_tpu_torch.statesync.reactor import STATESYNC_CHANNEL, StateSyncReactor

    class ForgingReactor(StateSyncReactor):
        """Serves manifests whose digest plane is self-consistent but
        whose header_hash is forged — the manifest-binding antagonist."""

        def _serve_manifest(self, peer, height):
            m = self.store.load_manifest(height)
            if m is None:
                return super()._serve_manifest(peer, height)
            obj = m.to_json()
            obj["header_hash"] = ("ee" * 20).upper()
            peer.try_send(
                STATESYNC_CHANNEL,
                json.dumps(
                    {"type": "manifest_response", "manifest": obj},
                    sort_keys=True,
                ).encode(),
            )

    return ForgingReactor


def _add_server_node(net, name, chain, snap_store, reactor_cls=None):
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

    sw = net.add_node(name)
    sw.add_reactor("STATESYNC", (reactor_cls or StateSyncReactor)(snap_store))
    sw.add_reactor("BLOCKCHAIN", BlockchainReactor(
        chain.state.copy(), chain._proxy, chain.block_store,
        fast_sync=False, event_cache=None, status_update_interval=0.5,
    ))
    return sw


def _add_joiner_node(net, name, chain, app=None, **reactor_kw):
    """A fresh node: statesync enabled, blockchain reactor deferred for
    the restore handoff. Returns (switch, dict of its moving parts)."""
    import threading as _threading

    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

    app = app if app is not None else KVStoreApp()
    state_db, block_db = MemDB(), MemDB()
    block_store = BlockStore(block_db)
    state = State.get_state(state_db, chain.genesis_doc)
    proxy = AppConnConsensus(LocalClient(app, _threading.RLock()))
    bc_r = BlockchainReactor(
        state.copy(), proxy, block_store, fast_sync=True, event_cache=None,
        status_update_interval=0.5, defer_for_statesync=True,
    )
    restorer = Restorer(
        chain.genesis_doc, app, state_db, block_store,
        light_client=make_light_client(chain),
    )
    done: list = []

    def on_complete(restored_state):
        done.append(restored_state)
        bc_r.start_after_statesync(restored_state)

    reactor_kw.setdefault("chunk_window", 4)
    reactor_kw.setdefault("chunk_timeout_s", 5.0)
    reactor_kw.setdefault("discovery_s", 0.2)
    reactor_kw.setdefault("fallback_s", 30.0)
    ss_r = StateSyncReactor(
        SnapshotStore(tempfile.mkdtemp(prefix=f"{name}-snap-")),
        restorer=restorer, enabled=True, on_complete=on_complete, **reactor_kw,
    )
    sw = net.add_node(name)
    sw.add_reactor("STATESYNC", ss_r)
    sw.add_reactor("BLOCKCHAIN", bc_r)
    return sw, {
        "app": app, "block_store": block_store, "reactor": ss_r,
        "bc_reactor": bc_r, "done": done, "state_db": state_db,
    }


def _statesync_net(chain, snap_store, evil=False):
    """Loopback net: serving peer(s) with `chain`'s snapshot + block
    stores, and a joining node. Returns (net, joiner_dict)."""
    net = _LoopbackNet()
    if evil:
        _add_server_node(
            net, "evil", chain, snap_store,
            reactor_cls=_make_corrupting_reactor_cls(),
        )
    _add_server_node(net, "honest", chain, snap_store)
    _joiner_sw, joiner = _add_joiner_node(net, "joiner", chain)
    for sw in net.nodes.values():
        sw.start()
    for server in [n for n in net.nodes if n != "joiner"]:
        net.connect(server, "joiner")
    return net, joiner


class TestStateSyncReactor:
    def test_restore_over_p2p_then_fast_sync_tail(self):
        chain, snap_store, _p, height = snapshot_chain(
            n_blocks=12, tail=4, chunk_size=2048
        )
        target = chain.block_store.height()
        net, joiner = _statesync_net(chain, snap_store)
        try:
            assert wait_until(lambda: joiner["done"], timeout=30), (
                joiner["reactor"].stats()
            )
            assert joiner["done"][0] is not None, "restore fell back"
            assert joiner["done"][0].last_block_height == height
            # the fast-sync handoff pulls the tail; block `target` itself
            # needs a successor commit to verify, so fast sync (with no
            # consensus layer in this net) converges at target - 1
            synced_to = target - 1
            assert wait_until(
                lambda: joiner["block_store"].height() >= synced_to, timeout=30
            ), f"tail sync stalled at {joiner['block_store'].height()}"
            assert joiner["block_store"].base() == height
            # app hash after synced_to is committed in header(target)
            want_app_hash = chain.block_store.load_block_meta(
                target
            ).header.app_hash
            assert joiner["app"].app_hash == want_app_hash
            got = joiner["block_store"].load_block(synced_to)
            want = chain.block_store.load_block(synced_to)
            assert got is not None and got.hash() == want.hash()
            stats = joiner["reactor"].stats()
            assert stats["chunks_fetched"] >= 2
            assert stats["peers_banned"] == 0
            # scratch dir cleaned after a completed restore
            assert not os.path.isdir(
                joiner["reactor"]._scratch_dir(height)
            )
        finally:
            net.stop()

    def test_corrupt_chunk_bans_peer_and_refetches(self):
        """A peer serving digest-mismatching chunks is penalized
        (stop_peer_for_error) and every chunk re-fetches from the honest
        peer — the restore still completes."""
        chain, snap_store, _p, height = snapshot_chain(
            n_blocks=12, tail=2, chunk_size=1024
        )
        assert snap_store.load_manifest(height).chunks >= 4
        net, joiner = _statesync_net(chain, snap_store, evil=True)
        try:
            assert wait_until(lambda: joiner["done"], timeout=45), (
                joiner["reactor"].stats()
            )
            assert joiner["done"][0] is not None, "restore fell back"
            stats = joiner["reactor"].stats()
            assert stats["peers_banned"] >= 1, stats
            assert stats["chunk_failures"] >= 1, stats
            assert joiner["app"].height == height
            # the banned peer is disconnected from the joiner's switch
            assert wait_until(
                lambda: net.nodes["joiner"].peers.get("evil") is None,
                timeout=10,
            )
            # ...and the restored bytes all came digest-verified
            assert stats["chunks_fetched"] >= snap_store.load_manifest(
                height
            ).chunks
        finally:
            net.stop()

    def test_reactor_rejects_garbage_messages(self):
        """Every decode violation is a peer error — never an exception
        out of receive()."""
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

        banned = []

        class _Switch:
            peers = None

            def stop_peer_for_error(self, peer, err):
                banned.append((peer, err))

        class _Peer:
            def id(self):
                return "p1"

            def try_send(self, ch, msg):
                return True

        r = StateSyncReactor(SnapshotStore(tempfile.mkdtemp()))
        r.switch = _Switch()
        for msg in (
            b"\xff\xfe",  # not utf-8
            b"not json",
            b"[]",
            b'{"type": "warp"}',
            b'{"type": "chunk_response", "height": -1, "index": 0, "chunk": ""}',
            b'{"type": "manifest_response", "manifest": {"format": 1}}',
            b'{"type": "snapshots_response", "snapshots": 3}',
        ):
            r.receive(0x60, _Peer(), msg)
        assert len(banned) == 7

    def test_forged_manifest_bans_serving_peer(self):
        """A peer serving a manifest that contradicts the light-verified
        chain is banned (the forgery PROVES it lied); with no honest
        offerer left the joiner falls back to fast sync rather than
        wedging — the height is never poisoned by the forger."""
        chain, snap_store, _p, height = snapshot_chain(
            n_blocks=8, tail=2, chunk_size=2048
        )
        net = _LoopbackNet()
        _add_server_node(
            net, "forger", chain, snap_store,
            reactor_cls=_make_forging_reactor_cls(),
        )
        _joiner_sw, joiner = _add_joiner_node(
            net, "joiner", chain, fallback_s=1.2, chunk_timeout_s=2.0,
        )
        for sw in net.nodes.values():
            sw.start()
        net.connect("forger", "joiner")
        try:
            assert wait_until(lambda: joiner["done"], timeout=30), (
                joiner["reactor"].stats()
            )
            assert joiner["done"][0] is None, "forged manifest was accepted"
            assert joiner["reactor"].stats()["peers_banned"] >= 1
            assert net.nodes["joiner"].peers.get("forger") is None
            assert joiner["app"].height == 0
        finally:
            net.stop()

    def test_unsolicited_manifest_ignored(self):
        """A WELL-FORMED manifest_response from a peer we never asked
        must not enter the manifest inbox — a malicious peer could
        otherwise race a forged manifest in and poison the restore of a
        height an honest peer offered. It is not a peer error either
        (it may be a late reply to a prior request)."""
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

        _chain, store, _p, height = snapshot_chain()
        manifest = store.load_manifest(height)
        banned = []

        class _Switch:
            peers = None

            def stop_peer_for_error(self, peer, err):
                banned.append(peer)

        class _Peer:
            def __init__(self, pid):
                self._pid = pid

            def id(self):
                return self._pid

            def try_send(self, ch, msg):
                return True

        r = StateSyncReactor(SnapshotStore(tempfile.mkdtemp()))
        r.switch = _Switch()
        msg = json.dumps(
            {"type": "manifest_response", "manifest": manifest.to_json()}
        ).encode()
        # nothing awaited: ignored
        r.receive(0x60, _Peer("stranger"), msg)
        assert r._manifest_inbox == {}
        # awaiting another peer: still ignored
        r._manifest_expect = (height, "friend")
        r.receive(0x60, _Peer("stranger"), msg)
        assert r._manifest_inbox == {}
        # the peer actually asked: delivered
        r.receive(0x60, _Peer("friend"), msg)
        assert r._manifest_inbox[height].root == manifest.root
        assert banned == []

    def test_phantom_high_offer_does_not_starve_restore(self):
        """A peer offering a phantom max-height (and then never serving
        its manifest) must not starve the honest snapshot: after a
        bounded number of transient failures the phantom height is
        dropped and the real one restores — the picker always takes the
        highest offer, so an unbounded retry would burn the whole
        fallback window on the forgery."""
        from tendermint_tpu_torch.statesync.reactor import (
            STATESYNC_CHANNEL,
            StateSyncReactor,
        )

        chain, snap_store, _p, height = snapshot_chain(
            n_blocks=8, tail=2, chunk_size=2048
        )

        class PhantomReactor(StateSyncReactor):
            def _serve_snapshots(self, peer):
                super()._serve_snapshots(peer)
                peer.try_send(STATESYNC_CHANNEL, json.dumps({
                    "type": "snapshots_response",
                    "snapshots": [{"height": 999999}],
                }, sort_keys=True).encode())

            def _serve_manifest(self, peer, h):
                if h == 999999:
                    return  # silence: the joiner must time out
                super()._serve_manifest(peer, h)

        net = _LoopbackNet()
        _add_server_node(
            net, "phantom", chain, snap_store, reactor_cls=PhantomReactor
        )
        _joiner_sw, joiner = _add_joiner_node(
            net, "joiner", chain, chunk_timeout_s=0.4, fallback_s=20.0,
        )
        for sw in net.nodes.values():
            sw.start()
        net.connect("phantom", "joiner")
        try:
            assert wait_until(lambda: joiner["done"], timeout=30), (
                joiner["reactor"].stats()
            )
            assert joiner["done"][0] is not None, (
                "restore fell back — starved by the phantom offer"
            )
            assert joiner["done"][0].last_block_height == height
        finally:
            net.stop()

    def test_stop_during_discovery_is_not_fallback(self):
        """A graceful stop mid-discovery must NOT fire the fast-sync
        fallback handoff or delete the resumable scratch dirs — that
        path is for the fallback deadline, not shutdown."""
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

        class _Switch:
            def broadcast(self, ch, msg):
                pass

        done: list = []
        store = SnapshotStore(tempfile.mkdtemp())
        scratch = os.path.join(store.base_dir, "restore-0000000005")
        os.makedirs(scratch)
        restorer = Restorer(
            None, KVStoreApp(), MemDB(), BlockStore(MemDB()),
            trust_manifest=True,
        )
        r = StateSyncReactor(
            store, restorer=restorer, enabled=True,
            on_complete=lambda s: done.append(s),
            discovery_s=0.2, fallback_s=30.0,
        )
        r.switch = _Switch()
        r.start()
        time.sleep(0.3)
        r.stop()
        assert wait_until(lambda: not r._thread.is_alive(), timeout=5)
        assert done == [], "stop fired the fallback handoff"
        assert os.path.isdir(scratch), "stop deleted resumable scratch"

    def test_unsolicited_chunks_ignored(self):
        """chunk_response/no_chunk for (height, index) pairs the driver
        is not currently fetching must not be stored — the inbox key
        space is attacker-chosen and each payload is up to 4 MiB, so
        unsolicited entries are a memory-exhaustion vector (serve-only
        nodes never pop them at all)."""
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

        class _Switch:
            def stop_peer_for_error(self, peer, err):
                raise AssertionError("unsolicited chunk is not a peer error")

        class _Peer:
            def id(self):
                return "p1"

        r = StateSyncReactor(SnapshotStore(tempfile.mkdtemp()))
        r.switch = _Switch()
        chunk_msg = json.dumps(
            {"type": "chunk_response", "height": 3, "index": 0, "chunk": "AB"}
        ).encode()
        r.receive(0x60, _Peer(), chunk_msg)
        r.receive(0x60, _Peer(), json.dumps(
            {"type": "no_chunk", "height": 3, "index": 1}
        ).encode())
        assert r._chunk_inbox == {}
        # the awaited window IS stored
        r._chunk_expect = {(3, 0)}
        r.receive(0x60, _Peer(), chunk_msg)
        assert r._chunk_inbox == {(3, 0): ("p1", b"\xab")}

    def test_offers_gated_on_restore_and_bounded_per_peer(self):
        """Offers are only collected mid-restore (serve-only nodes would
        accumulate them forever), and one peer can hold at most
        MAX_OFFERED_SNAPSHOTS heights — its lowest dropped first."""
        from tendermint_tpu_torch.statesync.reactor import (
            MAX_OFFERED_SNAPSHOTS,
            StateSyncReactor,
        )

        class _Peer:
            def id(self):
                return "p1"

        r = StateSyncReactor(SnapshotStore(tempfile.mkdtemp()))
        r._note_offers(_Peer(), [{"height": 1}])
        assert r._offers == {}, "offer stored on a non-restoring node"
        r.restore_active = 1
        for h in range(1, 40):
            r._note_offers(_Peer(), [{"height": h}])
        assert len(r._offers) == MAX_OFFERED_SNAPSHOTS
        assert max(r._offers) == 39
        assert min(r._offers) == 40 - MAX_OFFERED_SNAPSHOTS

    def test_discovery_window_prefers_higher_late_offer(self):
        """_pick_snapshot collects offers for the FULL discovery window
        before choosing, so a higher snapshot offered moments after the
        first response wins (the old code returned on the first offer
        and clamped discovery_s to 1 s, making the knob dead)."""
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

        class _Switch:
            def broadcast(self, ch, msg):
                pass

        class _Peer:
            def __init__(self, pid):
                self._pid = pid

            def id(self):
                return self._pid

        r = StateSyncReactor(SnapshotStore(tempfile.mkdtemp()), discovery_s=0.5)
        r.switch = _Switch()
        r.start()
        r.restore_active = 1  # offers are only collected mid-restore
        try:
            results: list = []
            t = threading.Thread(
                target=lambda: results.append(
                    r._pick_snapshot(time.monotonic() + 10)
                )
            )
            t.start()
            r._note_offers(_Peer("a"), [{"height": 5}])
            time.sleep(0.2)
            r._note_offers(_Peer("b"), [{"height": 50}])
            t.join(timeout=5)
            assert not t.is_alive() and results == [50]
        finally:
            r.stop()


# -- node wiring: producer hook + RPC surface ---------------------------------


class TestNodeWiring:
    def test_node_produces_and_serves_snapshots(self, monkeypatch):
        """A real node with snapshot_interval set produces snapshots on
        the consensus post-apply hook and serves them over the
        `snapshots` RPC route; statesync_* gauges ride /metrics."""
        from tendermint_tpu_torch.config import reset_test_root
        from tendermint_tpu_torch.node import default_new_node
        from tendermint_tpu_torch.ops import gateway
        from tendermint_tpu_torch.rpc.client import HTTPClient

        monkeypatch.setattr(gateway, "_default_verifier", gateway.Verifier(device="cpu"))
        monkeypatch.setattr(gateway, "_default_hasher", gateway.Hasher(device="cpu", min_tpu_batch=1 << 30))
        tmp = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
        cfg = reset_test_root(tmp)
        cfg.base.proxy_app = "kvstore"
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.statesync.snapshot_interval = 2
        cfg.statesync.snapshot_keep_recent = 2
        # every snapshot full: a delta chain of full_every snapshots widens
        # retention to full_every + 1, and the bound read below is 2
        cfg.statesync.snapshot_full_every = 1
        n = default_new_node(cfg)
        assert n.snapshot_producer.keep_recent == 2
        n.start()
        try:
            # the store lists a height, and the producer has counted three
            # snapshots: the /metrics read below sees the count, and the
            # chain has grown past the two snapshots it keeps
            assert wait_until(
                lambda: n.snapshot_store.heights()
                and n.snapshot_producer.snapshots_taken >= 3,
                timeout=60,
            ), f"not three snapshots by height {n.block_store.height()}"
            client = HTTPClient(f"127.0.0.1:{n.rpc_port()}")
            offers = client.snapshots()["snapshots"]
            assert offers and offers[0]["height"] % 2 == 0
            assert offers[0]["chain_id"] == n.config.base.chain_id
            m = client.metrics()
            for gauge in ("statesync_restore_active", "statesync_snapshots",
                          "statesync_chunks_served", "statesync_peers_banned",
                          "statesync_snapshots_taken",
                          "statesync_last_snapshot_height"):
                assert gauge in m, gauge
            assert m["statesync_restore_active"] == 0
            assert m["statesync_snapshots_taken"] >= 1
            assert m["blockstore_base"] == 1
            # retention holds as the chain grows
            assert len(offers) <= 2
        finally:
            n.stop()


@pytest.mark.slow
class TestStateSyncSoak:
    def test_1k_block_signedkv_restore_matches_fast_sync(self, monkeypatch):
        """A fresh node restores a >=1k-block signedkv home from a
        snapshot + fast-syncs the tail; a second fresh node fast-syncs
        the whole chain from genesis. App hash, block-store contents,
        and every post-snapshot committed height must be byte-identical
        across the two — restore is a shortcut, never a fork."""
        import threading as _threading

        from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp
        from tendermint_tpu_torch.abci.client import LocalClient
        from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
        from tendermint_tpu_torch.ops import gateway
        from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus

        # the signed app's deliver verify takes the gateway's default
        # verifier, the card's in the port: here its CPU floor
        monkeypatch.setattr(gateway, "_default_verifier", gateway.Verifier(device="cpu"))
        chain = build_signedkv_chain(1000)
        snap_store = SnapshotStore(tempfile.mkdtemp(prefix="soak-snap-"))
        producer = SnapshotProducer(
            store=snap_store, app=chain.app, block_store=chain.block_store,
            chunk_size=16 * 1024,
        )
        snap_height = producer.snapshot(chain.state)
        assert snap_height == 1000
        chain.build(12)  # the tail both nodes must also commit
        target = chain.block_store.height()

        net = _LoopbackNet()
        _add_server_node(net, "source", chain, snap_store)
        # generous windows: this box's throughput swings >2x under host
        # load, and a transient timeout here burns one of the bounded
        # restore attempts — the soak proves byte-identity, not latency
        _sw_b, restored = _add_joiner_node(
            net, "restored", chain, app=SignedKVStoreApp(),
            chunk_window=8, chunk_timeout_s=20.0, fallback_s=180.0,
        )

        # the fast-sync-from-genesis comparison node
        app_c = SignedKVStoreApp()
        state_db_c, block_db_c = MemDB(), MemDB()
        store_c = BlockStore(block_db_c)
        state_c = State.get_state(state_db_c, chain.genesis_doc)
        proxy_c = AppConnConsensus(LocalClient(app_c, _threading.RLock()))
        sw_c = net.add_node("replayed")
        sw_c.add_reactor("BLOCKCHAIN", BlockchainReactor(
            state_c.copy(), proxy_c, store_c, fast_sync=True,
            event_cache=None, status_update_interval=0.5,
        ))
        replayed = {"app": app_c, "block_store": store_c,
                    "state_db": state_db_c}

        for sw in net.nodes.values():
            sw.start()
        net.connect("source", "restored")
        net.connect("source", "replayed")
        try:
            assert wait_until(lambda: restored["done"], timeout=200)
            assert restored["done"][0] is not None, "restore fell back"
            assert restored["done"][0].last_block_height == snap_height
            # block `target` needs a successor commit to verify, so fast
            # sync (with no consensus layer in this net) ends at target-1
            synced_to = target - 1
            assert wait_until(
                lambda: restored["block_store"].height() >= synced_to
                and replayed["block_store"].height() >= synced_to,
                timeout=240,
            ), (restored["block_store"].height(), replayed["block_store"].height())

            # -- byte-identity: app state --------------------------------
            assert restored["app"].app_hash == replayed["app"].app_hash
            # the app hash after synced_to is committed in header(target)
            assert restored["app"].app_hash == chain.block_store.load_block_meta(
                target
            ).header.app_hash
            assert restored["app"].snapshot() == replayed["app"].snapshot()

            # -- byte-identity: block-store contents over the shared
            # range (the restored store legitimately starts at base) ----
            assert restored["block_store"].base() == snap_height
            assert replayed["block_store"].base() == 1
            for h in range(snap_height, synced_to + 1):
                got = restored["block_store"].load_block_meta(h)
                want = replayed["block_store"].load_block_meta(h)
                assert got.to_json() == want.to_json(), f"meta diverges at {h}"
            # every subsequent committed height carries identical blocks
            for h in range(snap_height + 1, synced_to + 1):
                got_b = restored["block_store"].load_block(h)
                want_b = replayed["block_store"].load_block(h)
                assert got_b.hash() == want_b.hash(), f"block diverges at {h}"
                src_b = chain.block_store.load_block(h)
                assert got_b.hash() == src_b.hash()

            # -- the persisted states agree ------------------------------
            st_restored = State.load_state(
                restored["state_db"], chain.genesis_doc
            )
            st_replayed = State.load_state(
                replayed["state_db"], chain.genesis_doc
            )
            assert st_restored is not None and st_replayed is not None
            assert st_restored.equals(st_replayed)
            # validator history resolves at and after the snapshot height
            assert st_restored.load_validators(snap_height).hash() == \
                st_replayed.load_validators(snap_height).hash()
        finally:
            net.stop()


# -- across the packages ----------------------------------------------------------


def _pkg(root: str):
    import importlib
    import types

    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, KVStoreApp=m("abci.apps.kvstore").KVStoreApp, BlockStore=m("blockchain.store").BlockStore,
        MemDB=m("libs.db").MemDB, State=m("state.state").State, LightClient=m("rpc.light").LightClient,
        ValidatorSet=m("types.validator_set").ValidatorSet, GenesisDoc=m("types.genesis").GenesisDoc,
        Restorer=m("statesync").Restorer, SnapshotStore=m("statesync").SnapshotStore,
        SnapshotProducer=m("statesync").SnapshotProducer, Manifest=m("statesync").Manifest,
        devchain=m("statesync.devchain"), StateSyncReactor=m("statesync.reactor").StateSyncReactor,
        BlockchainReactor=m("blockchain.reactor").BlockchainReactor, LocalClient=m("abci.client").LocalClient,
        AppConnConsensus=m("proxy.app_conn").AppConnConsensus,
    )


PKGS = {"port": _pkg("tendermint_tpu_torch"), "jax": _pkg("tendermint_tpu")}
_x_chains: dict = {}


def x_chain(name: str):
    """Package `name`'s 12-block KVStore DevChain (the seeded validator:
    both packages build the same chain) with a snapshot at 12 in 1 KiB
    chunks and 4 blocks past it. Memoized."""
    if name not in _x_chains:
        p = PKGS[name]
        chain = p.devchain.build_kvstore_chain(12)
        store = p.SnapshotStore(tempfile.mkdtemp(prefix="xsnap-"))
        height = p.SnapshotProducer(store, chain.app, chain.block_store, chunk_size=1024).snapshot(chain.state)
        chain.build(4)
        _x_chains[name] = (chain, store, height)
    return _x_chains[name]


def test_producers_byte_equal_jax():
    """Equal chains give byte-equal manifests and chunks (and equal
    framed chunk files) in both packages."""
    (pc, ps, ph), (jc, js, jh) = x_chain("port"), x_chain("jax")
    assert ph == jh == 12
    assert pc.block_store.load_block(16).to_bytes() == jc.block_store.load_block(16).to_bytes()
    pm, jm = ps.load_manifest(ph), js.load_manifest(jh)
    assert json.dumps(pm.to_json(), sort_keys=True) == json.dumps(jm.to_json(), sort_keys=True)
    assert pm.chunks >= 4
    assert [ps.load_chunk(ph, i) for i in range(pm.chunks)] == [js.load_chunk(jh, i) for i in range(jm.chunks)]
    for i in range(pm.chunks):
        name = ps.chunk_name(i)
        with open(os.path.join(ps._dir(ph), name), "rb") as a, \
                open(os.path.join(js._dir(jh), name), "rb") as b:
            assert a.read() == b.read()


def _restored(p, chain, manifest_json, chunks) -> dict:
    """Package p's Restorer over fresh targets, its light client on
    `chain`'s RPC stub: restore the snapshot given as JSON and bytes and
    read back what it seeded."""
    app, state_db, block_db = p.KVStoreApp(), p.MemDB(), p.MemDB()
    block_store = p.BlockStore(block_db)
    doc = p.GenesisDoc.from_json(chain.genesis_doc.to_json())
    trusted = p.ValidatorSet.from_json(chain.state.load_validators(1).to_json())
    lc = p.LightClient(chain.rpc_stub(), doc.chain_id, trusted, trusted_height=0)
    r = p.Restorer(doc, app, state_db, block_store, light_client=lc)
    m = p.Manifest.from_json(manifest_json)
    state = r.restore(m, chunks)
    h = m.height
    loaded = p.State.load_state(state_db, doc)
    return {
        "app_hash": app.app_hash, "app_height": app.height, "state": state.bytes_(),
        "loaded_state": loaded.bytes_(), "base": block_store.base(), "height": block_store.height(),
        "meta": block_store.load_block_meta(h).to_json(), "block": block_store.load_block(h).to_bytes(),
        "seen": block_store.load_seen_commit(h).to_json(),
        "validators": [loaded.load_validators(x).to_json() for x in (h, h + 1)],
        "light_height": r.light_client.height, "stats": r.stats(),
    }


@pytest.mark.parametrize("restorer,producer", [("port", "jax"), ("jax", "port")])
def test_restore_the_other_packages_snapshot(restorer, producer):
    """Each package's Restorer restores the other's snapshot (light-
    verified against the other's chain) to the same app hash, state and
    seeded store records as its own package's snapshot gives it."""
    chain, store, height = x_chain(producer)
    own_chain, own_store, _ = x_chain(restorer)
    m = store.load_manifest(height)
    got = _restored(PKGS[restorer], chain, m.to_json(), [store.load_chunk(height, i) for i in range(m.chunks)])
    om = own_store.load_manifest(height)
    own = _restored(PKGS[restorer], own_chain, om.to_json(),
                    [own_store.load_chunk(height, i) for i in range(om.chunks)])
    got.pop("stats"), own.pop("stats")
    assert got == own
    assert got["base"] == got["height"] == height == got["app_height"]
    assert got["light_height"] == height + 1


def _x_server(net, name, p, chain, store):
    sw = net.add_node(name)
    sw.add_reactor("STATESYNC", p.StateSyncReactor(store))
    sw.add_reactor("BLOCKCHAIN", p.BlockchainReactor(
        chain.state.copy(), chain._proxy, chain.block_store,
        fast_sync=False, event_cache=None, status_update_interval=0.5,
    ))
    return sw


def _x_joiner(net, name, p, chain, hasher=None, batch_verifier=None):
    """A fresh node of package p restoring from peers that serve `chain`
    (of either package), its light client on the chain's RPC stub."""
    app, state_db, block_store = p.KVStoreApp(), p.MemDB(), p.BlockStore(p.MemDB())
    doc = p.GenesisDoc.from_json(chain.genesis_doc.to_json())
    state = p.State.get_state(state_db, doc)
    bc_r = p.BlockchainReactor(
        state.copy(), p.AppConnConsensus(p.LocalClient(app, threading.RLock())), block_store,
        fast_sync=True, event_cache=None, status_update_interval=0.5, defer_for_statesync=True,
    )
    trusted = p.ValidatorSet.from_json(chain.state.load_validators(1).to_json())
    lc = p.LightClient(chain.rpc_stub(), doc.chain_id, trusted, trusted_height=0, batch_verifier=batch_verifier)
    restorer = p.Restorer(doc, app, state_db, block_store, hasher=hasher, light_client=lc,
                          batch_verifier=batch_verifier)
    done: list = []

    def on_complete(restored_state):
        done.append(restored_state)
        bc_r.start_after_statesync(restored_state)

    ss_r = p.StateSyncReactor(
        p.SnapshotStore(tempfile.mkdtemp(prefix=f"{name}-snap-")), restorer=restorer, enabled=True,
        on_complete=on_complete, chunk_window=4, chunk_timeout_s=5.0, discovery_s=0.2, fallback_s=30.0,
    )
    sw = net.add_node(name)
    sw.add_reactor("STATESYNC", ss_r)
    sw.add_reactor("BLOCKCHAIN", bc_r)
    return {"app": app, "block_store": block_store, "reactor": ss_r, "bc_reactor": bc_r, "done": done}


def _x_sync(joiner_pkg: str, server_pkg: str) -> dict:
    """A joiner of one package state-syncs from a server of the other over
    the loopback net and fast-syncs the tail; what it ends with."""
    chain, store, height = x_chain(server_pkg)
    target = chain.block_store.height()
    net = _LoopbackNet()
    _x_server(net, "server", PKGS[server_pkg], chain, store)
    joiner = _x_joiner(net, "joiner", PKGS[joiner_pkg], chain)
    for sw in net.nodes.values():
        sw.start()
    net.connect("server", "joiner")
    try:
        assert wait_until(lambda: joiner["done"], timeout=30), joiner["reactor"].stats()
        assert joiner["done"][0] is not None, "restore fell back"
        assert wait_until(lambda: joiner["block_store"].height() >= target - 1, timeout=30)
        bs = joiner["block_store"]
        return {
            "restored_at": joiner["done"][0].last_block_height, "base": bs.base(), "height": bs.height(),
            "app_hash": joiner["app"].app_hash, "app_height": joiner["app"].height,
            "blocks": [bs.load_block(h).to_bytes() for h in range(height, target)],
            "seen": [bs.load_seen_commit(h).to_json() for h in range(height, target)],
            "banned": joiner["reactor"].stats()["peers_banned"],
        }
    finally:
        net.stop()


@pytest.mark.parametrize("joiner,server", [("port", "jax"), ("jax", "port")])
def test_state_sync_across_packages_over_the_loopback_net(joiner, server):
    """A port node state-syncs from a JAX node over the loopback net and
    fast-syncs the tail, and the reverse; each ends where a node of its
    own package syncing from its own package ends."""
    got = _x_sync(joiner, server)
    own = _x_sync(joiner, joiner)
    assert got == own
    assert got["restored_at"] == got["base"] == 12 and got["height"] == 15 and got["banned"] == 0


# -- a device error in a restore (the port's rule) ---------------------------------


def _device_error(*_a, **_k):
    from tendermint_tpu_torch.ops.gateway import DeviceError

    raise DeviceError("ed25519_verify launch failed: an injected fault")


class _FailingHasher:
    def part_leaf_hashes(self, chunks):
        _device_error()


def test_device_error_in_the_light_walk_leaves_verify_manifest_as_itself():
    """A DeviceError from the light walk's batched commit check is not a
    transport failure: verify_manifest raises it, where the JAX package
    turns every walk exception into a RestoreError the reactor retries.
    A bad commit still refuses as a RestoreError."""
    from tendermint_tpu_torch.ops.gateway import DeviceError

    chain, store, _producer, height = snapshot_chain(n_blocks=12, tail=4, chunk_size=2048)
    m = store.load_manifest(height)
    r, _app, _sdb, _bs = fresh_restorer(chain, light_client=make_light_client(chain, batch_verifier=_device_error))
    with pytest.raises(DeviceError, match="injected"):
        r.verify_manifest(m)
    assert r.light_client.height == 0  # trust did not move

    def refuse_all(items):
        return [False] * len(items)

    r2, _a, _s, _b = fresh_restorer(chain, light_client=make_light_client(chain, batch_verifier=refuse_all))
    with pytest.raises(RestoreError, match="light verification"):
        r2.verify_manifest(m)


def test_device_error_in_the_restore_passes_through():
    """A DeviceError from the whole-manifest digest batch (the Hasher) and
    from the seen commit's check leaves restore() untouched by the
    RestoreError net, with nothing applied."""
    from tendermint_tpu_torch.ops.gateway import DeviceError

    chain, store, _producer, height = snapshot_chain(n_blocks=12, tail=4, chunk_size=2048)
    m, chunks = load_snapshot(store, height)
    r, app, _sdb, bs = fresh_restorer(chain, hasher=_FailingHasher())
    with pytest.raises(DeviceError):
        r.restore(m, chunks)
    assert app.height == 0 and bs.height() == 0
    r2, app2, _s, bs2 = fresh_restorer(chain, batch_verifier=_device_error)
    with pytest.raises(DeviceError):
        r2.restore(m, chunks)
    assert app2.height == 0 and bs2.height() == 0


def test_device_error_in_the_producer_is_raised():
    """maybe_snapshot counts a failed snapshot and returns None, but a
    DeviceError from its chunk digests reaches the caller."""
    from tendermint_tpu_torch.ops.gateway import DeviceError

    chain = build_kvstore_chain(4)
    store = SnapshotStore(tempfile.mkdtemp(prefix="snapstore-"))
    producer = SnapshotProducer(store, chain.app, chain.block_store, hasher=_FailingHasher(), interval=4)
    with pytest.raises(DeviceError):
        producer.maybe_snapshot(chain.state)
    assert store.heights() == []


@pytest.mark.parametrize("where", ["window", "walk"])
def test_device_error_ends_the_restore_visibly_and_bans_no_peer(where):
    """A DeviceError in the restore driver — a chunk window's digest batch
    or the light walk's commit check — ends the restore: it is kept in
    the reactor's sync_error, restore_active drops to 0, the serving peer
    stays connected and unbanned, on_complete is never called (no fall
    back to fast sync from genesis: the blockchain reactor stays
    deferred). The JAX package's driver falls back instead."""
    from tendermint_tpu_torch.ops.gateway import DeviceError

    chain, store, height = x_chain("port")
    net = _LoopbackNet()
    _x_server(net, "server", PKGS["port"], chain, store)
    kw = {"hasher": _FailingHasher()} if where == "window" else {"batch_verifier": _device_error}
    joiner = _x_joiner(net, "joiner", PKGS["port"], chain, **kw)
    for sw in net.nodes.values():
        sw.start()
    net.connect("server", "joiner")
    try:
        r = joiner["reactor"]
        assert wait_until(lambda: r.sync_error is not None, timeout=30), r.stats()
        assert isinstance(r.sync_error, DeviceError)
        time.sleep(0.3)
        assert r.restore_active == 0 and not r._thread.is_alive()
        assert joiner["done"] == []
        assert joiner["bc_reactor"]._deferred
        assert r.stats()["peers_banned"] == 0 and r.stats()["offerers_banned"] == 0
        assert net.nodes["joiner"].peers.get("server") is not None
        assert joiner["app"].height == 0 and joiner["block_store"].height() == 0
    finally:
        net.stop()
