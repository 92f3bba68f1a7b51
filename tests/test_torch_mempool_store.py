"""The port's mempool, block store and config (mempool/mempool.py,
blockchain/store.py, config/) against the JAX package's, on the same
inputs.

The cases of tests/test_mempool_store.py (TestMempool,
TestSigPreVerification, TestBlockStore, TestConfig) run through each
package, and what they observe is equal: pool contents, CheckTx codes,
what the app saw, store records, config values. The port's gate
verifies on `Verifier(min_tpu_batch=4, device="cpu")`, B1's plain
version; the JAX package's on its CPU verifier. Beside them: a chain's
files carried across the packages in both directions (sqlite state,
block store and tx index; genesis.json, priv_validator.json and
config.toml), and the mempool WAL's bytes.
"""

from __future__ import annotations

import importlib
import os
import threading
import time
import types

import pytest


def _pkg(root: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    config = mod("config")
    block = mod("types.block")
    signedkv = mod("abci.apps.signedkv")
    return types.SimpleNamespace(
        root=root,
        CounterApp=mod("abci.apps.counter").CounterApp,
        KVStoreApp=mod("abci.apps.kvstore").KVStoreApp,
        SignedKVStoreApp=signedkv.SignedKVStoreApp,
        parse_sig_tx=signedkv.parse_sig_tx,
        make_sig_tx=signedkv.make_sig_tx,
        CODE_UNAUTHORIZED=mod("abci.types").CODE_UNAUTHORIZED,
        LocalClient=mod("abci.client").LocalClient,
        AppConnMempool=mod("proxy.app_conn").AppConnMempool,
        AppConns=mod("proxy").AppConns,
        LocalClientCreator=mod("proxy").LocalClientCreator,
        BlockStore=mod("blockchain.store").BlockStore,
        default_config=config.default_config,
        make_test_config=config.test_config,
        reset_test_root=config.reset_test_root,
        ensure_root=config.ensure_root,
        load_config=config.load_config,
        config_to_toml=mod("config.toml").config_to_toml,
        db=mod("libs.db"),
        mempool=mod("mempool.mempool"),
        Block=block.Block,
        Commit=block.Commit,
        empty_commit=block.empty_commit,
        BlockID=mod("types.block_id").BlockID,
        GenesisDoc=mod("types.genesis").GenesisDoc,
        GenesisValidator=mod("types.genesis").GenesisValidator,
        PrivValidatorFS=mod("types.priv_validator").PrivValidatorFS,
        Validator=mod("types.validator").Validator,
        ValidatorSet=mod("types.validator_set").ValidatorSet,
        VoteSet=mod("types.vote_set").VoteSet,
        Vote=mod("types.vote").Vote,
        VOTE_TYPE_PRECOMMIT=mod("types.vote").VOTE_TYPE_PRECOMMIT,
        gen_priv_key_ed25519=mod("crypto.keys").gen_priv_key_ed25519,
        State=mod("state").State,
        apply_block=mod("state").apply_block,
        KVTxIndexer=mod("state.txindex").KVTxIndexer,
        MockMempool=mod("types.services").MockMempool,
        tx_hash=mod("types.tx").tx_hash,
    )


PORT = _pkg("tendermint_tpu_torch")
JAX = _pkg("tendermint_tpu")
BOTH_WAYS = pytest.mark.parametrize(
    "src,dst", [(PORT, JAX), (JAX, PORT)], ids=["port->jax", "jax->port"]
)


def both(body, tmp_path=None):
    """Run `body(pkg, dir)` through the port and the JAX package, each in
    a directory of its own; what each observes must be equal. Returns the
    port's observation."""
    def run(p):
        if tmp_path is None:
            return body(p, None)
        d = tmp_path / p.root
        d.mkdir()
        return body(p, d)

    got = run(PORT)
    assert got == run(JAX)
    return got


def _gate_verifier(p):
    """The gate's verifier: B1's plain version on the CPU (batches of 4 or
    more) in the port, the CPU verifier in the JAX package."""
    if p is PORT:
        from tendermint_tpu_torch.ops.gateway import Verifier

        return Verifier(min_tpu_batch=4, device="cpu")
    from tendermint_tpu.ops.gateway import Verifier

    return Verifier(min_tpu_batch=4, use_tpu=False)


def _mk_mempool(p, app=None):
    cfg = p.make_test_config().mempool
    return p.mempool.Mempool(cfg, p.AppConnMempool(p.LocalClient(app or p.CounterApp(serial=False))))


def _tx(i: int) -> bytes:
    return i.to_bytes(8, "big")


def _pool(mp) -> list[tuple]:
    return [(m.value.counter, m.value.height, m.value.tx, m.value.lane) for m in mp.txs]


class TestMempool:
    def test_check_tx_adds_good_txs(self):
        def body(p, _d):
            mp = _mk_mempool(p)
            for i in range(10):
                mp.check_tx(_tx(i))
            return mp.size(), mp.reap(-1), mp.reap(3), _pool(mp)

        size, all_txs, three, _ = both(body)
        assert size == 10 and all_txs == [_tx(i) for i in range(10)]
        assert three == [_tx(i) for i in range(3)]

    def test_cache_rejects_duplicates(self):
        def body(p, _d):
            mp = _mk_mempool(p)
            mp.check_tx(b"hello")
            with pytest.raises(p.mempool.TxInCacheError) as e:
                mp.check_tx(b"hello")
            return mp.size(), str(e.value), mp.cache_dups

        assert both(body) == (1, b"hello".hex(), 1)

    def test_bad_tx_rejected_and_cache_evicted(self):
        def body(p, _d):
            mp = _mk_mempool(p, p.CounterApp(serial=True))
            mp.check_tx(_tx(5))  # ok: 5 >= check_count 0; check_count -> 1
            mp.check_tx(_tx(0))  # rejected: 0 < check_count 1
            out = [mp.size(), mp.reap(-1)]
            # the rejection freed the cache slot: resubmission is allowed
            # (not TxInCacheError) and fails CheckTx again
            mp.check_tx(_tx(0))
            return out + [mp.size()]

        assert both(body) == [1, [_tx(5)], 1]

    def test_update_removes_committed_and_rechecks(self):
        def body(p, _d):
            mp = _mk_mempool(p, p.KVStoreApp())
            for i in range(5):
                mp.check_tx(_tx(i))
            mp.lock()
            mp.update(1, [_tx(0), _tx(2)])
            mp.unlock()
            return mp.reap(-1), _pool(mp), mp.lane_counts

        assert both(body)[0] == [_tx(1), _tx(3), _tx(4)]

    def test_txs_available_fires_once_per_height(self):
        def body(p, _d):
            mp = _mk_mempool(p)
            fired = []
            mp.enable_txs_available(lambda: fired.append(1))
            mp.check_tx(_tx(0))
            mp.check_tx(_tx(1))
            first = len(fired)
            mp.lock()
            mp.update(1, [_tx(0)])
            mp.unlock()
            # still non-empty after the recheck: notified again for the next height
            return first, len(fired)

        assert both(body) == (1, 2)

    def test_serial_counter_recheck_evicts_stale(self):
        """After commit advances the counter, lower-nonce txs fail recheck."""

        def body(p, _d):
            app = p.CounterApp(serial=True)
            mp = p.mempool.Mempool(p.make_test_config().mempool, p.AppConnMempool(p.LocalClient(app)))
            for i in range(3):
                mp.check_tx(_tx(i))
            size = mp.size()
            app.deliver_tx(_tx(0))
            app.deliver_tx(_tx(1))
            app.commit()
            mp.lock()
            mp.update(1, [_tx(0), _tx(1)])
            mp.unlock()
            return size, mp.reap(-1)

        assert both(body) == (3, [_tx(2)])

    def test_wal_appends(self, tmp_path):
        def body(p, d):
            cfg = p.make_test_config().mempool
            cfg.root_dir = str(d)
            cfg.wal_path = "data/mempool.wal"
            mp = p.mempool.Mempool(cfg, p.AppConnMempool(p.LocalClient(p.CounterApp(serial=False))))
            mp.init_wal()
            mp.check_tx(b"abc")
            mp.close_wal()
            with open(cfg.wal_dir(), "rb") as f:
                return f.read()

        assert both(body, tmp_path) == b"abc".hex().encode() + b"\n"


class TestSigPreVerification:
    """The mempool's batch signature gate: a CheckTx burst's signatures
    verify in one gateway batch before app dispatch; bad-sig txs never
    reach the app."""

    def _mk(self, p, max_wait_s=0.01):
        app = p.SignedKVStoreApp(verify_in_app=False)
        verifier = _gate_verifier(p)
        batcher = p.mempool.SigBatcher(verifier, p.parse_sig_tx, max_wait_s=max_wait_s)
        mp = p.mempool.Mempool(p.make_test_config().mempool, p.AppConnMempool(p.LocalClient(app)),
                               sig_batcher=batcher)
        return mp, app, verifier, batcher

    @staticmethod
    def _signed(p, i: int, forge: bool = False) -> bytes:
        seed = bytes([i % 7 + 1]) * 32
        tx = p.make_sig_tx(seed, b"k%d=v%d" % (i, i))
        if forge:
            tx = tx[:40] + bytes([tx[40] ^ 1]) + tx[41:]
        return tx

    @staticmethod
    def _drain(mp, expect_size, timeout=120.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            mp.flush_app_conn()
            if mp.size() == expect_size:
                return
            time.sleep(0.01)
        assert mp.size() == expect_size, mp.size()

    def test_bad_sigs_never_reach_the_app(self):
        def body(p, _d):
            mp, app, verifier, batcher = self._mk(p)
            w = verifier.stats()
            results = {}
            for i in range(12):
                tx = self._signed(p, i, forge=(i % 3 == 0))
                mp.check_tx(tx, cb=lambda res, i=i: results.__setitem__(i, res.code))
            self._drain(mp, 8)  # 4 of 12 forged
            batcher.stop()
            st = verifier.stats()
            d_sigs = st["tpu_sigs"] + st["cpu_sigs"] - w["tpu_sigs"] - w["cpu_sigs"]
            d_batches = st["tpu_batches"] - w["tpu_batches"]
            # the signatures rode the gateway in batches, not one at a time
            assert d_sigs >= 12 and d_batches <= 4
            return (app.check_tx_calls, sorted(i for i, c in results.items() if c != 0),
                    batcher.bad_sigs, batcher.delivered, _pool(mp))

        calls, refused, bad, delivered, _ = both(body)
        assert calls == 8  # forged txs cost no app round trip
        assert refused == [0, 3, 6, 9] and bad == 4 and delivered == 12

    def test_bad_sig_tx_can_be_resubmitted(self):
        def body(p, _d):
            mp, _app, _v, batcher = self._mk(p)
            bad = self._signed(p, 1, forge=True)
            logs = []
            rejected = threading.Event()
            mp.check_tx(bad, cb=lambda res: (logs.append((res.code, res.log)), rejected.set()))
            assert rejected.wait(120), "the batch gate never rejected the forged tx"
            # the cache slot was released on rejection
            rejected2 = threading.Event()
            mp.check_tx(bad, cb=lambda res: (logs.append((res.code, res.log)), rejected2.set()))
            assert rejected2.wait(120)
            batcher.stop()
            return mp.size(), logs

        size, logs = both(body)
        assert size == 0 and len(logs) == 2 and logs[0] == logs[1]

    def test_unsigned_txs_bypass_the_gate(self):
        def body(p, _d):
            mp, app, _v, batcher = self._mk(p)
            results = []
            mp.check_tx(b"short", cb=lambda res: results.append(res.code))
            self._drain(mp, 0)
            batcher.stop()
            return app.check_tx_calls, results, batcher.delivered

        # the app judged it (malformed), the gate never saw it
        assert both(body) == (1, [PORT.CODE_UNAUTHORIZED], 0)

    def test_saturated_gate_refuses_retriably(self):
        """A flood beyond the gate's bounded backlog gets retriable
        refusals (the cache slot freed), never an unbounded queue."""

        def body(p, _d):
            release = threading.Event()

            class SlowVerifier:
                def verify_batch(self, items):
                    release.wait(30)
                    return [True] * len(items)

                def verify_batch_async(self, items):
                    return lambda: self.verify_batch(items)

            batcher = p.mempool.SigBatcher(SlowVerifier(), p.parse_sig_tx,
                                           max_batch=1, max_wait_s=0.001, max_backlog=2)
            app = p.SignedKVStoreApp(verify_in_app=False)
            mp = p.mempool.Mempool(p.make_test_config().mempool, p.AppConnMempool(p.LocalClient(app)),
                                   sig_batcher=batcher)
            results: dict = {}
            sent = []
            for i in range(8):
                tx = self._signed(p, i + 40)
                sent.append(tx)
                mp.check_tx(tx, cb=lambda res, i=i: results.__setitem__(i, res))
            assert batcher.dropped > 0  # the flood overflowed the bound
            saturated = [i for i, r in results.items()
                         if r.code == p.CODE_UNAUTHORIZED and "saturated" in r.log]
            assert saturated, results
            release.set()
            # a refused tx is retriable once the gate drains
            self._drain(mp, 8 - len(saturated))
            mp.check_tx(sent[saturated[0]])
            self._drain(mp, 8 - len(saturated) + 1)
            batcher.stop()
            return {r.log for r in results.values() if r.code}

        assert both(body) == {"signature gate saturated; retry"}

    def test_deliver_tx_always_verifies(self):
        """The gate is not the security boundary: a forged tx arriving in
        a block dies in DeliverTx."""

        def body(p, _d):
            app = p.SignedKVStoreApp(verify_in_app=False)
            good = app.deliver_tx(self._signed(p, 2)).code
            bad = app.deliver_tx(self._signed(p, 3, forge=True)).code
            return good, bad != 0, app.query(b"k2").value

        assert both(body) == (0, True, b"v2")


def _make_block_with_commit(p, height, chain_id="test-store"):
    block, parts = p.Block.make_block(
        height=height, chain_id=chain_id, txs=[b"tx-%d" % i for i in range(3)],
        commit=p.empty_commit(), prev_block_id=p.BlockID(), val_hash=b"", app_hash=b"",
        part_size=64 * 1024, time_ns=1_700_000_000 * 10**9 + height,
    )
    return block, parts, p.Commit(p.BlockID(block.hash(), parts.header()), [])


class TestBlockStore:
    def test_save_load_roundtrip(self):
        def body(p, _d):
            db = p.db.MemDB()
            store = p.BlockStore(db)
            h0 = store.height()
            block, parts, seen = _make_block_with_commit(p, 1)
            store.save_block(block, parts, seen)
            loaded = store.load_block(1)
            meta = store.load_block_meta(1)
            return (h0, store.height(), store.base(), loaded.to_bytes(), loaded.hash() == block.hash(),
                    meta.to_json(), store.load_block_part(1, 0).bytes_ == parts.get_part(0).bytes_,
                    store.load_seen_commit(1).to_json(), store.load_block_commit(0).to_json(),
                    sorted(db._data.items()))

        got = both(body)
        assert got[:3] == (0, 1, 1) and got[4] and got[6]

    def test_noncontiguous_save_rejected(self):
        def body(p, _d):
            store = p.BlockStore(p.db.MemDB())
            block, parts, seen = _make_block_with_commit(p, 5)
            with pytest.raises(ValueError) as e:
                store.save_block(block, parts, seen)
            return str(e.value)

        assert "contiguous" in both(body)

    def test_missing_heights_return_none(self):
        def body(p, _d):
            store = p.BlockStore(p.db.MemDB())
            return [store.load_block(1), store.load_block_meta(1), store.load_seen_commit(1),
                    store.load_block_commit(1)]

        assert both(body) == [None] * 4


class TestConfig:
    def test_timeout_schedule(self):
        def body(p, _d):
            c = p.default_config().consensus
            return [c.propose(0), c.propose(2), c.prevote(1), round(c.commit(10.0, 9.5), 12),
                    c.commit(100.0, 9.5)]

        assert both(body) == [3.0, 4.0, 1.5, 0.5, 0.0]

    def test_reset_test_root_and_load(self, tmp_path):
        def body(p, d):
            root = str(d / "node1")
            cfg = p.reset_test_root(root)
            files = [os.path.exists(os.path.join(root, "config.toml")),
                     os.path.exists(cfg.base.genesis_file()),
                     os.path.exists(cfg.base.priv_validator_file())]
            loaded = p.load_config(root)
            doc = p.GenesisDoc.from_file(cfg.base.genesis_file())
            pv = p.PrivValidatorFS.load(cfg.base.priv_validator_file())
            with open(os.path.join(root, "config.toml"), "rb") as f:
                toml = f.read()
            return (files, loaded.base.chain_id, loaded.consensus.skip_timeout_commit,
                    loaded.consensus.timeout_propose, doc.validators[0].pub_key == pv.get_pub_key(),
                    toml, p.config_to_toml(loaded))

        got = both(body, tmp_path)
        assert got[:5] == ([True] * 3, "tendermint_test", True, 0.1, True)


# -- a chain's files carried across the packages ------------------------------


def _val_set(p, n: int, power: int = 10):
    privs = [p.PrivValidatorFS(p.gen_priv_key_ed25519(f"val-{i}".encode()), None) for i in range(n)]
    vs = p.ValidatorSet([p.Validator.new(pv.get_pub_key(), power) for pv in privs])
    privs.sort(key=lambda pv: pv.get_address())
    return vs, privs


def _next_block(p, state, txs, privs):
    height = state.last_block_height + 1
    if height == 1:
        commit = p.empty_commit()
    else:
        voteset = p.VoteSet(state.chain_id, height - 1, 0, p.VOTE_TYPE_PRECOMMIT, state.last_validators)
        for pv in privs:
            idx, _ = state.last_validators.get_by_address(pv.get_address())
            vote = p.Vote(validator_address=pv.get_address(), validator_index=idx, height=height - 1,
                          round_=0, type_=p.VOTE_TYPE_PRECOMMIT, block_id=state.last_block_id)
            voteset.add_vote(pv.sign_vote(state.chain_id, vote))
        commit = voteset.make_commit()
    return p.Block.make_block(height, state.chain_id, txs, commit, state.last_block_id,
                              state.validators.hash(), state.app_hash, 4096, time_ns=height * 10**9)


def _write_chain(p, d, heights: int = 3):
    """A 4-validator KVStore chain of `heights` blocks, written to sqlite
    files under `d` as a node writes them (state, blockstore, tx_index)."""
    vs, privs = _val_set(p, 4)
    doc = p.GenesisDoc(genesis_time_ns=0, chain_id="carry-chain",
                       validators=[p.GenesisValidator(v.pub_key, v.voting_power) for v in vs.validators])
    dbs = {name: p.db.db_provider(name, "sqlite", str(d)) for name in ("state", "blockstore", "tx_index")}
    state = p.State.get_state(dbs["state"], doc)
    state.tx_indexer = p.KVTxIndexer(dbs["tx_index"])
    store = p.BlockStore(dbs["blockstore"])
    conns = p.AppConns(p.LocalClientCreator(p.KVStoreApp()))
    conns.start()
    txs = []
    for h in range(1, heights + 1):
        block_txs = [b"key%d-%d=val%d" % (h, i, i) for i in range(5)]
        txs += block_txs
        block, parts = _next_block(p, state, block_txs, privs)
        p.apply_block(state, None, conns.consensus(), block, parts.header(), p.MockMempool())
        seen = p.Commit(p.BlockID(block.hash(), parts.header()), [])
        store.save_block(block, parts, seen)
    conns.stop()
    for db in dbs.values():
        db.close()
    return doc, txs


def _read_chain(p, d, doc, txs):
    """What a restarted node reads back from the files under `d`."""
    dbs = {name: p.db.db_provider(name, "sqlite", str(d)) for name in ("state", "blockstore", "tx_index")}
    try:
        state = p.State.load_state(dbs["state"], doc)
        store = p.BlockStore(dbs["blockstore"])
        index = p.KVTxIndexer(dbs["tx_index"])
        out = {
            "state": state.bytes_(),
            "abci": state.load_abci_responses().bytes_(),
            "validators": [state.load_validators(h).to_json() for h in range(1, state.last_block_height + 2)],
            "height": store.height(),
            "base": store.base(),
            "blocks": [store.load_block(h).to_bytes() for h in range(1, store.height() + 1)],
            "metas": [store.load_block_meta(h).to_json() for h in range(1, store.height() + 1)],
            "commits": [store.load_block_commit(h).to_json() for h in range(0, store.height())],
            "seen": [store.load_seen_commit(h).to_json() for h in range(1, store.height() + 1)],
            "index": [index.get(p.tx_hash(tx)).to_json() for tx in txs],
        }
        out["raw"] = {name: list(db.iterate_prefix(b"")) for name, db in dbs.items()}
        return out
    finally:
        for db in dbs.values():
            db.close()


@BOTH_WAYS
def test_sqlite_chain_files_read_in_the_other_package(src, dst, tmp_path):
    doc, txs = _write_chain(src, tmp_path)
    want = _read_chain(src, tmp_path, doc, txs)
    got = _read_chain(dst, tmp_path, dst.GenesisDoc.from_json(doc.to_json()), txs)
    assert got == want
    assert got["height"] == 3 and len(got["index"]) == 15


def test_sqlite_chain_files_equal_between_packages(tmp_path):
    """The same chain written by each package: every key and value of the
    three stores equal."""

    def body(p, d):
        doc, txs = _write_chain(p, d)
        return _read_chain(p, d, doc, txs)

    got = both(body, tmp_path)
    assert got["height"] == 3 and {k: len(v) > 0 for k, v in got["raw"].items()} == dict.fromkeys(
        ("state", "blockstore", "tx_index"), True)


@BOTH_WAYS
def test_node_files_resave_byte_for_byte(src, dst, tmp_path):
    """genesis.json, priv_validator.json and config.toml written by one
    package load in the other and save again to the same bytes."""
    a, b = tmp_path / "a", tmp_path / "b"
    cfg = src.default_config()
    cfg.base.chain_id = "carry"
    cfg.mempool.lane_bulk_max_txs = 123
    src.ensure_root(str(a), cfg)
    pv = src.PrivValidatorFS(src.gen_priv_key_ed25519(b"carry-pv"), str(a / "priv_validator.json"))
    vote = src.Vote(validator_address=pv.get_address(), validator_index=0, height=7, round_=1,
                    type_=src.VOTE_TYPE_PRECOMMIT, block_id=src.BlockID())
    pv.sign_vote("carry", vote)  # last-sign state in the file
    doc = src.GenesisDoc(genesis_time_ns=123456789, chain_id="carry",
                         validators=[src.GenesisValidator(pv.get_pub_key(), 10, "v0")],
                         app_hash=b"\x01\x02", upgrade_height=3, upgrade_format="aggregate")
    doc.save_as(str(a / "genesis.json"))

    loaded = dst.load_config(str(a))
    dst.ensure_root(str(b), loaded)
    dst.GenesisDoc.from_file(str(a / "genesis.json")).save_as(str(b / "genesis.json"))
    pv2 = dst.PrivValidatorFS.load(str(a / "priv_validator.json"))
    pv2.file_path = str(b / "priv_validator.json")
    pv2.save()
    for name in ("config.toml", "genesis.json", "priv_validator.json"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    doc2 = dst.GenesisDoc.from_file(str(b / "genesis.json"))
    assert (doc2.schedule_string(), doc2.commit_format_at(2), doc2.commit_format_at(3)) == (
        "full>aggregate@3", "full", "aggregate")
    assert loaded.mempool.lane_bulk_max_txs == 123 and loaded.base.chain_id == "carry"
    assert pv2.last_height == 7 and pv2.last_signature.raw == pv.last_signature.raw


def test_mempool_wal_bytes_equal(tmp_path):
    """The same check_tx sequence, gated and not, writes the same WAL."""

    def body(p, d):
        cfg = p.make_test_config().mempool
        cfg.root_dir = str(d)
        app = p.SignedKVStoreApp(verify_in_app=False)
        mp = p.mempool.Mempool(cfg, p.AppConnMempool(p.LocalClient(app)))
        mp.init_wal()
        seen = []
        txs = [p.make_sig_tx(bytes([i % 5 + 1]) * 32, b"w%d=%d" % (i, i)) if i % 4 else b"raw-%d" % i
               for i in range(20)]
        for tx in txs:
            mp.check_tx(tx, cb=lambda res: seen.append(res.code))
        with pytest.raises(p.mempool.TxInCacheError):
            mp.check_tx(txs[1])  # admitted: its cache entry stays
        mp.close_wal()
        with open(cfg.wal_dir(), "rb") as f:
            return f.read(), seen, mp.reap(-1)

    wal, codes, _ = both(body, tmp_path)
    assert wal.count(b"\n") == 20 and len(codes) == 20
