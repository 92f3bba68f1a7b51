"""The port's authenticated state tree (tendermint_tpu_torch/statetree/,
merkle/statetree_proof.py) against the JAX package's.

Every case of tests/test_statetree.py's TestCanonicalShape, TestProofs,
TestVersions, TestBatchedHashing, TestAppIntegration and TestBookkeeping
runs here once through each package on the same seeded entries: the
case's own assertions hold in both, and what it observes (roots, proof
bytes, diffs, stats()) is equal between them. Beside them, the port's
tree hashing its waves through `Hasher(device="cpu")` (K1's plain
version) reaches the roots of the JAX tree hashing on the host.
TestVerifiedQuery needs rpc/light and comes with a later slice.
"""

from __future__ import annotations

import importlib
import json
import random
import types

import pytest


def _pkg(root: str) -> types.SimpleNamespace:
    proof = importlib.import_module(f"{root}.merkle.statetree_proof")
    tree = importlib.import_module(f"{root}.statetree.tree")
    kv = importlib.import_module(f"{root}.abci.apps.kvstore")
    abci_types = importlib.import_module(f"{root}.abci.types")
    counter = importlib.import_module(f"{root}.abci.apps.counter")
    hashing = importlib.import_module(f"{root}.crypto.hashing")
    ns = types.SimpleNamespace(
        root=root,
        EMPTY_HASH=proof.EMPTY_HASH,
        TreeProof=proof.TreeProof,
        key_priority=proof.key_priority,
        node_hash=proof.node_hash,
        value_hash=proof.value_hash,
        VersionedTree=importlib.import_module(f"{root}.statetree").VersionedTree,
        TreeError=tree.TreeError,
        KVStoreApp=kv.KVStoreApp,
        PersistentKVStoreApp=kv.PersistentKVStoreApp,
        CounterApp=counter.CounterApp,
        Application=abci_types.Application,
        CODE_UNSUPPORTED=abci_types.CODE_UNSUPPORTED,
        ripemd160=hashing.ripemd160,
    )

    def oracle_root(entries: dict[bytes, bytes]) -> bytes:
        """The canonical treap root, straight from the definition."""

        def build(keys: list[bytes]) -> bytes:
            if not keys:
                return ns.EMPTY_HASH
            root_key = max(keys, key=ns.key_priority)
            left = build([k for k in keys if k < root_key])
            right = build([k for k in keys if k > root_key])
            return ns.node_hash(root_key, ns.value_hash(entries[root_key]), left, right)

        return build(list(entries))

    ns.oracle_root = oracle_root
    return ns


PORT = _pkg("tendermint_tpu_torch")
JAX = _pkg("tendermint_tpu")


def both(body):
    """Run `body(pkg)` through the port and the JAX package; what each
    observes must be equal."""
    assert body(PORT) == body(JAX)


def _entries(n: int, seed: int = 0) -> dict[bytes, bytes]:
    rng = random.Random(seed)
    out = {}
    while len(out) < n:
        k = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 12)))
        out[k] = b"v:" + k + bytes([rng.randrange(256)])
    return out


def _tree_from(p, entries: dict, version: int = 1, **kw):
    t = p.VersionedTree(**kw)
    for k, v in entries.items():
        t.set(k, v)
    t.commit(version)
    return t


def _proof_bytes(proof) -> bytes:
    return json.dumps(proof.to_json(), sort_keys=True).encode()


# -- canonical shape ----------------------------------------------------------


class TestCanonicalShape:
    def test_oracle_parity_1_to_300_keys(self):
        def body(p):
            rng = random.Random(7)
            sizes = list(range(1, 65)) + list(range(65, 301, 7))
            roots = []
            for n in sizes:
                entries = _entries(n, seed=n)
                keys = list(entries)
                rng.shuffle(keys)
                t = p.VersionedTree()
                for k in keys:
                    t.set(k, entries[k])
                root = t.commit(1)
                assert root == p.oracle_root(entries), f"n={n}"
                roots.append(root)
            return roots

        both(body)

    def test_insertion_order_independent(self):
        def body(p):
            entries = _entries(120, seed=3)
            roots = set()
            for seed in range(4):
                keys = list(entries)
                random.Random(seed).shuffle(keys)
                t = p.VersionedTree()
                for k in keys:
                    t.set(k, entries[k])
                roots.add(t.commit(1))
            assert len(roots) == 1
            return roots

        both(body)

    def test_bulk_load_matches_incremental(self):
        def body(p):
            entries = _entries(200, seed=9)
            inc = _tree_from(p, entries)
            bulk = p.VersionedTree.from_entries(entries, version=1)
            assert bulk.root_hash() == inc.root_hash() == p.oracle_root(entries)
            assert bulk.entries() == sorted(entries.items())
            assert bulk.size == len(entries)
            return bulk.root_hash(), bulk.stats(), inc.stats()

        both(body)

    def test_delete_reaches_the_smaller_sets_root(self):
        def body(p):
            entries = _entries(80, seed=5)
            t = _tree_from(p, entries)
            gone = sorted(entries)[::3]
            survivors = {k: v for k, v in entries.items() if k not in set(gone)}
            for k in gone:
                assert t.delete(k)
            root2 = t.commit(2)
            assert root2 == p.oracle_root(survivors)
            assert t.size == len(survivors)
            assert t.root_hash(1) == p.oracle_root(entries)
            assert t.get(gone[0], version=1) == entries[gone[0]]
            assert t.get(gone[0], version=2) is None
            return root2, t.stats()

        both(body)

    def test_update_changes_only_value_binding(self):
        def body(p):
            entries = _entries(50, seed=11)
            t = _tree_from(p, entries)
            k = sorted(entries)[25]
            t.set(k, b"updated")
            root = t.commit(2)
            assert root == p.oracle_root({**entries, k: b"updated"})
            return root, t.stats()

        both(body)

    def test_empty_tree_and_single_key(self):
        def body(p):
            t = p.VersionedTree()
            assert t.commit(1) == p.EMPTY_HASH
            t.set(b"a", b"1")
            root = t.commit(2)
            assert root == p.oracle_root({b"a": b"1"})
            assert t.delete(b"a")
            assert t.commit(3) == p.EMPTY_HASH
            return root

        both(body)

    def test_delete_absent_is_a_noop(self):
        def body(p):
            entries = _entries(20, seed=1)
            t = _tree_from(p, entries)
            assert not t.delete(b"\xff" * 20)
            assert t.commit(2) == t.root_hash(1)
            return t.root_hash(2)

        both(body)


# -- proofs -------------------------------------------------------------------


class TestProofs:
    def test_membership_and_absence_round_trip_1_to_300(self):
        def body(p):
            out = []
            for n in [1, 2, 3, 5, 9, 17, 33, 64, 127, 300]:
                entries = _entries(n, seed=100 + n)
                t = _tree_from(p, entries)
                root = t.root_hash()
                assert root == p.oracle_root(entries)
                keys = sorted(entries)
                probe = keys if n <= 33 else keys[:: max(1, n // 16)]
                for k in probe:
                    wire = json.dumps(t.prove(k).to_json())
                    pr = p.TreeProof.from_json(json.loads(wire))
                    assert pr.is_membership and pr.value == entries[k]
                    assert pr.verify(root), (n, k)
                    out.append(wire)
                for absent in (b"", b"\x00", b"\xff" * 16, keys[0] + b"\x00"):
                    if absent in entries:
                        continue
                    wire = json.dumps(t.prove(absent).to_json())
                    pr = p.TreeProof.from_json(json.loads(wire))
                    assert not pr.is_membership
                    assert pr.verify(root), (n, absent)
                    out.append(wire)
            return out

        both(body)

    def test_proof_binds_value(self):
        def body(p):
            entries = _entries(40, seed=2)
            t = _tree_from(p, entries)
            root = t.root_hash()
            k = sorted(entries)[7]
            pr = t.prove(k)
            assert pr.verify(root)
            assert not p.TreeProof(k, b"forged-value", pr.steps).verify(root)
            return _proof_bytes(pr)

        both(body)

    def test_proof_for_wrong_root_fails(self):
        def body(p):
            a = _tree_from(p, _entries(30, seed=4))
            b = _tree_from(p, _entries(30, seed=6))
            k = sorted(_entries(30, seed=4))[0]
            assert a.prove(k).verify(a.root_hash())
            assert not a.prove(k).verify(b.root_hash())
            return a.root_hash(), b.root_hash()

        both(body)

    def test_absence_proof_cannot_claim_present_key(self):
        def body(p):
            entries = _entries(40, seed=8)
            t = _tree_from(p, entries)
            root = t.root_hash()
            k = sorted(entries)[3]
            pr = t.prove(k)
            assert not p.TreeProof(k, None, pr.steps).verify(root)
            return _proof_bytes(pr)

        both(body)

    def test_membership_proof_cannot_claim_absent_key(self):
        def body(p):
            entries = _entries(40, seed=12)
            t = _tree_from(p, entries)
            root = t.root_hash()
            absent = b"\xfe" * 9
            assert absent not in entries
            pr = t.prove(absent)
            assert pr.value is None and pr.verify(root)
            assert not p.TreeProof(absent, b"anything", pr.steps).verify(root)
            return _proof_bytes(pr)

        both(body)

    def test_tampered_steps_fail(self):
        def body(p):
            entries = _entries(64, seed=13)
            t = _tree_from(p, entries)
            root = t.root_hash()
            k = sorted(entries)[31]
            base = t.prove(k)
            assert len(base.steps) >= 2
            assert not p.TreeProof(k, entries[k], base.steps[1:]).verify(root)
            swapped = [base.steps[1], base.steps[0]] + base.steps[2:]
            assert not p.TreeProof(k, entries[k], swapped).verify(root)
            obj = base.to_json()
            top = obj["steps"][-1]
            flipped_any = False
            for slot in (2, 3):
                if top[slot]:
                    bad = json.loads(json.dumps(obj))
                    flipped = bytearray(bytes.fromhex(bad["steps"][-1][slot]))
                    flipped[0] ^= 0x01
                    bad["steps"][-1][slot] = flipped.hex().upper()
                    assert not p.TreeProof.from_json(bad).verify(root)
                    flipped_any = True
                    break
            return _proof_bytes(base), flipped_any

        both(body)

    def test_decode_hardening(self):
        def body(p):
            good = _tree_from(p, _entries(5, seed=5)).prove(b"zz").to_json()
            errors = []
            for mutate in (
                lambda o: o.update(key=7),
                lambda o: o.update(steps="zz"),
                lambda o: o.update(steps=[["zz"]]),
                lambda o: o.update(steps=[["00", "11" * 20, "", ""]] * 600),
                lambda o: o.update(value=["no"]),
            ):
                obj = json.loads(json.dumps(good))
                mutate(obj)
                with pytest.raises(ValueError) as exc:
                    p.TreeProof.from_json(obj)
                errors.append(str(exc.value))
            return json.dumps(good, sort_keys=True), errors

        both(body)

    def test_empty_tree_absence(self):
        def body(p):
            t = p.VersionedTree()
            t.commit(1)
            pr = t.prove(b"anything")
            assert pr.verify(p.EMPTY_HASH)
            assert not pr.verify(b"\x11" * 20)
            assert not p.TreeProof(b"k", b"v", []).verify(p.EMPTY_HASH)
            return _proof_bytes(pr)

        both(body)


# -- versions, diff, journal --------------------------------------------------


class TestVersions:
    def test_diff_exact(self):
        def body(p):
            t = p.VersionedTree()
            t.set(b"a", b"1")
            t.set(b"b", b"2")
            t.set(b"c", b"3")
            t.commit(10)
            t.set(b"b", b"2x")
            t.set(b"d", b"4")
            t.delete(b"a")
            t.set(b"c", b"3")
            t.commit(20)
            ups, dels = t.diff(10, 20)
            assert ups == {b"b": b"2x", b"d": b"4"}
            assert dels == [b"a"]
            return ups, dels, t.root_hash(20)

        both(body)

    def test_diff_folds_multiple_commits(self):
        def body(p):
            t = p.VersionedTree()
            t.set(b"a", b"1")
            t.commit(1)
            t.set(b"x", b"1")
            t.commit(2)
            t.delete(b"x")
            t.set(b"y", b"2")
            t.commit(3)
            ups, dels = t.diff(1, 3)
            assert ups == {b"y": b"2"}
            assert dels == []
            return ups, dels

        both(body)

    def test_diff_applied_to_base_reproduces_target(self):
        def body(p):
            entries = _entries(90, seed=21)
            t = _tree_from(p, entries, version=1)
            rng = random.Random(22)
            cur = dict(entries)
            for v in (2, 3, 4):
                for k in rng.sample(sorted(cur), 10):
                    if rng.random() < 0.3:
                        t.delete(k)
                        cur.pop(k)
                    else:
                        t.set(k, b"v%d" % v + k)
                        cur[k] = b"v%d" % v + k
                nk = b"new-%d" % v
                t.set(nk, b"n")
                cur[nk] = b"n"
                t.commit(v)
            ups, dels = t.diff(1, 4)
            replay = dict(entries)
            for k in dels:
                replay.pop(k)
            replay.update(ups)
            assert replay == cur
            assert p.VersionedTree.from_entries(replay, 1).root_hash() == t.root_hash(4)
            return ups, dels, t.root_hash(4), t.stats()

        both(body)

    def test_diff_pruned_raises(self):
        def body(p):
            t = p.VersionedTree(keep_recent=2)
            for v in (1, 2, 3, 4):
                t.set(b"k%d" % v, b"v")
                t.commit(v)
            assert t.versions() == [3, 4]
            with pytest.raises(p.TreeError) as exc:
                t.diff(1, 4)
            ups, _dels = t.diff(3, 4)
            assert ups == {b"k4": b"v"}
            return str(exc.value), ups

        both(body)

    def test_commit_version_must_increase(self):
        def body(p):
            t = p.VersionedTree()
            t.commit(5)
            errors = []
            for v in (5, 4):
                with pytest.raises(p.TreeError) as exc:
                    t.commit(v)
                errors.append(str(exc.value))
            return errors

        both(body)

    def test_rollback_to(self):
        def body(p):
            entries = _entries(30, seed=30)
            t = _tree_from(p, entries, version=1)
            root1 = t.root_hash(1)
            t.set(b"zz", b"staged")
            t.rollback_to()
            assert t.get(b"zz") is None
            t.set(b"zz", b"v2")
            t.commit(2)
            t.rollback_to(1)
            assert t.versions() == [1]
            assert t.root_hash() == root1 and t.get(b"zz") is None
            assert t.size == len(entries)
            t.set(b"zz", b"v3")
            root3 = t.commit(3)
            assert root3 == p.oracle_root({**entries, b"zz": b"v3"})
            return root1, root3, t.stats()

        both(body)

    def test_retention_prunes_oldest(self):
        def body(p):
            t = p.VersionedTree(keep_recent=3)
            for v in range(1, 8):
                t.set(b"k%d" % v, b"v")
                t.commit(v)
            assert t.versions() == [5, 6, 7]
            with pytest.raises(p.TreeError):
                t.root_hash(2)
            return t.versions(), t.root_hash(7)

        both(body)


# -- batched hashing ----------------------------------------------------------


class _CountingHasher:
    """Duck-types the one Hasher method the tree uses, counting its calls
    and items; `batch` hashes them (host digests, or a port Hasher's
    part_leaf_hashes: one K1 batch on the card, its plain version here)."""

    def __init__(self, batch):
        self.batch = batch
        self.batches = 0
        self.items = 0

    def part_leaf_hashes(self, chunks):
        self.batches += 1
        self.items += len(chunks)
        return self.batch(chunks)


def _host_batch(p):
    return lambda chunks: [p.ripemd160(c) for c in chunks]


class TestBatchedHashing:
    def test_gateway_batches_match_cpu(self):
        def body(p):
            entries = _entries(400, seed=40)
            h = _CountingHasher(_host_batch(p))
            t = p.VersionedTree.from_entries(entries, version=1, hasher=h)
            assert t.root_hash() == p.oracle_root(entries)
            assert h.batches >= 1 and h.items >= 400
            assert t.stats()["gateway_nodes"] == h.items
            return t.root_hash(), h.batches, h.items, t.stats()

        both(body)

    def test_incremental_commit_batches_waves(self):
        def body(p):
            entries = _entries(600, seed=41)
            h = _CountingHasher(_host_batch(p))
            t = p.VersionedTree.from_entries(entries, version=1, hasher=h)
            h.batches = h.items = 0
            for i in range(40):
                t.set(b"upd-%03d" % i, b"x")
            t.commit(2)
            assert t.stats()["last_commit_nodes"] > 40
            assert h.batches <= 40, "wave batching degenerated to per-node calls"
            assert t.root_hash() == p.oracle_root(
                {**entries, **{b"upd-%03d" % i: b"x" for i in range(40)}}
            )
            return t.root_hash(), h.batches, h.items, t.stats()

        both(body)

    def test_k1_plain_waves_match_the_jax_host_tree(self):
        """The port's tree hashing its waves through Hasher(device="cpu")
        (K1's plain version) and the JAX tree hashing on the host reach
        equal roots at 600 keys, with the wave batching bound above."""
        from tendermint_tpu_torch.ops.gateway import Hasher

        entries = _entries(600, seed=41)
        hasher = Hasher(device="cpu")
        counting = _CountingHasher(hasher.part_leaf_hashes)
        port = PORT.VersionedTree.from_entries(entries, version=1, hasher=counting)
        ref = JAX.VersionedTree.from_entries(entries, version=1, hasher=None)
        assert port.root_hash() == ref.root_hash() == PORT.oracle_root(entries)
        assert hasher.stats()["tpu_leaves"] == port.stats()["gateway_nodes"] >= 600
        assert hasher.stats()["cpu_leaves"] == 0
        counting.batches = counting.items = 0
        for i in range(40):
            port.set(b"upd-%03d" % i, b"x")
            ref.set(b"upd-%03d" % i, b"x")
        assert port.commit(2) == ref.commit(2)
        assert port.stats()["last_commit_nodes"] > 40
        assert counting.batches <= 40, "wave batching degenerated to per-node calls"
        ps, js = port.stats(), ref.stats()
        assert js["gateway_nodes"] == 0
        assert {k: v for k, v in ps.items() if k != "gateway_nodes"} == {
            k: v for k, v in js.items() if k != "gateway_nodes"
        }


# -- app integration ----------------------------------------------------------


class TestAppIntegration:
    def test_kvstore_app_hash_is_tree_root(self):
        def body(p):
            app = p.KVStoreApp()
            app.deliver_tx(b"a=1")
            app.deliver_tx(b"b=2")
            res = app.commit()
            assert res.data == app.app_hash == p.oracle_root({b"a": b"1", b"b": b"2"})
            app.deliver_tx(b"a=9")
            app.commit()
            assert app.app_hash == p.oracle_root({b"a": b"9", b"b": b"2"})
            assert app.tree.root_hash(1) == p.oracle_root({b"a": b"1", b"b": b"2"})
            return res.data, app.app_hash

        both(body)

    def test_kvstore_query_proofs(self):
        def body(p):
            app = p.KVStoreApp()
            app.deliver_tx(b"a=1")
            app.commit()
            res = app.query(b"a", prove=True)
            assert res.code == 0 and res.value == b"1" and res.height == 1
            pr = p.TreeProof.from_json(json.loads(res.proof))
            assert pr.verify(app.app_hash) and pr.value == b"1"
            absent = app.query(b"nope", prove=True)
            assert absent.code == 0 and absent.value == b""
            pa = p.TreeProof.from_json(json.loads(absent.proof))
            assert pa.value is None and pa.verify(app.app_hash)
            fresh = p.KVStoreApp().query(b"a", prove=True)
            assert fresh.code != 0
            return res.to_json(), absent.to_json(), fresh.to_json()

        both(body)

    def test_counter_prove_clear_unsupported_error(self):
        def body(p):
            out = []
            for app in (p.CounterApp(), p.Application()):
                res = app.query(b"hash", prove=True)
                assert res.code == p.CODE_UNSUPPORTED
                assert "proofs unsupported" in res.log
                assert res.proof == b""
                assert app.query(b"hash").code == 0
                out.append(res.to_json())
            return out

        both(body)

    def test_persistent_app_reload_rebuilds_tree(self, tmp_path):
        def body(p):
            home = str(tmp_path / p.root)
            app = p.PersistentKVStoreApp(home)
            app.deliver_tx(b"x=1")
            app.commit()
            app.deliver_tx(b"y=2")
            app.commit()
            reloaded = p.PersistentKVStoreApp(home)
            assert reloaded.app_hash == app.app_hash
            assert reloaded.height == 2
            res = reloaded.query(b"x", prove=True)
            assert p.TreeProof.from_json(json.loads(res.proof)).verify(reloaded.app_hash)
            with open(app.db_path, "rb") as f:
                disk = f.read()
            return reloaded.app_hash, res.proof, disk

        both(body)

    def test_restore_delta_contract(self):
        def body(p):
            src = p.KVStoreApp()
            for h in range(1, 4):
                src.deliver_tx(b"k%d=v%d" % (h, h))
                if h == 2:
                    src.deliver_tx(b"k1=updated")
                src.commit()
            replica = p.KVStoreApp()
            snap2 = json.dumps({
                "height": 2,
                "app_hash": src.tree.root_hash(2).hex(),
                "state": {"k1": b"updated".hex(), "k2": b"v2".hex()},
            }, sort_keys=True).encode()
            replica.restore(snap2, height=2, app_hash=src.tree.root_hash(2))
            ups, dels = src.tree.diff(2, 3)
            replica.restore_delta(ups, dels, 3, src.app_hash)
            assert replica.app_hash == src.app_hash and replica.height == 3
            assert replica.state == src.state
            return ups, dels, replica.app_hash, replica.snapshot()

        both(body)

    def test_restore_delta_refuses_wrong_hash_with_nothing_applied(self):
        def body(p):
            app = p.KVStoreApp()
            root = p.oracle_root({b"a": b"1"})
            snap = json.dumps({
                "height": 1, "app_hash": root.hex(), "state": {"a": b"1".hex()},
            }, sort_keys=True).encode()
            app.restore(snap, height=1, app_hash=root)
            before = (app.height, app.app_hash, dict(app.state))
            with pytest.raises(ValueError, match="verified app hash"):
                app.restore_delta({b"b": b"2"}, [], 2, b"\xee" * 20)
            assert (app.height, app.app_hash, app.state) == before
            assert app.tree.versions() == [1]
            with pytest.raises(ValueError, match="stale delta"):
                app.restore_delta({b"b": b"2"}, [], 1, root)
            with pytest.raises(ValueError, match="restored base"):
                p.KVStoreApp().restore_delta({b"b": b"2"}, [], 2, b"\x11" * 20)
            return before

        both(body)


# -- sizes & stats ------------------------------------------------------------


class TestBookkeeping:
    def test_size_and_entries(self):
        def body(p):
            entries = _entries(70, seed=50)
            t = _tree_from(p, entries)
            assert t.size == 70
            assert t.entries() == sorted(entries.items())
            assert t.get(sorted(entries)[0]) == entries[sorted(entries)[0]]
            return t.entries(), t.root_hash()

        both(body)

    def test_stats_shape(self):
        def body(p):
            t = _tree_from(p, _entries(10, seed=51))
            s = t.stats()
            for key in ("size", "commits", "nodes_created", "hashed_nodes",
                        "hash_waves", "gateway_nodes", "proofs",
                        "versions_retained", "latest_version"):
                assert key in s
            assert s["size"] == 10 and s["commits"] == 1
            return s

        both(body)
