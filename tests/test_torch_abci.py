"""The port's ABCI application plane (abci, abci/apps, proxy, libs/service,
libs/grpcutil, state/fail, types/protobuf) against the JAX package's, on
the same inputs.

The cases of tests/test_abci_state.py (the apps, the socket client and
AppConns), tests/test_libs.py (BaseService, ReqRes),
tests/test_pipeline.py (the sharded apply) and tests/test_grpc.py (the
ABCI gRPC pair) run through each package, and what they observe is
equal. Beside them: a signed-kvstore block verified in one batch on
each side, app state carried across the packages by snapshot and by the
persistent app's file, the socket wire between a client of one package
and a server of the other, and the slice as a whole at a small size.
tests/test_abci_state.py's TestStatePersistence and TestExecution (State,
apply_block, the tx index) run through both packages too, and so does the
execution path as a whole: a 4-validator chain across its upgrade height,
gated, built, applied and stored. The gRPC node tests come with a later
slice.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import socketserver
import subprocess
import sys
import threading
import time
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root: str) -> types.SimpleNamespace:
    apps = importlib.import_module(f"{root}.abci.apps")
    signedkv = importlib.import_module(f"{root}.abci.apps.signedkv")
    client = importlib.import_module(f"{root}.abci.client")
    abci_types = importlib.import_module(f"{root}.abci.types")
    proxy = importlib.import_module(f"{root}.proxy")
    return types.SimpleNamespace(
        root=root,
        KVStoreApp=apps.KVStoreApp,
        PersistentKVStoreApp=apps.PersistentKVStoreApp,
        CounterApp=apps.CounterApp,
        SignedKVStoreApp=signedkv.SignedKVStoreApp,
        make_sig_tx=signedkv.make_sig_tx,
        ABCIServer=client.ABCIServer,
        SocketClient=client.SocketClient,
        ReqRes=client.ReqRes,
        ABCIHeader=abci_types.Header,
        AppConns=proxy.AppConns,
        LocalClientCreator=proxy.LocalClientCreator,
        RemoteClientCreator=proxy.RemoteClientCreator,
        default_client_creator=proxy.default_client_creator,
        BaseService=importlib.import_module(f"{root}.libs.service").BaseService,
        fail=importlib.import_module(f"{root}.state.fail"),
        keys=importlib.import_module(f"{root}.crypto.keys"),
        protobuf=importlib.import_module(f"{root}.types.protobuf"),
        StateTreeProof=importlib.import_module(f"{root}.merkle.statetree_proof").TreeProof,
        ABCIValidator=abci_types.ABCIValidator,
        AppConnMempool=importlib.import_module(f"{root}.proxy.app_conn").AppConnMempool,
        LocalClient=client.LocalClient,
        parse_sig_tx=signedkv.parse_sig_tx,
        state=importlib.import_module(f"{root}.state"),
        execution=importlib.import_module(f"{root}.state.execution"),
        KVTxIndexer=importlib.import_module(f"{root}.state.txindex").KVTxIndexer,
        db=importlib.import_module(f"{root}.libs.db"),
        levents=importlib.import_module(f"{root}.libs.events"),
        events=importlib.import_module(f"{root}.types.events"),
        types=importlib.import_module(f"{root}.types"),
        block=importlib.import_module(f"{root}.types.block"),
        agg=importlib.import_module(f"{root}.types.agg_commit"),
        tx=importlib.import_module(f"{root}.types.tx"),
        MockMempool=importlib.import_module(f"{root}.types.services").MockMempool,
        mempool=importlib.import_module(f"{root}.mempool.mempool"),
        BlockStore=importlib.import_module(f"{root}.blockchain.store").BlockStore,
        make_test_config=importlib.import_module(f"{root}.config").test_config,
    )


PORT = _pkg("tendermint_tpu_torch")
JAX = _pkg("tendermint_tpu")


def both(body):
    """Run `body(pkg)` through the port and the JAX package; what each
    observes must be equal. Returns the port's observation."""
    got = body(PORT)
    assert got == body(JAX)
    return got


def _port_cpu_verifier():
    from tendermint_tpu_torch.ops.gateway import Verifier

    return Verifier(device="cpu")


def _jax_cpu_verifier():
    from tendermint_tpu.ops import gateway as jgateway

    return jgateway.Verifier(use_tpu=False)


def _signed_block(p, height: int, n: int, forged: set[int], keys: list[bytes]):
    """n signed kv txs (updates, new keys, a deletion) with the lanes in
    `forged` carrying a flipped signature byte."""
    out = []
    for i in range(n):
        seed = bytes([height, i % 8]) + b"\x5a" * 30
        if i % 16 == 5 and keys:
            payload = b"rm:" + keys[(height * 7 + i) % len(keys)]
        elif i % 2 == 0 and keys:
            payload = keys[(height * 13 + i) % len(keys)] + b"=h%d-%d" % (height, i)
        else:
            payload = b"new-%d-%d=v%d" % (height, i, i)
        tx = p.make_sig_tx(seed, payload)
        if i in forged:
            tx = tx[:40] + bytes([tx[40] ^ 0x01]) + tx[41:]
        out.append(tx)
    return out


def _responses(reses) -> list:
    return [r.to_json() for r in reses]


# -- the example apps ---------------------------------------------------------


class TestKVStoreApp:
    def test_deliver_query_commit(self):
        def body(p):
            app = p.KVStoreApp()
            assert app.deliver_tx(b"name=satoshi").is_ok
            res = app.commit()
            assert res.is_ok and len(res.data) == 20
            q = app.query(b"name")
            assert q.value == b"satoshi"
            assert app.query(b"missing").value == b""
            app2 = p.KVStoreApp()
            app2.deliver_tx(b"name=satoshi")
            assert app2.commit().data == res.data
            return res.to_json(), q.to_json()

        both(body)

    def test_info_tracks_height(self):
        def body(p):
            app = p.KVStoreApp()
            assert app.info().last_block_height == 0
            app.deliver_tx(b"a=1")
            app.commit()
            info = app.info()
            assert info.last_block_height == 1
            assert info.last_block_app_hash == app.app_hash
            return info.to_json()

        both(body)


class TestPersistentKVStore:
    def test_persistence(self, tmp_path):
        def body(p):
            home = str(tmp_path / p.root)
            app = p.PersistentKVStoreApp(home)
            app.deliver_tx(b"k=v")
            h = app.commit()
            app2 = p.PersistentKVStoreApp(home)
            assert app2.height == 1
            assert app2.app_hash == h.data
            assert app2.query(b"k").value == b"v"
            return h.to_json()

        both(body)

    def test_val_tx_diffs(self, tmp_path):
        def body(p):
            app = p.PersistentKVStoreApp(str(tmp_path / p.root))
            pub = p.keys.gen_priv_key_ed25519(b"val-seed").pub_key()
            app.begin_block(b"", p.ABCIHeader())
            assert app.deliver_tx(b"val:" + pub.raw.hex().encode() + b"/10").is_ok
            diffs = app.end_block(1).diffs
            assert len(diffs) == 1 and diffs[0].power == 10
            assert not app.deliver_tx(b"val:nothex/10").is_ok
            return [d.to_json() for d in diffs], app.validators

        both(body)


class TestCounterApp:
    def test_serial_ordering(self):
        def body(p):
            app = p.CounterApp(serial=True)
            out = [app.deliver_tx(b"\x00"), app.deliver_tx(b"\x01"), app.deliver_tx(b"\x05")]
            assert out[0].is_ok and out[1].is_ok
            assert not out[2].is_ok  # gap
            checks = [app.check_tx(b"\x02"), app.check_tx(b"\x00")]
            assert checks[0].is_ok
            assert not checks[1].is_ok  # below check count
            return _responses(out), _responses(checks)

        both(body)

    def test_commit_hash(self):
        def body(p):
            app = p.CounterApp()
            first = app.commit()
            assert first.data == b""
            app.deliver_tx(b"\x00")
            second = app.commit()
            assert second.data.endswith(b"\x01")
            return first.to_json(), second.to_json(), app.info().to_json()

        both(body)


class TestSocketClient:
    def test_roundtrip_over_tcp(self):
        def body(p):
            app = p.KVStoreApp()
            server = p.ABCIServer(app, "127.0.0.1:0")
            server.start()
            try:
                cli = p.SocketClient(server.addr)
                cli.start()
                assert cli.echo_sync("hello") == "hello"
                assert cli.info_sync().last_block_height == 0
                assert cli.deliver_tx_sync(b"x=42").is_ok
                res = cli.commit_sync()
                assert res.is_ok and len(res.data) == 20
                assert cli.query_sync(b"x").value == b"42"
                rrs = [cli.deliver_tx_async(b"k%d=%d" % (i, i)) for i in range(10)]
                got = [rr.wait(5) for rr in rrs]
                assert all(r.is_ok for r in got)
                cli.stop()
            finally:
                server.stop()
            return res.to_json(), _responses(got)

        both(body)


class TestAppConns:
    def test_three_connections(self):
        def body(p):
            conns = p.AppConns(p.LocalClientCreator(p.CounterApp(serial=True)))
            conns.start()
            info = conns.query().info_sync()
            assert info is not None
            assert conns.mempool().check_tx_async(b"\x00").wait(1).is_ok
            conns.consensus().begin_block_sync(b"", p.ABCIHeader())
            assert conns.consensus().deliver_tx_async(b"\x00").wait(1).is_ok
            commit = conns.consensus().commit_sync()
            assert commit.is_ok
            conns.stop()
            return info.to_json(), commit.to_json()

        both(body)

    def test_default_creator_names(self, tmp_path):
        def body(p):
            out = {}
            for name in ("kvstore", "dummy", "persistent_kvstore", "persistent_dummy",
                         "signedkv", "counter", "counter_serial", "nilapp"):
                c = p.default_client_creator(name, str(tmp_path / p.root))
                assert isinstance(c, p.LocalClientCreator)
                out[name] = (type(c.app).__name__, getattr(c.app, "serial", None))
            remote = p.default_client_creator("127.0.0.1:1")
            assert isinstance(remote, p.RemoteClientCreator)
            out["remote"] = (type(remote.new_abci_client()).__name__, remote.transport)
            return out

        both(body)


# -- libs/service and ReqRes --------------------------------------------------


class TestBaseService:
    def test_start_stop_idempotent(self):
        def body(p):
            events = []

            class Svc(p.BaseService):
                def on_start(self):
                    events.append("start")

                def on_stop(self):
                    events.append("stop")

            s = Svc()
            calls = [s.start(), s.start(), s.is_running(), s.stop(), s.stop(), s.is_running()]
            assert calls == [True, False, True, True, False, False]
            assert events == ["start", "stop"]
            return calls, events, repr(s)

        both(body)

    def test_wait_unblocks_on_stop(self):
        def body(p):
            s = p.BaseService()
            s.start()
            t = threading.Thread(target=lambda: (time.sleep(0.05), s.stop()))
            t.start()
            woke = s.wait(timeout=2.0)
            assert woke
            t.join()
            return woke, s.is_running()

        both(body)

    def test_no_restart(self):
        def body(p):
            s = p.BaseService()
            s.start()
            s.stop()
            with pytest.raises(RuntimeError) as exc:
                s.start()
            return str(exc.value)

        both(body)


def test_reqres_done_and_timeout_path():
    def body(p):
        rr = p.ReqRes("echo")
        assert not rr.done()
        assert rr.wait(timeout=0.01) is None
        assert not rr.done()
        rr.complete({"ok": True})
        assert rr.done()
        assert rr.wait() == {"ok": True}
        got = []
        rr.set_callback(got.append)  # already done -> fires inline
        assert got == [{"ok": True}]
        return got

    both(body)


# -- the sharded apply --------------------------------------------------------


def _tx_workload():
    txs = []
    for i in range(200):
        txs.append(f"key{i % 37}=value{i}".encode())  # hot keys: last-wins
    txs += [b"plainkey", b"rm:key3", b"key3=resurrected", b"rm:key11", b"rm:missing"]
    txs += [f"wide{i}={'x' * 50}".encode() for i in range(64)]
    return txs


def test_sharded_deliver_txs_byte_identical_to_serial():
    def body(p):
        txs = _tx_workload()
        serial, sharded = p.KVStoreApp(), p.KVStoreApp()
        sharded.shards = 3
        sharded.shard_min_txs = 4
        r1 = [serial.deliver_tx(tx) for tx in txs]
        r2 = sharded.deliver_txs(list(txs))
        assert _responses(r1) == _responses(r2)
        assert sharded.sharded_batches == 1
        assert serial.state == sharded.state
        h1 = serial.commit().data
        h2 = sharded.commit().data
        assert h1 == h2, "sharded apply forked the VersionedTree root"
        return h2, _responses(r2), sharded.tree.stats()

    both(body)


def test_sharded_deliver_persistent_val_txs_in_order(tmp_path):
    def body(p):
        pub_a = p.keys.gen_priv_key_ed25519(b"val-a").pub_key().raw.hex()
        pub_b = p.keys.gen_priv_key_ed25519(b"val-b").pub_key().raw.hex()
        txs = [b"k1=v1", f"val:{pub_a}/3".encode(), b"k2=v2",
               f"val:{pub_b}/7".encode(), b"rm:k1",
               f"val:{pub_a}/0".encode(), b"val:junk", b"k3=v3"] * 6
        serial = p.PersistentKVStoreApp(str(tmp_path / p.root / "serial"))
        sharded = p.PersistentKVStoreApp(str(tmp_path / p.root / "sharded"))
        sharded.shards = 2
        sharded.shard_min_txs = 4
        serial.begin_block(b"", None)
        sharded.begin_block(b"", None)
        r1 = [serial.deliver_tx(tx) for tx in txs]
        r2 = sharded.deliver_txs(list(txs))
        assert _responses(r1) == _responses(r2)
        d1 = [(v.pub_key_json, v.power) for v in serial.end_block(1).diffs]
        d2 = [(v.pub_key_json, v.power) for v in sharded.end_block(1).diffs]
        assert d1 == d2 and len(d1) == 18
        assert serial.validators == sharded.validators
        assert serial.state == sharded.state
        h = serial.commit().data
        assert h == sharded.commit().data
        return h, d2, sharded.validators

    both(body)


def test_sharded_path_below_floor_stays_serial():
    def body(p):
        app = p.KVStoreApp()
        app.shards = 4
        app.shard_min_txs = 32
        app.deliver_txs([b"a=1", b"b=2"])
        assert app.sharded_batches == 0
        assert app.state == {"a": b"1", "b": b"2"}
        return app.commit().data

    both(body)


# -- gRPC ---------------------------------------------------------------------


class TestABCIGRPC:
    @staticmethod
    def _pair(root: str):
        pytest.importorskip("grpc")
        grpc_mod = importlib.import_module(f"{root}.abci.grpc")
        app = importlib.import_module(f"{root}.abci.apps.kvstore").KVStoreApp()
        server = grpc_mod.GRPCServer(app, "127.0.0.1:0")
        server.start()
        client = grpc_mod.GRPCClient(server.addr)
        client.start()
        return server, client

    def _with_pair(self, run):
        def body(p):
            server, client = self._pair(p.root)
            try:
                return run(client)
            finally:
                client.stop()
                server.stop()

        return both(body)

    def test_sync_roundtrip(self):
        def run(c):
            assert c.echo_sync("hello") == "hello"
            info = c.info_sync()
            assert info.last_block_height == 0
            assert c.check_tx_sync(b"k=v").code == 0
            assert c.deliver_tx_sync(b"k=v").code == 0
            commit = c.commit_sync()
            assert commit.code == 0 and commit.data
            q = c.query_sync(b"k")
            assert q.value == b"v"
            return info.to_json(), commit.to_json(), q.to_json()

        self._with_pair(run)

    def test_async_ordering_and_callback(self):
        def run(c):
            seen = []
            c.set_response_callback(lambda t, tx, res: seen.append((t, tx)))
            rrs = [c.deliver_tx_async(b"key%d=v%d" % (i, i)) for i in range(10)]
            c.flush_sync()
            assert all(rr.wait(5) is not None for rr in rrs)
            assert [tx for _t, tx in seen] == [b"key%d=v%d" % (i, i) for i in range(10)]
            return seen, c.commit_sync().to_json()

        self._with_pair(run)

    def test_creator_dispatch(self):
        def body(p):
            c = p.default_client_creator("127.0.0.1:1", transport="grpc")
            assert isinstance(c, p.RemoteClientCreator) and c.transport == "grpc"
            name = type(c.new_abci_client()).__name__
            assert name == "GRPCClient"
            return name

        both(body)


def test_proxy_imports_without_grpc():
    """The card's machine has no grpc: the port's proxy, abci and gRPC
    modules import without it, and only a gRPC client asks for it."""
    code = (
        "import sys\n"
        "sys.modules['grpc'] = None\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tendermint_tpu'] = None\n"
        "import tendermint_tpu_torch.proxy as proxy\n"
        "import tendermint_tpu_torch.abci.grpc\n"
        "c = proxy.default_client_creator('kvstore')\n"
        "conns = proxy.AppConns(c)\n"
        "conns.start()\n"
        "assert conns.consensus().deliver_tx_async(b'a=1').wait(1).is_ok\n"
        "assert len(conns.consensus().commit_sync().data) == 20\n"
        "try:\n"
        "    proxy.default_client_creator('127.0.0.1:1', transport='grpc').new_abci_client().start()\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# -- state/fail ---------------------------------------------------------------


def test_fail_counters_and_reset(monkeypatch, tmp_path):
    """Unarmed and not-yet-due points count their hits, equally in both
    packages, and reset() clears every counter."""
    monkeypatch.setenv("FAIL_TEST_INDEX", "1000")
    monkeypatch.setenv("FAIL_TEST_PIPELINE_POINT", "mid_parallel_apply")
    monkeypatch.setenv("FAIL_TEST_PIPELINE_HITS", "1000")
    monkeypatch.setenv("FAIL_TEST_WAL_BYTES", "1000000")
    monkeypatch.setenv("FAIL_TEST_ROTATE_INDEX", "1000")

    def body(p):
        f = p.fail
        f.reset()
        for _ in range(3):
            f.fail_point()
        monkeypatch.setenv("FAIL_TEST_MODE", "pipeline")
        for _ in range(2):
            f.pipeline_point("mid_parallel_apply")
        f.pipeline_point("pre_apply")  # another name: not counted
        monkeypatch.setenv("FAIL_TEST_MODE", "torn_write")
        with open(tmp_path / f"{p.root}.wal", "wb") as fh:
            f.wal_write(fh, b"x" * 10)
            f.wal_write(fh, b"y" * 7)
        monkeypatch.setenv("FAIL_TEST_MODE", "rotate_crash")
        f.rotate_point("post")
        f.rotate_point("pre")  # the other phase: not counted
        got = (f._counter, dict(f._pipeline_hits), f._wal_bytes, f._rotations, f.EXIT_CODE)
        assert got == (3, {"mid_parallel_apply": 2}, 17, 1, 99)
        f.reset()
        cleared = (f._counter, dict(f._pipeline_hits), f._wal_bytes, f._rotations)
        assert cleared == (0, {}, 0, 0)
        monkeypatch.delenv("FAIL_TEST_MODE")
        return got, (tmp_path / f"{p.root}.wal").read_bytes()

    both(body)


def test_pipeline_point_exits_at_its_hit():
    """An armed point dies with EXIT_CODE at its hit in both packages."""
    for root in ("tendermint_tpu_torch", "tendermint_tpu"):
        code = (
            f"from {root}.state.fail import pipeline_point\n"
            "pipeline_point('mid_parallel_apply')\n"
            "pipeline_point('mid_parallel_apply')\n"
            "print('survived')\n"
        )
        env = dict(os.environ, PYTHONPATH=ROOT, FAIL_TEST_MODE="pipeline",
                   FAIL_TEST_PIPELINE_POINT="mid_parallel_apply", FAIL_TEST_PIPELINE_HITS="1")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 99, (root, proc.stderr)
        assert "survived" not in proc.stdout


# -- types/protobuf -----------------------------------------------------------


def test_tm2pb_bridge():
    def body(p):
        pub = p.keys.gen_priv_key_ed25519(b"pb-seed").pub_key()
        gen = [types.SimpleNamespace(pub_key=pub, power=7)]
        val = types.SimpleNamespace(pub_key=pub, voting_power=9)
        header = types.SimpleNamespace(chain_id="c", height=4, time_ns=5, num_txs=6,
                                       app_hash=b"\x01" * 20)
        return (
            [v.to_json() for v in p.protobuf.tm2pb_validators(gen)],
            p.protobuf.tm2pb_validator(val).to_json(),
            p.protobuf.tm2pb_header(header).to_json(),
        )

    both(body)


# -- a signed-kvstore block, verified in one batch ----------------------------


def test_signedkv_block_one_batch_equal_to_jax():
    """A 64-tx block with 3 forged signatures: the port verifies it in one
    batch through Verifier(device="cpu") (B1's plain version), the JAX
    package through its CPU verifier; responses and app hash are equal."""
    forged = {3, 30, 61}
    txs = _signed_block(PORT, 1, 64, forged, [])
    assert txs == _signed_block(JAX, 1, 64, forged, [])
    port = PORT.SignedKVStoreApp()
    port.deliver_verifier = _port_cpu_verifier()
    ref = JAX.SignedKVStoreApp()
    ref.deliver_verifier = _jax_cpu_verifier()
    got = port.deliver_txs(txs)
    want = ref.deliver_txs(txs)
    assert _responses(got) == _responses(want)
    assert [i for i, r in enumerate(got) if not r.is_ok] == sorted(forged)
    stats = port.deliver_verifier.stats()
    assert stats["tpu_batches"] == 1 and stats["tpu_sigs"] == 64 and stats["cpu_sigs"] == 0
    assert port.commit().data == ref.commit().data
    # the serial per-tx path agrees with the batch
    serial = PORT.SignedKVStoreApp()
    assert _responses([serial.deliver_tx(tx) for tx in txs]) == _responses(got)
    assert serial.commit().data == port.app_hash


# -- state carried across the packages ----------------------------------------


def _kv_state(n: int) -> list[bytes]:
    return [b"acct-%07d=" % i + bytes([(i * 7 + j) % 256 for j in range(16)]).hex().encode()
            for i in range(n)]


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)], ids=["jax_to_port", "port_to_jax"])
def test_snapshot_restores_across_packages(src, dst):
    a = src.KVStoreApp()
    a.deliver_txs(_kv_state(120))
    a.commit()
    a.deliver_tx(b"rm:acct-0000003")
    a.commit()
    snap = a.snapshot()
    b = dst.KVStoreApp()
    b.restore(snap, height=a.height, app_hash=a.app_hash)
    assert b.app_hash == a.app_hash and b.height == a.height == 2
    assert b.state == a.state
    assert b.snapshot() == snap
    for key in (b"acct-0000007", b"acct-0000003", b"zzz"):
        assert b.query(key, prove=True).to_json() == a.query(key, prove=True).to_json()
    # a tampered snapshot is refused before anything changes
    bad = json.loads(snap)
    bad["state"]["acct-0000001"] = "00"
    with pytest.raises(ValueError, match="does not match its state"):
        dst.KVStoreApp().restore(json.dumps(bad, sort_keys=True).encode())


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)], ids=["jax_to_port", "port_to_jax"])
def test_persistent_file_carries_across_packages(src, dst, tmp_path):
    home = str(tmp_path / "home")
    a = src.PersistentKVStoreApp(home)
    pub = src.keys.gen_priv_key_ed25519(b"carry").pub_key().raw.hex()
    a.begin_block(b"", src.ABCIHeader())
    a.deliver_txs(_kv_state(40) + [f"val:{pub}/5".encode()])
    a.commit()
    b = dst.PersistentKVStoreApp(home)
    assert (b.height, b.app_hash, b.state, b.validators) == (a.height, a.app_hash, a.state, a.validators)
    assert b.snapshot() == a.snapshot()
    b.deliver_tx(b"acct-0000001=changed")
    a.deliver_tx(b"acct-0000001=changed")
    assert b.commit().data == a.commit().data


# -- the socket wire between the packages -------------------------------------


class _Recorder:
    """A line relay in front of an ABCIServer that records every request
    and response frame as it crosses."""

    def __init__(self, upstream: str):
        host, port = upstream.rsplit(":", 1)
        frames = self.frames = []

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                up = socket.create_connection((host, int(port)), timeout=10)
                up_r = up.makefile("rb")
                try:
                    while True:
                        line = self.rfile.readline()
                        if not line:
                            return
                        up.sendall(line)
                        res = up_r.readline()
                        frames.append((line, res))
                        self.wfile.write(res)
                        self.wfile.flush()
                finally:
                    up.close()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("127.0.0.1", 0), Handler)
        self.addr = f"127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def _socket_session(client_pkg, server_pkg):
    app = server_pkg.KVStoreApp()
    server = server_pkg.ABCIServer(app, "127.0.0.1:0")
    server.start()
    rec = _Recorder(server.addr)
    cli = client_pkg.SocketClient(rec.addr)
    cli.start()
    try:
        out = [cli.echo_sync("hello"), cli.info_sync().to_json()]
        cli.begin_block_sync(b"\x01" * 20, client_pkg.ABCIHeader(chain_id="c", height=1))
        rrs = [cli.deliver_tx_async(b"k%d=%d" % (i, i)) for i in range(6)]
        rrs.append(cli.deliver_tx_async(b"rm:k2"))
        out.append([rr.wait(5).to_json() for rr in rrs])
        out.append(cli.end_block_sync(1).to_json())
        out.append(cli.commit_sync().to_json())
        out.append(cli.check_tx_sync(b"pri:x=1").to_json())
        out.append(cli.query_sync(b"k1").to_json())
        out.append(cli.query_sync(b"k2", prove=True).to_json())
        out.append(cli.set_option_sync("serial", "on"))
        cli.flush_sync()
    finally:
        cli.stop()
        rec.stop()
        server.stop()
    return out, rec.frames


def test_socket_wire_across_packages():
    """A JAX SocketClient against a port ABCIServer, and the reverse, send
    and receive the same frames and responses as JAX against JAX."""
    want, want_frames = _socket_session(JAX, JAX)
    for client_pkg, server_pkg in ((JAX, PORT), (PORT, JAX), (PORT, PORT)):
        got, frames = _socket_session(client_pkg, server_pkg)
        assert got == want, (client_pkg.root, server_pkg.root)
        assert frames == want_frames, (client_pkg.root, server_pkg.root)
    assert len(want_frames) == 17


# -- the slice as a whole, small ----------------------------------------------


def test_slice_restore_then_signed_blocks_through_app_conns():
    """A 300-key restore, then 3 blocks of 64 signed txs through
    AppConns(LocalClientCreator(...)) with shards=2, on both packages: the
    port's tree hashes its waves through Hasher(device="cpu") (K1's plain
    version) and its blocks verify through Verifier(device="cpu") (B1's
    plain version). Responses, app hashes and proof bytes are equal
    (abs_tol 0: every value compared is bytes or an integer)."""
    from tendermint_tpu_torch.ops.gateway import Hasher

    host = JAX.SignedKVStoreApp()
    # the state itself is unsigned: the plain kv apply builds it
    for tx in _kv_state(300):
        JAX.KVStoreApp.deliver_tx(host, tx)
    host.commit()
    assert len(host.state) == 300
    snap = host.snapshot()
    keys = sorted(k.encode("latin-1") for k in host.state)

    port = PORT.SignedKVStoreApp()
    hasher = Hasher(device="cpu")
    port.tree.hasher = hasher
    port.deliver_verifier = _port_cpu_verifier()
    port.shards = 2
    port.restore(snap)
    ref = JAX.SignedKVStoreApp()
    ref.deliver_verifier = _jax_cpu_verifier()
    ref.shards = 2
    ref.restore(snap)
    assert port.app_hash == ref.app_hash == host.app_hash
    assert hasher.stats()["tpu_leaves"] == port.tree.stats()["gateway_nodes"] >= 280

    conns = {}
    for name, app in (("port", port), ("jax", ref)):
        pkg = PORT if name == "port" else JAX
        c = pkg.AppConns(pkg.LocalClientCreator(app))
        c.start()
        conns[name] = (pkg, c)
    for height in (2, 3, 4):
        txs = _signed_block(PORT, height, 64, {height, 40 + height}, keys)
        hashes = {}
        for name, (pkg, c) in conns.items():
            con = c.consensus()
            con.begin_block_sync(b"\x02" * 20, pkg.ABCIHeader(chain_id="slice", height=height))
            reses = [rr.wait(5) for rr in con.deliver_txs_async(txs)]
            end = con.end_block_sync(height)
            commit = con.commit_sync()
            hashes[name] = (_responses(reses), end.to_json(), commit.to_json())
        assert hashes["port"] == hashes["jax"], height
        refused = [i for i, r in enumerate(hashes["port"][0]) if r["code"] != 0]
        assert refused == sorted({height, 40 + height})
    assert port.sharded_batches == ref.sharded_batches == 3
    vstats = port.deliver_verifier.stats()
    assert vstats["tpu_batches"] == 3 and vstats["tpu_sigs"] == 192 and vstats["cpu_sigs"] == 0
    assert hasher.stats()["cpu_leaves"] == 0
    for key in keys[::37] + [b"new-3-1", b"absent-key"]:
        pq = conns["port"][1].query().query_sync(key, prove=True)
        jq = conns["jax"][1].query().query_sync(key, prove=True)
        assert pq.to_json() == jq.to_json()
        proof = PORT.StateTreeProof.from_json(json.loads(pq.proof))
        assert proof.verify(port.app_hash)
    for c in conns.values():
        c[1].stop()


# -- State and block execution (tests/test_abci_state.py) ---------------------


def _make_val_set(p, n: int, power: int = 10):
    """n equal-power validators from seeded keys, and their signers in the
    set's address order."""
    privs = [p.types.PrivValidatorFS(p.keys.gen_priv_key_ed25519(f"val-{i}".encode()), None)
             for i in range(n)]
    vs = p.types.ValidatorSet([p.types.Validator.new(pv.get_pub_key(), power) for pv in privs])
    privs.sort(key=lambda pv: pv.get_address())
    return vs, privs


def _make_genesis(p, n=4, power=10, chain_id="exec-chain", **schedule):
    vs, privs = _make_val_set(p, n, power)
    doc = p.types.GenesisDoc(
        genesis_time_ns=0, chain_id=chain_id,
        validators=[p.types.GenesisValidator(v.pub_key, v.voting_power) for v in vs.validators],
        **schedule,
    )
    return doc, vs, privs


def _commit_for(p, chain_id, vs, privs, height, block_id):
    """The +2/3 precommits (here all) of `height` for `block_id`, as a
    VoteSet makes them."""
    voteset = p.types.VoteSet(chain_id, height, 0, p.types.VOTE_TYPE_PRECOMMIT, vs)
    for pv in privs:
        idx, _ = vs.get_by_address(pv.get_address())
        vote = p.types.Vote(validator_address=pv.get_address(), validator_index=idx, height=height,
                            round_=0, type_=p.types.VOTE_TYPE_PRECOMMIT, block_id=block_id)
        voteset.add_vote(pv.sign_vote(chain_id, vote))
    return voteset.make_commit()


def _make_next_block(p, state, txs, privs, part_size=4096):
    """A valid next block with a proper commit for the last block."""
    height = state.last_block_height + 1
    if height == 1:
        commit = p.block.empty_commit()
    else:
        commit = _commit_for(p, state.chain_id, state.last_validators, privs, height - 1,
                             state.last_block_id)
    return p.types.Block.make_block(
        height, state.chain_id, txs, commit, state.last_block_id, state.validators.hash(),
        state.app_hash, part_size, time_ns=height * 10**9,
    )


class TestStatePersistence:
    def test_genesis_and_reload(self):
        def body(p):
            doc, vs, _ = _make_genesis(p)
            db = p.db.MemDB()
            s = p.state.State.get_state(db, doc)
            s2 = p.state.State.get_state(db, doc)
            return (s.last_block_height, s.validators.hash() == vs.hash(), s2.equals(s), s.bytes_(),
                    sorted(db._data.items()))

        got = both(body)
        assert got[:3] == (0, True, True)

    def test_validators_history(self):
        def body(p):
            doc, vs, privs = _make_genesis(p)
            db = p.db.MemDB()
            s = p.state.State.get_state(db, doc)
            # heights 1..3 without changes: the pointer chain resolves to the genesis set
            conns = p.AppConns(p.LocalClientCreator(p.KVStoreApp()))
            conns.start()
            for h in range(1, 4):
                block, ps = _make_next_block(p, s, [b"tx%d" % h], privs)
                p.state.apply_block(s, None, conns.consensus(), block, ps.header(), p.MockMempool())
            conns.stop()
            return ([s.load_validators(h).hash() == vs.hash() for h in range(1, 4)], s.bytes_(),
                    sorted(db._data.items()))

        assert both(body)[0] == [True] * 3


class TestExecution:
    @staticmethod
    def _setup(p, app=None):
        doc, vs, privs = _make_genesis(p)
        s = p.state.State.get_state(p.db.MemDB(), doc)
        s.tx_indexer = p.KVTxIndexer(p.db.MemDB())
        conns = p.AppConns(p.LocalClientCreator(app or p.KVStoreApp()))
        conns.start()
        return s, conns, privs

    def test_apply_blocks_advances_state(self):
        def body(p):
            s, conns, privs = self._setup(p)
            seen = []
            for h in range(1, 4):
                block, ps = _make_next_block(p, s, [b"key%d=val%d" % (h, h)], privs)
                p.state.apply_block(s, None, conns.consensus(), block, ps.header(), p.MockMempool())
                seen.append((s.last_block_height, s.last_block_id.hash == block.hash(), s.bytes_()))
            # the app hash binds the app state, and the tx is indexed
            q = conns.query().query_sync(b"key1")
            r = s.tx_indexer.get(p.tx.tx_hash(b"key1=val1"))
            conns.stop()
            return seen, q.value, r.to_json(), sorted(s.tx_indexer.db._data.items())

        seen, value, indexed, _ = both(body)
        assert [x[:2] for x in seen] == [(1, True), (2, True), (3, True)]
        assert value == b"val1" and indexed["height"] == 1

    def test_validate_block_rejects(self):
        def body(p):
            s, conns, privs = self._setup(p)
            block, ps = _make_next_block(p, s, [b"a=1"], privs)
            p.state.apply_block(s, None, conns.consensus(), block, ps.header(), p.MockMempool())
            errs = []
            # the wrong height
            bad, _ = _make_next_block(p, s, [b"b=2"], privs)
            bad.header.height = 99
            with pytest.raises(p.execution.InvalidBlockError) as e:
                p.state.validate_block(s, bad)
            errs.append(str(e.value))
            # a tampered commit: two signatures dropped leave it below quorum
            bad2, _ = _make_next_block(p, s, [b"b=2"], privs)
            signed = [i for i, pre in enumerate(bad2.last_commit.precommits) if pre]
            for i in signed[:2]:
                bad2.last_commit.precommits[i] = None
            bad2.header.last_commit_hash = bad2.last_commit.hash()
            bad2.header.data_hash = b""
            bad2.fill_header()
            with pytest.raises(p.execution.InvalidBlockError) as e:
                p.state.validate_block(s, bad2)
            errs.append(str(e.value))
            conns.stop()
            return errs

        errs = both(body)
        assert "height" in errs[0] and "voting power" in errs[1]

    def test_events_fired_on_flush(self):
        def body(p):
            s, conns, privs = self._setup(p)
            evsw = p.levents.EventSwitch()
            got = []
            tx = b"watched=1"
            evsw.add_listener_for_event("t", p.events.event_string_tx(p.tx.tx_hash(tx)), got.append)
            cache = p.levents.EventCache(evsw)
            block, ps = _make_next_block(p, s, [tx], privs)
            p.state.apply_block(s, cache, conns.consensus(), block, ps.header(), p.MockMempool())
            before = len(got)  # not yet flushed
            cache.flush()
            conns.stop()
            return before, [d.to_json() for d in got]

        before, got = both(body)
        assert before == 0 and len(got) == 1 and got[0]["height"] == 1

    def test_valset_change_via_endblock(self, tmp_path):
        def body(p):
            d = tmp_path / p.root
            app = p.PersistentKVStoreApp(str(d))
            s, conns, privs = self._setup(p, app)
            new_pub = p.keys.gen_priv_key_ed25519(b"newval").pub_key()
            block, ps = _make_next_block(p, s, [b"val:" + new_pub.raw.hex().encode() + b"/7"], privs)
            p.state.apply_block(s, None, conns.consensus(), block, ps.header(), p.MockMempool())
            _, v = s.validators.get_by_address(new_pub.address())
            out = [s.validators.size(), s.last_height_validators_changed, v.voting_power, s.bytes_()]
            # removal
            block2, ps2 = _make_next_block(p, s, [b"val:" + new_pub.raw.hex().encode() + b"/0"], privs)
            p.state.apply_block(s, None, conns.consensus(), block2, ps2.header(), p.MockMempool())
            out += [s.validators.size(), s.bytes_(), s.load_validators(3).to_json()]
            conns.stop()
            return out

        got = both(body)
        assert got[:3] == [5, 2, 7] and got[4] == 4

    def test_exec_commit_block(self):
        def body(p):
            s, conns, privs = self._setup(p)
            block, _ = _make_next_block(p, s, [b"z=9"], privs)
            app_hash = p.state.exec_commit_block(conns.consensus(), block)
            conns.stop()
            return app_hash

        assert len(both(body)) == 20

    def test_update_validators_errors(self):
        def body(p):
            _, vs, _ = _make_genesis(p)
            missing = p.keys.gen_priv_key_ed25519(b"missing").pub_key()
            diff = p.ABCIValidator([p.keys.TYPE_ED25519, missing.raw.hex().upper()], -5)
            with pytest.raises(ValueError) as e:
                p.execution.update_validators(vs, [diff])
            # an unknown key with power adds; power 0 on a member removes it
            key = [p.keys.TYPE_ED25519, missing.raw.hex().upper()]
            p.execution.update_validators(vs, [p.ABCIValidator(key, 3)])
            added = (vs.size(), vs.hash())
            p.execution.update_validators(vs, [p.ABCIValidator(key, 0)])
            return str(e.value), added, vs.size(), vs.hash()

        err, added, size, _ = both(body)
        assert err == "negative power -5" and added[0] == 5 and size == 4


# -- the execution path as a whole, small --------------------------------------

SLICE_VALIDATORS = 4
SLICE_HEIGHTS = 3
SLICE_TXS = 64
SLICE_FORGED = 3


def _slice_txs(p, height: int) -> tuple[list[bytes], list[int]]:
    """SLICE_TXS signed txs and SLICE_FORGED forged ones, shuffled: new keys
    and updates of the earlier heights' keys."""
    txs, forged = [], []
    for i in range(SLICE_TXS + SLICE_FORGED):
        seed = bytes([height, i % 5]) + b"\x33" * 30
        if i % 3 == 0 and height > 1:
            payload = b"k-%d-%d=h%d" % (height - 1, i, height)
        else:
            payload = b"k-%d-%d=v%d" % (height, i, i)
        tx = p.make_sig_tx(seed, payload)
        if i % 23 == 7:
            tx = tx[:40] + bytes([tx[40] ^ 0x10]) + tx[41:]
            forged.append(i)
        txs.append(tx)
    assert len(forged) == SLICE_FORGED
    return txs, forged


def _drain(mp, size: int, results: dict, n: int, timeout: float = 120.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        mp.flush_app_conn()
        if mp.size() == size and len(results) == n:
            return
        time.sleep(0.01)
    raise AssertionError(f"mempool holds {mp.size()}, {len(results)} of {n} answered")


def _run_slice_chain(p, d, verifier, hasher):
    """The node's wiring by hand (node/node.py): sqlite state, block store
    and tx index; a SignedKVStoreApp behind AppConns; a mempool with a WAL
    whose SigBatcher gates on `verifier`. Three heights across the upgrade
    height 3: check_tx, reap, the block built as consensus builds it,
    apply_block, the precommits, save_block. Returns what each height
    produced and what the stores hold."""
    doc, _vs, privs = _make_genesis(p, SLICE_VALIDATORS, chain_id="exec-slice",
                                    upgrade_height=3, upgrade_format="aggregate")
    dbs = {name: p.db.db_provider(name, "sqlite", str(d)) for name in ("state", "blockstore", "tx_index")}
    state = p.state.State.get_state(dbs["state"], doc)
    state.tx_indexer = p.KVTxIndexer(dbs["tx_index"])
    store = p.BlockStore(dbs["blockstore"])
    app = p.SignedKVStoreApp(verify_in_app=False)
    app.deliver_verifier = verifier
    if hasher is not None:
        app.tree.hasher = hasher
    conns = p.AppConns(p.LocalClientCreator(app))
    conns.start()
    cfg = p.make_test_config().mempool
    cfg.root_dir = str(d)
    batcher = p.mempool.SigBatcher(verifier, p.parse_sig_tx, max_wait_s=0.05)
    mp = p.mempool.Mempool(cfg, conns.mempool(), sig_batcher=batcher)
    mp.init_wal()
    evsw = p.levents.EventSwitch()
    fired = []
    out = {"heights": [], "refusals": []}
    seen_commit = None
    try:
        for height in range(1, SLICE_HEIGHTS + 1):
            txs, forged = _slice_txs(p, height)
            results: dict = {}
            for i, tx in enumerate(txs):
                mp.check_tx(tx, cb=lambda res, i=i: results.__setitem__(i, res.code))
            _drain(mp, SLICE_TXS, results, len(txs))
            refused = sorted(i for i, c in results.items() if c)
            reaped = mp.reap(10_000)
            if height == 1:
                last = p.block.empty_commit()
            elif doc.aggregate_commits_at(height):
                last = p.agg.AggregateCommit.from_commit(seen_commit, state.chain_id, state.last_validators)
            else:
                last = seen_commit
            kwargs = {}
            if hasher is not None:
                p.tx.set_batch_tx_root(hasher.tx_merkle_root)
                kwargs = dict(part_hasher=hasher.part_leaf_hashes, part_tree_hasher=hasher.part_set_tree,
                              part_tree_submitter=hasher.submit_part_set_tree)
            block, parts = p.types.Block.make_block(
                height, state.chain_id, reaped, last, state.last_block_id, state.validators.hash(),
                state.app_hash, doc.consensus_params.block_gossip.block_part_size_bytes,
                time_ns=height * 10**9, **kwargs)
            if height >= 2:
                out["refusals"].append(_tampered_refusal(p, state, block))
            evsw.add_listener_for_event("w", p.events.event_string_tx(p.tx.tx_hash(reaped[0])),
                                        lambda data: fired.append(data.to_json()))
            cache = p.levents.EventCache(evsw)
            p.state.apply_block(state, cache, conns.consensus(), block, parts.header(), mp,
                                batch_verifier=verifier.commit_batch_verifier())
            cache.flush()
            seen_commit = _commit_for(p, state.chain_id, state.last_validators, privs, height,
                                      state.last_block_id)
            store.save_block(block, parts, seen_commit)
            out["heights"].append({
                "refused": refused, "forged": forged, "reaped": reaped, "block": block.to_bytes(),
                "parts": parts.header().to_json(), "state": state.bytes_(), "app_hash": state.app_hash,
                "abci": state.load_abci_responses().bytes_(), "pool_after": mp.size(),
                "format": block.commit_format(),
            })
        out["events"] = fired
        out["store"] = [(store.load_block(h).to_bytes(), store.load_block_meta(h).to_json(),
                         store.load_block_commit(h - 1).to_json(), store.load_seen_commit(h).to_json())
                        for h in range(1, store.height() + 1)]
        out["index"] = [state.tx_indexer.get(p.tx.tx_hash(tx)).to_json()
                        for h in out["heights"] for tx in h["reaped"]]
        out["raw"] = {name: list(db.iterate_prefix(b"")) for name, db in dbs.items()}
        out["check_tx_calls"] = app.check_tx_calls
    finally:
        batcher.stop()
        mp.close_wal()
        conns.stop()
        if hasher is not None:
            p.tx.set_batch_tx_root(None)
    with open(cfg.wal_dir(), "rb") as f:
        out["wal"] = f.read()
    reopened = p.state.State.load_state(dbs["state"], doc)
    out["reloaded"] = reopened.bytes_() == state.bytes_()
    for db in dbs.values():
        db.close()
    return out


def _tampered_refusal(p, state, block) -> str:
    """validate_block on a copy of `block` whose LastCommit is tampered: a
    forged precommit in a full commit, a dropped signer in an aggregate."""
    bad = p.types.Block.from_bytes(block.to_bytes())
    lc = bad.last_commit
    if isinstance(lc, p.agg.AggregateCommit):
        signers = lc.signers.copy()
        signers.set_index(signers.indices()[0], False)
        bad.last_commit = p.agg.AggregateCommit(lc.block_id, lc.height(), lc.round_(), signers,
                                                lc.rs[1:], lc.s_agg)
    else:
        pre = lc.precommits[1]
        raw = bytearray(pre.signature.raw)
        raw[5] ^= 0x20
        lc.precommits[1] = pre.with_signature(type(pre.signature)(bytes(raw)))
        lc._hash = None
    bad.header.last_commit_hash = bad.last_commit.hash()
    bad.fill_header()
    with pytest.raises(p.execution.InvalidBlockError) as e:
        p.state.validate_block(state, bad)
    return str(e.value)


def test_slice_chain_gated_built_applied_stored(tmp_path, monkeypatch):
    """4 validators, upgrade height 3 (aggregate), three heights of 64
    signed txs and 3 forged through Mempool(SigBatcher(...)), the block
    build, apply_block and save_block, in both packages. The port gates,
    delivers and checks each LastCommit on Verifier(min_tpu_batch=4,
    device="cpu") (B1's plain version; the aggregate LastCommit on dsm's,
    through the default verifier) and builds on Hasher(device="cpu") (K1's
    and K3's plain versions); the JAX package on its CPU verifier with no
    hasher. Block bytes, state bytes, app hashes, store records, tx-index
    entries and the mempool WAL are equal (abs_tol 0: all are bytes or
    integers)."""
    from tendermint_tpu.ops.gateway import Verifier as JVerifier
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops.gateway import Hasher, Verifier

    port_v = Verifier(min_tpu_batch=4, device="cpu")
    monkeypatch.setattr(gateway, "_default_verifier", port_v)
    hasher = Hasher(device="cpu", min_tpu_batch=1)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _run_slice_chain(PORT, tmp_path / "port", port_v, hasher)
    want = _run_slice_chain(JAX, tmp_path / "jax", JVerifier(min_tpu_batch=4, use_tpu=False), None)
    assert got == want
    for h in got["heights"]:
        assert h["refused"] == h["forged"] and len(h["reaped"]) == SLICE_TXS and h["pool_after"] == 0
    assert [h["format"] for h in got["heights"]] == ["full", "full", "aggregate"]
    assert "invalid signature" in got["refusals"][0] and got["refusals"][1]
    assert got["check_tx_calls"] == SLICE_HEIGHTS * SLICE_TXS  # no forged tx reached the app
    assert got["reloaded"] and len(got["index"]) == SLICE_HEIGHTS * SLICE_TXS
    assert got["wal"].count(b"\n") == SLICE_HEIGHTS * (SLICE_TXS + SLICE_FORGED)
    # every wide batch of the port's ran its kernels' plain versions
    st = port_v.stats()
    assert st["agg_batches"] >= 1 and st["agg_lanes_device"] >= SLICE_VALIDATORS + 1
    assert st["tpu_sigs"] >= SLICE_HEIGHTS * SLICE_TXS * 2
    assert hasher.stats()["tpu_tx_roots"] >= SLICE_HEIGHTS
