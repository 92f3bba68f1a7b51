"""The port's race-discipline tier (tendermint_tpu_torch/libs/racecheck.py),
on the cases of tests/test_race.py. Python's GIL masks word-tearing, so
the detector targets what actually deadlocks a threaded BFT node:
lock-order inversions and non-reentrant re-entry, recorded process-wide.

Unit tests of the detector, then stress runs of the port's p2p and
consensus stack under instrumentation with a shrunken GIL switch interval
(the whole multi-reactor net must come out cycle-free), then the same
lock programs run under both packages' monitors, which must report the
same findings."""

from __future__ import annotations

import os
import sys
import threading
import time

import pytest

from tendermint_tpu.libs import racecheck as jracecheck
from tendermint_tpu_torch.libs import racecheck
from tests.test_torch_consensus import host_device  # noqa: F401 — autouse: CPU gateway defaults


@pytest.fixture
def mon():
    m = racecheck.install()
    try:
        yield m
    finally:
        racecheck.uninstall()


class TestDetector:
    def test_consistent_order_is_clean(self, mon):
        a, b = threading.Lock(), threading.Lock()

        def use():
            for _ in range(5):
                with a:
                    with b:
                        pass

        ts = [threading.Thread(target=use) for _ in range(4)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        mon.check()  # no cycles

    def test_inversion_is_a_cycle(self, mon):
        # two sites acquired in opposite orders by different code paths;
        # sites are construction call-sites, so build on distinct lines
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert mon.cycles(repo_only=False)
        with pytest.raises(racecheck.LockOrderError, match="cycle"):
            mon.check(repo_only=False)

    def test_self_deadlock_raises_instead_of_hanging(self, mon):
        lk = threading.Lock()
        lk.acquire()
        with pytest.raises(racecheck.LockOrderError, match="self-deadlock"):
            lk.acquire()
        lk.release()

    def test_rlock_reentry_is_fine(self, mon):
        lk = threading.RLock()
        with lk:
            with lk:
                pass
        mon.check()

    def test_try_acquire_adds_no_edges(self, mon):
        a, b = threading.Lock(), threading.Lock()
        with a:
            assert b.acquire(False)
            b.release()
        with b:
            assert a.acquire(False)
            a.release()
        mon.check(repo_only=False)  # try-locks can't deadlock

    def test_condition_and_queue_survive_instrumentation(self, mon):
        import queue

        q = queue.Queue()
        got = []

        def worker():
            got.append(q.get(timeout=5))

        t = threading.Thread(target=worker)
        t.start()
        q.put("x")
        t.join()
        assert got == ["x"]

        cond = threading.Condition()
        flag = []

        def waiter():
            with cond:
                while not flag:
                    cond.wait(timeout=5)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            flag.append(1)
            cond.notify_all()
        t.join()
        mon.check()

    def test_thread_affinity_assert(self):
        racecheck.reset_affinity()
        obj = object()
        racecheck.assert_owner(obj, "round_state")
        racecheck.assert_owner(obj, "round_state")  # same thread: fine
        err = []

        def other():
            try:
                racecheck.assert_owner(obj, "round_state")
            except racecheck.LockOrderError as e:
                err.append(e)

        t = threading.Thread(target=other, name="intruder")
        t.start()
        t.join()
        assert err and "intruder" in str(err[0])
        racecheck.reset_affinity()


class TestStackDiscipline:
    """The port's stack, instrumented."""

    def test_pex_net_is_cycle_free(self):
        from tendermint_tpu_torch.p2p import make_connected_switches
        from tendermint_tpu_torch.p2p.addrbook import AddrBook
        from tendermint_tpu_torch.p2p.netaddress import NetAddress
        from tendermint_tpu_torch.p2p.node_info import NodeInfo, default_version
        from tendermint_tpu_torch.p2p.pex import PEXReactor

        old_interval = sys.getswitchinterval()
        mon = racecheck.install()
        try:
            sys.setswitchinterval(1e-5)
            books = [AddrBook("", routability_strict=False) for _ in range(3)]
            books[0].add_address(
                NetAddress("127.0.0.1", 7991), NetAddress("127.0.0.1", 1)
            )

            def init(i, sw):
                sw.add_reactor("pex", PEXReactor(books[i], ensure_peers_period=0.05))
                sw.set_node_info(
                    NodeInfo(
                        pub_key=sw.node_priv_key.pub_key(),
                        moniker=f"r{i}",
                        network="race_test",
                        version=default_version("0.1.0"),
                        listen_addr=f"127.0.0.1:{7700 + i}",
                    )
                )
                return sw

            sws = make_connected_switches(3, init)
            time.sleep(1.0)
            for sw in sws:
                sw.stop()
        finally:
            sys.setswitchinterval(old_interval)
            racecheck.uninstall()
        mon.check()

    @pytest.mark.slow
    def test_consensus_net_is_cycle_free(self):
        """3 port validators committing real blocks under instrumentation
        + aggressive thread preemption: no lock-order cycles anywhere in
        the consensus/mempool/p2p stack."""
        from tests.test_torch_reactors import start_consensus_net, stop_net, wait_until

        old_interval = sys.getswitchinterval()
        mon = racecheck.install()
        try:
            sys.setswitchinterval(1e-4)
            nodes, switches = start_consensus_net(3)
            try:
                assert wait_until(
                    lambda: all(len(n.blocks) >= 2 for n in nodes), timeout=90
                ), [len(n.blocks) for n in nodes]
            finally:
                stop_net(nodes, switches)
        finally:
            sys.setswitchinterval(old_interval)
            racecheck.uninstall()
        mon.check()
        # the net did real work under instrumentation
        assert mon.edges, "expected lock-order edges from the live stack"


class TestRLockReentry:
    def test_reentry_under_sublock_is_not_a_cycle(self):
        """`with r: with b: with r:` is deadlock-free (RLock re-entry
        never blocks) and must not report a phantom cycle."""
        mon = racecheck.install()
        try:
            r = threading.RLock()
            b = threading.Lock()
            with r:
                with b:
                    with r:
                        pass
        finally:
            racecheck.uninstall()
        mon.check(repo_only=False)


# -- against the JAX package ----------------------------------------------------


def _inversion():
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _self_deadlock():
    lk = threading.Lock()
    lk.acquire()
    try:
        lk.acquire()
    finally:
        lk.release()


def _rlock_reentry():
    r = threading.RLock()
    b = threading.Lock()
    with r:
        with b:
            with r:
                pass


def _try_acquire():
    a = threading.Lock()
    b = threading.Lock()
    with a:
        assert b.acquire(False)
        b.release()
    with b:
        assert a.acquire(False)
        a.release()


def _three_site_cycle():
    a = threading.Lock()
    b = threading.RLock()
    c = threading.Lock()

    def ab():
        with a:
            with b:
                pass

    def bc():
        with b:
            with c:
                pass

    for fn in (ab, bc):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    with c:
        with a:
            pass


PROGRAMS = {
    "inversion": _inversion,
    "self_deadlock": _self_deadlock,
    "rlock_reentry": _rlock_reentry,
    "try_acquire": _try_acquire,
    "three_site_cycle": _three_site_cycle,
}


def _findings(rc, program) -> dict:
    """What `rc`'s monitor reports for one lock program: the error the
    program met, the cycles by (file name, line), the first line of each
    violation and of check()'s verdict, and the edge count."""
    mon = rc.install()
    try:
        try:
            program()
            met = None
        except rc.LockOrderError as exc:
            met = str(exc).splitlines()[0]
    finally:
        rc.uninstall()
    try:
        mon.check(repo_only=False)
        verdict = "clean"
    except rc.LockOrderError as exc:
        verdict = str(exc).splitlines()[0]
    return {
        "met": met,
        "cycles": [[(os.path.basename(f), line) for f, line in c] for c in mon.cycles(repo_only=False)],
        "violations": [v.splitlines()[0] for v in mon.violations],
        "verdict": verdict,
        "edges": sum(len(bs) for bs in mon.edges.values()),
    }


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_both_monitors_report_the_same_findings(name):
    """The same lock program under the JAX package's monitor and the
    port's: the same error met, cycles, violations and verdict."""
    port = _findings(racecheck, PROGRAMS[name])
    jax = _findings(jracecheck, PROGRAMS[name])
    assert port == jax
    want_clean = name in ("rlock_reentry", "try_acquire")
    assert (port["verdict"] == "clean") == want_clean, port
    if name == "self_deadlock":
        assert port["met"].startswith("self-deadlock") and port["violations"]
    if name in ("inversion", "three_site_cycle"):
        assert port["cycles"] and port["verdict"].startswith("lock-order cycle")


def test_site_filter_names_the_port_package():
    """repo_only keeps the sites under the port's own package directory:
    a cycle built in this test file is outside it for the port's monitor."""
    assert racecheck._REPO_PREFIX == os.path.dirname(os.path.dirname(os.path.abspath(racecheck.__file__)))
    assert os.path.basename(racecheck._REPO_PREFIX) == "tendermint_tpu_torch"
    mon = racecheck.install()
    try:
        _inversion()
    finally:
        racecheck.uninstall()
    assert mon.cycles(repo_only=False) and not mon.cycles(repo_only=True)
    mon.check()
