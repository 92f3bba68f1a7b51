"""Crash-restart persistence tests on the port's node (reference:
test/persist/test_failure_indices.sh + consensus/replay_test.go handshake
tiers).

A node subprocess runs with FAIL_TEST_INDEX=i so the i-th fail point
(consensus finalize-commit + state apply-block crash boundaries) aborts
the process mid-commit; the restart must recover via WAL replay + ABCI
handshake and keep committing on the same chain, with the persistent
kvstore app's state intact.

The port's copy of tests/test_persist.py: the node is a
`python -m tendermint_tpu_torch.cli node` subprocess verifying and hashing
through a port device daemon that accepts the CPU (`devd_sock`). After the
last cycle the JAX package's BlockStore reads the port's chain to the
same blocks as the port's.

The subprocess scaffolding (fast config, node proc, RPC poll) is shared
with the port's WAL torture tier: tests/test_torch_cli.py.
"""

from __future__ import annotations

import signal
import subprocess
import time

import pytest

from tests.test_torch_cli import (  # noqa: F401 — devd_sock is a fixture
    devd_sock,
    free_port,
    init_node_home,
    node_proc,
    rpc,
    wait_height,
)
from tests.test_torch_wal_torture import _store_fingerprints


@pytest.mark.slow
def test_crash_restart_at_every_fail_point(tmp_path, devd_sock):
    """One crash-recover cycle per FAIL_TEST_INDEX (the 8 fail points:
    5 in consensus finalize-commit, 3 in apply-block)."""
    home = str(tmp_path / "persist")
    init_node_home(home, "persist-chain")

    committed_value = 0
    for fail_index in range(8):
        port = free_port()
        proc = node_proc(home, port, fail_index, devd_sock=devd_sock)
        # wait for the crash (exit 99 from the fail point)
        deadline = time.time() + 60
        while proc.poll() is None and time.time() < deadline:
            time.sleep(0.2)
        if proc.poll() is None:
            proc.kill()
            out = proc.stdout.read().decode(errors="replace")[-2000:]
            raise AssertionError(
                f"node did not hit fail point {fail_index} in 60s:\n{out}"
            )
        assert proc.returncode == 99, (
            f"fail {fail_index}: expected crash exit 99, got {proc.returncode}: "
            + proc.stdout.read().decode(errors="replace")[-2000:]
        )

        # restart WITHOUT the fail index: must recover and keep going
        port = free_port()
        proc = node_proc(home, port, None, devd_sock=devd_sock)
        try:
            h = wait_height(port, 1, 60)
            assert h >= 1, f"no recovery after fail point {fail_index} (h={h})"
            # commit a tx to prove the recovered chain is live + app is sane
            committed_value += 1
            tx = f"persist-{fail_index}={committed_value}".encode()
            res = rpc(port, "broadcast_tx_commit", timeout=30, tx=tx.hex())
            assert res["deliver_tx"]["code"] == 0, res
            q = rpc(
                port, "abci_query", timeout=10,
                data=f"persist-{fail_index}".encode().hex(),
            )
            assert bytes.fromhex(q["response"]["value"]) == str(committed_value).encode()
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(15)
            except subprocess.TimeoutExpired:
                proc.kill()
    assert _store_fingerprints(home)  # both packages read the same chain
