"""The port's full node + JSON-RPC, on the cases of tests/test_node_rpc.py;
the operator tools' cases (ops/trace, ops/fleet, ops/txtrace) hold the
port's renders, timelines and joins of the live node's scrapes equal to
the JAX package's. Reference test models: rpc/client/rpc_test.go,
rpc/test/helpers.go — start a real node in-process, drive it over RPC.
The node runs on the gateway's CPU defaults (`host_defaults`)."""

from __future__ import annotations

import json
import re
import tempfile
import time
import urllib.request

import pytest

from tendermint_tpu_torch.config import reset_test_root
from tendermint_tpu_torch.node import default_new_node
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError, WSClient


def wait_until(cond, timeout=30.0, tick=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


@pytest.fixture(scope="module")
def host_defaults():
    """The gateway's default verifier and hasher on the CPU for the module's
    node: a port node takes the card's defaults, and there is none here."""
    from tendermint_tpu_torch.ops import gateway

    saved = gateway._default_verifier, gateway._default_hasher
    gateway._default_verifier = gateway.Verifier(device="cpu")
    gateway._default_hasher = gateway.Hasher(device="cpu", min_tpu_batch=1 << 30)
    yield
    gateway._default_verifier, gateway._default_hasher = saved


@pytest.fixture(scope="module")
def node(host_defaults):
    tmp = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    cfg = reset_test_root(tmp)
    cfg.base.proxy_app = "kvstore"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    n = default_new_node(cfg)
    n.start()
    assert wait_until(lambda: n.block_store.height() >= 1, timeout=30)
    yield n
    n.stop()


@pytest.fixture(scope="module")
def client(node):
    return HTTPClient(f"127.0.0.1:{node.rpc_port()}")


def test_status(node, client):
    res = client.status()
    assert res["latest_block_height"] >= 1
    assert res["node_info"]["moniker"] == node.config.base.moniker
    assert len(res["latest_app_hash"]) >= 0


def test_abci_info_and_query(node, client):
    res = client.abci_info()
    assert res["response"]["last_block_height"] >= 0


def test_broadcast_tx_commit_and_lookup(node, client):
    tx = b"rpc-key=rpc-value"
    res = client.broadcast_tx_commit(tx=tx.hex())
    assert res["check_tx"]["code"] == 0
    assert res["deliver_tx"]["code"] == 0
    assert res["height"] >= 1
    # abci_query sees the committed value
    q = client.abci_query(data=b"rpc-key".hex())
    assert bytes.fromhex(q["response"]["value"]) == b"rpc-value"
    # tx indexer lookup with merkle proof
    got = client.tx(hash=res["hash"], prove=True)
    assert bytes.fromhex(got["tx"]) == tx
    assert got["height"] == res["height"]
    assert got["proof"] is not None


def test_broadcast_tx_sync_and_unconfirmed(node, client):
    res = client.broadcast_tx_sync(tx=b"sync-key=sync-val".hex())
    assert res["code"] == 0
    res2 = client.num_unconfirmed_txs()
    assert res2["n_txs"] >= 0  # may already be reaped


def test_block_and_blockchain_and_commit(node, client):
    assert wait_until(lambda: node.block_store.height() >= 2)
    res = client.block(height=1)
    assert res["block"]["header"]["height"] == 1
    info = client.blockchain(min_height=1, max_height=2)
    assert info["last_height"] >= 2
    assert len(info["block_metas"]) == 2
    cmt = client.commit(height=1)
    assert cmt["canonical_commit"] is True
    assert cmt["commit"] is not None


def test_validators_and_genesis_and_net_info(node, client):
    vals = client.validators()
    assert len(vals["validators"]["validators"]) == 1
    # historical form: the set that signed height 1 (light-client pairing
    # with /commit — docs/specification/light-client-protocol.md)
    assert wait_until(lambda: node.block_store.height() >= 1)
    hist = client.validators(height=1)
    assert hist["block_height"] == 1
    assert len(hist["validators"]["validators"]) == 1
    import pytest as _pytest

    with _pytest.raises(Exception):
        client.validators(height=10_000)
    gen = client.genesis()
    assert gen["genesis"]["chain_id"] == node.genesis_doc.chain_id
    ni = client.net_info()
    assert ni["listening"] is True


def test_dump_consensus_state(node, client):
    res = client.dump_consensus_state()
    assert res["round_state"]["height"] >= 1


def test_uri_transport(node, client):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{node.rpc_port()}/status", timeout=10
    ) as resp:
        body = json.loads(resp.read().decode())
    assert body["result"]["latest_block_height"] >= 1


def test_unknown_method_and_bad_params(node, client):
    with pytest.raises(RPCClientError, match="unknown RPC method"):
        client.call("no_such_method")
    with pytest.raises(RPCClientError, match="unknown parameter"):
        client.call("block", bogus=1)
    with pytest.raises(RPCClientError):
        client.block(height=10**9)


def test_websocket_subscription(node, client):
    ws = WSClient(f"127.0.0.1:{node.rpc_port()}")
    try:
        ws.subscribe("NewBlock")
        ev = ws.next_event(timeout=30)
        assert ev["event"] == "NewBlock"
        assert ev["data"]["block"]["header"]["height"] >= 1
        # RPC over the same websocket
        res = ws.call("status")
        assert res["latest_block_height"] >= 1
        ws.unsubscribe("NewBlock")
    finally:
        ws.close()


def test_unsafe_routes_gated(node, client):
    with pytest.raises(RPCClientError, match="unknown RPC method"):
        client.unsafe_flush_mempool()


def test_commit_missing_meta_is_rpc_error():
    """A height inside the valid range whose meta is missing (pruned /
    mid-write) must surface as RPCError, not AttributeError."""
    import pytest as _pytest

    from tendermint_tpu_torch.rpc.core.handlers import RPCError, commit

    class _Store:
        def height(self):
            return 5

        def base(self):
            return 1

        def load_block_meta(self, h):
            return None

    class _Ctx:
        block_store = _Store()

    with _pytest.raises(RPCError):
        commit(_Ctx(), 3)


def test_light_client_verifies_headers_and_txs(node, client):
    """rpc/light.py against a live node: bootstrap trust from genesis,
    advance through real heights, verify a header + tx inclusion proof,
    and reject tampering (docs/specification/light-client-protocol.md)."""
    from tendermint_tpu_torch.rpc.light import LightClient, LightClientError
    from tendermint_tpu_torch.types.tx import tx_hash

    # commit a tx so there's something to prove
    tx = b"light-key=light-value"
    res = client.broadcast_tx_commit(tx=tx.hex())
    tx_height = res["height"]
    assert wait_until(lambda: node.block_store.height() >= tx_height + 1)

    lc = LightClient.from_genesis(client)
    lc.advance(tx_height)
    assert lc.height == tx_height
    header = lc.verify_header(tx_height)
    assert header.height == tx_height

    # the tx's inclusion proof checks out against the verified header
    verified = lc.verify_tx(tx_hash(tx), header)
    assert bytes.fromhex(verified["tx"]) == tx

    # tampering: a wrong chain id must fail
    bad = LightClient.from_genesis(client)
    bad.chain_id = "not-the-chain"
    with pytest.raises(LightClientError):
        bad.verify_header(1)

    # tampering: a forged validator set must fail
    from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    forged = LightClient.from_genesis(client)
    forged.validators = ValidatorSet(
        [Validator.new(gen_priv_key_ed25519().pub_key(), 1)]
    )
    with pytest.raises(LightClientError):
        forged.verify_header(1)


def test_metrics_endpoint(node, client):
    m = client.metrics()
    assert m["consensus_height"] >= 1
    assert m["blockstore_height"] >= 1
    assert m["mempool_size"] >= 0
    assert "p2p_peers_outbound" in m and "p2p_peers_inbound" in m
    assert "gateway_verify_tpu_sigs" in m
    assert m["consensus_peer_msg_drops"] == 0  # healthy node drops nothing
    assert "gateway_hash_cpu_leaves" in m
    # the Hasher's streamed-transport gauges must surface through the
    # metrics RPC unconditionally (zeros off the devd route) — the
    # Verifier stream gauges only had client-side coverage, which let a
    # stats()-shape regression hide from the RPC surface
    for gauge in ("gateway_hash_stream_lanes", "gateway_hash_stream_batches",
                  "gateway_hash_stream_bytes_out", "gateway_hash_stream_trees",
                  "gateway_hash_stream_reconnects",
                  "gateway_hash_tx_root_cache_hits"):
        assert gauge in m, gauge
    assert all(isinstance(v, (int, float)) for v in m.values()), m


# the metrics RPC renders from the telemetry registry
# (node/telemetry.py). This is the COMPLETENESS contract — every
# subsystem's gauges present under their canonical <plane>_<name> on a
# real node — so a future wiring/rename regression fails here, loudly.
METRICS_REQUIRED_KEYS = (
    # consensus plane
    "consensus_height", "consensus_round", "consensus_step",
    "consensus_height_seconds_last", "consensus_height_seconds_max",
    "consensus_peer_msg_drops",
    # pipelined execution plane
    "consensus_pipeline_applies",
    "consensus_pipeline_join_wait_seconds",
    "consensus_pipeline_overlap_seconds",
    # big-committee vote plane
    "consensus_vote_batches", "consensus_vote_batched_sigs",
    "consensus_vote_singletons",
    # vote-gossip redundancy: the 2NxN before-number
    "consensus_vote_duplicates",
    # block store (+ prune accounting)
    "blockstore_height", "blockstore_base",
    "blockstore_pruned_heights_total", "blockstore_prune_runs",
    # retention coordinator: enabled/target/runs, per-plane
    # floors, per-plane disk gauges — stable whether or not [pruning]
    # is armed
    "pruning_enabled", "pruning_retain_blocks", "pruning_runs",
    "pruning_pruned_heights", "pruning_wal_chunks_pruned",
    "pruning_last_retain_height", "pruning_floor_operator",
    "pruning_disk_blockstore_bytes", "pruning_disk_wal_bytes",
    "pruning_disk_snapshots_bytes", "pruning_disk_total_bytes",
    # WAL durability plane (present once consensus started)
    "wal_format", "wal_records", "wal_fsyncs", "wal_pending",
    "wal_group_size", "wal_repairs", "wal_sync_age_s",
    # evidence + mempool (cache_dups: dup-flood shed counter)
    "evidence_count", "mempool_size", "mempool_cache_dups",
    # overload-control plane: lane depths + intake shed
    # accounting on the mempool, admission counters on the RPC edge,
    # and the load-shed ladder's level/score
    "mempool_lane_priority_size", "mempool_lane_default_size",
    "mempool_lane_bulk_size", "mempool_lane_full_rejects",
    "mempool_pool_full_rejects", "mempool_source_limit_rejects",
    "mempool_shed_writes_rejects", "mempool_sources",
    "rpc_inflight", "rpc_connections", "rpc_sheds",
    "rpc_deadline_rejects", "rpc_ws_clients", "rpc_ws_evictions",
    "rpc_ws_dropped_events",
    "node_overload_level", "node_overload_score",
    "node_overload_transitions",
    # p2p (adds the flat aggregates over the labeled
    # p2p_peer_* gossip families — the wedge signal on the legacy dict)
    "p2p_peers_outbound", "p2p_peers_inbound", "p2p_peers_dialing",
    "p2p_peer_send_failures", "p2p_peer_vote_gossip_picks",
    "p2p_peer_vote_gossip_sends", "p2p_peer_vote_gossip_send_failures",
    "p2p_peer_catchup_commits", "p2p_peer_vote_duplicates",
    # adversarial-tier defense accounting: hostile pressure
    # shed at the eclipse gates / admission handshake / framing
    # contract / mempool flood path
    "p2p_adversary_eclipse_dials_refused",
    "p2p_adversary_handshake_rejects",
    "p2p_adversary_frame_violations",
    "p2p_adversary_flood_txs_rejected",
    # tx-lifecycle tracing + flight recorder
    "txtrace_sampled", "txtrace_completed", "txtrace_active",
    "flightrec_events", "flightrec_dumps",
    # health plane: the /health verdict as flat gauges
    "node_health_status", "node_health_height_age_s",
    "node_health_checks_degraded", "node_health_checks_failing",
    # fast sync
    "fastsync_active", "fastsync_blocks_synced",
    "fastsync_rate_blocks_per_sec", "fastsync_apply_s",
    # statesync (reactor serves unconditionally, with the
    # adversarial-offerer ban counters by proven kind)
    "statesync_restore_active", "statesync_snapshots",
    "statesync_chunks_served", "statesync_chunk_failures",
    "statesync_peers_banned", "statesync_load_failures",
    "statesync_offerers_banned", "statesync_offerer_bans_forged",
    "statesync_offerer_bans_corrupt", "statesync_offerer_bans_stall",
    # horizon-aware catchup
    "fastsync_below_horizon_fallbacks",
    # gateway verify plane
    "gateway_verify_tpu_batches", "gateway_verify_tpu_sigs",
    "gateway_verify_cpu_sigs",
    # gateway hash plane
    "gateway_hash_tpu_part_batches", "gateway_hash_tpu_leaves",
    "gateway_hash_cpu_leaves", "gateway_hash_tx_root_cache_hits",
    "gateway_hash_batch_bytes", "gateway_hash_stream_batches",
    # sharded device plane: the flat aggregates over the
    # labeled gateway_endpoint_* families — stable in single-socket
    # mode (count=1) so the contract holds without a fleet
    "gateway_endpoints_count", "gateway_endpoints_healthy",
    "gateway_endpoints_dispatched_slices", "gateway_endpoints_stolen_slices",
    "gateway_endpoints_redispatches", "gateway_endpoints_outstanding",
)


def test_metrics_completeness_every_plane_present(node, client):
    m = client.metrics()
    missing = [k for k in METRICS_REQUIRED_KEYS if k not in m]
    assert not missing, f"metrics RPC lost gauges: {missing}"


PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?'
    r" (\+Inf|-Inf|[0-9.eE+-]+)$"
)


def test_prometheus_exposition_endpoint(node):
    """GET /metrics serves valid text exposition 0.0.4: >= 40 families
    spanning every plane, HELP/TYPE per family, every sample line
    parseable, histogram families present."""
    with urllib.request.urlopen(
        f"http://127.0.0.1:{node.rpc_port()}/metrics", timeout=10
    ) as resp:
        assert resp.headers["Content-Type"].startswith(
            "text/plain; version=0.0.4"
        )
        text = resp.read().decode()
    families: dict[str, str] = {}
    helps = set()
    for line in text.strip().splitlines():
        if line.startswith("# HELP "):
            helps.add(line.split()[2])
        elif line.startswith("# TYPE "):
            _h, _t, name, kind = line.split()
            families[name] = kind
        else:
            assert PROM_LINE.match(line), line
    assert len(families) >= 40, f"only {len(families)} families"
    assert set(families) <= helps, "family missing its HELP line"
    # one family per plane the acceptance bar names (statetree_*: the
    # kvstore app carries the authenticated tree, scrape-only)
    for fam in ("consensus_height", "wal_format", "gateway_verify_tpu_sigs",
                # the big-committee vote-plane counters
                "consensus_vote_batches", "consensus_vote_singletons",
                "gateway_hash_tpu_leaves", "gateway_breaker_state",
                "mempool_size", "statesync_snapshots", "fastsync_active",
                "p2p_peers_outbound", "statetree_size", "statetree_commits",
                # health verdict + the per-peer queue gauges
                "node_health_status", "node_health_height_age_s",
                "p2p_peer_send_queue", "p2p_peer_send_queue_high_water",
                "p2p_peer_last_recv_age_seconds",
                # tx-lifecycle sampling + flight recorder +
                # the vote-gossip redundancy number
                "txtrace_sampled", "flightrec_events",
                "consensus_vote_duplicates",
                # adversary-defense accounting on the node +
                # the WAN-shaping counters on the chaos fabric (all-zero
                # outside a chaos harness but the family set is stable)
                "p2p_adversary_eclipse_dials_refused",
                "p2p_adversary_handshake_rejects",
                "p2p_adversary_frame_violations",
                "p2p_adversary_flood_txs_rejected",
                "netfaults_wan_delays_applied", "netfaults_wan_loss_stalls",
                "netfaults_wan_bytes_shaped", "netfaults_wan_resets",
                "netfaults_links",
                # bounded-retention lifecycle + adversarial
                # statesync offerer accounting + horizon-aware catchup
                "blockstore_pruned_heights_total", "pruning_enabled",
                "pruning_retain_blocks", "pruning_disk_total_bytes",
                "pruning_floor_operator",
                "statesync_offerers_banned",
                "statesync_offerer_bans_forged",
                "statesync_offerer_bans_corrupt",
                "statesync_offerer_bans_stall",
                "fastsync_below_horizon_fallbacks",
                # per-endpoint device-plane gauges (labeled by
                # endpoint socket; one child per configured endpoint even
                # in single-socket mode)
                "gateway_endpoint_outstanding",
                "gateway_endpoint_breaker_state",
                "gateway_endpoint_sigs_per_s",
                # overload-control plane — RPC admission,
                # per-lane mempool depth, and the load-shed ladder
                "rpc_inflight", "rpc_ws_clients",
                "node_overload_level", "node_overload_score",
                "mempool_lane_depth", "mempool_lane_bytes"):
        assert fam in families, fam
        assert families[fam] == "gauge"
    # the secret-connection transport counters, incl. the
    # oversized-frame refusal the adversarial tier asserts on
    for fam in ("p2p_secretconn_handshakes_total",
                "p2p_secretconn_handshake_timeouts_total",
                "p2p_secretconn_auth_failures_total",
                "p2p_secretconn_oversized_frames_total"):
        assert families.get(fam) == "counter", fam
    # the labeled per-peer gossip families are present (and
    # typed) from the first scrape even with zero peers — family
    # materialization is what makes churned series collapse instead of
    # appearing late
    for fam in ("p2p_peer_send_bytes_total", "p2p_peer_recv_bytes_total",
                "p2p_peer_send_msgs_total", "p2p_peer_recv_msgs_total",
                "p2p_peer_send_failures_total",
                "p2p_peer_vote_gossip_picks_total",
                "p2p_peer_vote_gossip_sends_total",
                "p2p_peer_vote_gossip_send_failures_total",
                "p2p_peer_catchup_commits_total",
                "p2p_peer_vote_duplicates_total",
                # per-endpoint dispatch accounting on the
                # sharded device plane
                "gateway_endpoint_dispatched_slices_total",
                "gateway_endpoint_stolen_slices_total",
                "gateway_endpoint_redispatches_total",
                # shed accounting by reason/lane + slow-WS
                # eviction counters
                "rpc_shed_total", "ws_evictions_total",
                "ws_dropped_events_total", "mempool_lane_full_total"):
        assert families.get(fam) == "counter", fam
    # the latency-distribution instruments render as real histograms
    for fam in ("devd_stream_chunk_seconds", "devd_single_shot_seconds",
                "wal_fsync_seconds", "wal_group_records",
                "gateway_hash_batch_seconds",
                # the execution-pipeline distributions
                "consensus_height_seconds", "pipeline_join_wait_seconds",
                "pipeline_overlap_seconds",
                # the vote micro-batch distribution
                "consensus_vote_verify_batch_seconds",
                # gossip-arrival distributions + per-peer RTT
                "consensus_quorum_seconds", "consensus_first_part_seconds",
                "p2p_peer_ping_rtt_seconds",
                # the tx-lifecycle distributions
                "tx_stage_seconds", "tx_commit_latency_seconds",
                "tx_visible_latency_seconds"):
        assert families.get(fam) == "histogram", fam
    # a live node has fsynced (group commit): the histogram has samples
    count = next(
        l for l in text.splitlines() if l.startswith("wal_fsync_seconds_count")
    )
    assert float(count.rsplit(" ", 1)[1]) >= 1


def test_consensus_trace_rpc_segments_sum_to_wall(node, client):
    """consensus_trace reconstructs a committed height's wall time into
    named segments that sum to within 5% of the height's wall clock,
    with device-vs-CPU attribution attached."""
    assert wait_until(lambda: node.block_store.height() >= 2)
    traces = client.consensus_trace(last=5)["traces"]
    assert traces, "no completed heights traced"
    heights = [t["height"] for t in traces]
    assert heights == sorted(heights, reverse=True), "newest first"
    for t in traces:
        assert t["segments"], t
        total = sum(t["segments"].values())
        tol = max(0.05 * t["wall_s"], 0.005)  # floor for sub-ms heights
        assert abs(total - t["wall_s"]) <= tol, (total, t["wall_s"])
        # the commit machinery segments exist on every committed height.
        # With the pipelined execution plane (the default) the apply runs
        # on the executor and is attributed to the height it OVERLAPS as
        # the overlap_apply_s aux note — the lowest traced height carries
        # neither (its apply credited to its successor)
        for seg in ("commit", "block_save"):
            assert seg in t["segments"], t["segments"]
        if t["height"] > min(heights):
            assert (
                "apply" in t["segments"] or "overlap_apply_s" in t["aux"]
            ), t
        dev = t["device"]
        for k in ("verify_tpu_sigs", "verify_cpu_sigs",
                  "hash_tpu_leaves", "hash_cpu_leaves"):
            assert k in dev, dev
        # CPU-route node: breaker not engaged, work attributed to CPU
        assert dev["breaker_state_end"] == -1
    # a single-validator CPU node verifies its own precommits on CPU
    assert any(
        t["device"]["verify_cpu_sigs"] > 0 or t["device"]["hash_cpu_leaves"] > 0
        for t in traces
    )
    # the operator CLI renders the same traces without raising, as the JAX
    # package's renders them
    import io

    from tendermint_tpu.ops.trace import render as jrender
    from tendermint_tpu_torch.ops.trace import render

    buf, jbuf = io.StringIO(), io.StringIO()
    render(traces, out=buf)
    jrender(traces, out=jbuf)
    assert f"height {heights[0]}" in buf.getvalue()
    assert buf.getvalue() == jbuf.getvalue()


def test_consensus_trace_carries_gossip_arrivals(node, client):
    """every committed height's trace carries wall-clock
    gossip arrival marks in causal order — the raw material the fleet
    aggregator joins across nodes."""
    assert wait_until(lambda: node.block_store.height() >= 2)
    traces = client.consensus_trace(last=3)["traces"]
    assert traces
    for t in traces:
        arr = t["arrivals"]
        # a sole validator self-delivers its proposal: every mark exists
        for key in ("proposal", "first_block_part", "prevote_quorum",
                    "precommit_quorum", "commit"):
            assert key in arr, (key, arr)
        assert t["started_at"] <= arr["first_block_part"] + 1e-6
        assert arr["first_block_part"] <= arr["prevote_quorum"] + 1e-6
        assert arr["prevote_quorum"] <= arr["precommit_quorum"] + 1e-6
        assert arr["precommit_quorum"] <= arr["commit"] + 1e-6
        assert arr["commit"] <= t["completed_at"] + 1e-6


def test_health_endpoint_contract(node, client):
    """GET /health (node/health.py): a live committing node is
    ok with every check reported machine-readably, and the same verdict
    rides the flat node_health_* gauges."""
    assert wait_until(lambda: node.block_store.height() >= 1)
    with urllib.request.urlopen(
        f"http://127.0.0.1:{node.rpc_port()}/health", timeout=10
    ) as resp:
        assert resp.status == 200
        body = json.loads(resp.read().decode())
    assert body["status"] == "ok" and body["code"] == 0
    for check in ("height_age", "peers", "breaker", "wal", "pipeline",
                  "mempool"):
        assert check in body["checks"], body["checks"]
        assert body["checks"][check]["status"] in ("ok", "degraded")
    assert body["checks"]["height_age"]["age_s"] >= 0
    assert body["checks"]["wal"]["open"] is True
    assert body["checks"]["pipeline"]["poisoned"] is False
    m = client.metrics()
    assert m["node_health_status"] == 0
    assert m["node_health_checks_failing"] == 0


def test_health_thresholds_flip_degraded(node, client, monkeypatch):
    """The env-knob thresholds govern the verdict live (the netchaos
    tier tightens them the same way): an impossible height-age budget
    flips the report to degraded, then failing — and the flat gauge
    follows."""
    from tendermint_tpu_torch.node.health import health_report

    monkeypatch.setenv("TENDERMINT_HEALTH_HEIGHT_AGE_DEGRADED_S", "0")
    monkeypatch.setenv("TENDERMINT_HEALTH_HEIGHT_AGE_FAILING_S", "1e9")
    report = health_report(node)
    assert report["status"] == "degraded"
    assert report["checks"]["height_age"]["status"] == "degraded"
    assert client.metrics()["node_health_status"] == 1
    monkeypatch.setenv("TENDERMINT_HEALTH_HEIGHT_AGE_FAILING_S", "0")
    report = health_report(node)
    assert report["status"] == "failing"
    # ... and the endpoint answers 503 so k8s-style probes see it
    import urllib.error

    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{node.rpc_port()}/health", timeout=10
        )
        raise AssertionError("failing health must answer 503")
    except urllib.error.HTTPError as exc:
        assert exc.code == 503
        assert json.loads(exc.read().decode())["status"] == "failing"


def test_fleet_scrapes_single_node(node):
    """ops/fleet against a live (single) node: the aggregator
    reconstructs the per-height timeline purely from GET /metrics +
    consensus_trace + GET /health scrapes."""
    import io

    from tendermint_tpu.ops import fleet as jfleet
    from tendermint_tpu_torch.ops import fleet

    assert wait_until(lambda: node.block_store.height() >= 2)
    url = f"127.0.0.1:{node.rpc_port()}"
    snapshot = fleet.collect([url], last=5)
    assert "error" not in snapshot[url], snapshot[url].get("error")
    assert snapshot[url]["health"]["status"] in ("ok", "degraded")
    rows = fleet.build_timeline(
        {u: e["traces"] for u, e in snapshot.items()}, last=5
    )
    assert rows and rows[0]["height"] >= rows[-1]["height"]
    for r in rows:
        assert r["nodes_reporting"] == 1
        assert r["precommit_quorum_s_max"] is not None
        assert r["precommit_quorum_s_max"] >= 0
        # one reporter: no cross-node spreads
        assert r["commit_skew_s"] is None
    summary = fleet.fleet_summary(snapshot)
    assert summary[url]["height"] >= 2
    buf = io.StringIO()
    fleet.render(snapshot, rows, out=buf)
    assert "health ok" in buf.getvalue() or "health degraded" in buf.getvalue()
    # the JAX package's timeline, summary and render of the same scrape
    jrows = jfleet.build_timeline({u: e["traces"] for u, e in snapshot.items()}, last=5)
    assert jrows == rows
    assert jfleet.fleet_summary(snapshot) == summary
    jbuf = io.StringIO()
    jfleet.render(snapshot, jrows, out=jbuf)
    assert jbuf.getvalue() == buf.getvalue()
    text = urllib.request.urlopen(f"http://{url}/metrics", timeout=10).read().decode()
    assert jfleet.parse_prometheus(text) == fleet.parse_prometheus(text)


def test_tx_trace_rpc_spans_sum_to_commit_latency(node, client):
    """A committed tx's lifecycle trace is served by the
    tx_trace RPC with its per-stage spans summing (within 10%, the
    acceptance bar — they telescope, so this guards the stamp sites) to
    the measured end-to-end commit latency, and the cross-node CLI
    renders it."""
    tx = b"txtrace-rpc-key=txtrace-rpc-val"
    res = client.broadcast_tx_commit(tx=tx.hex())
    assert res["deliver_tx"]["code"] == 0
    want_hash = res["hash"]

    def traced():
        return [
            t for t in client.tx_trace(last=50)["traces"]
            if t["hash"] == want_hash
        ]

    assert wait_until(lambda: traced(), timeout=30), (
        client.tx_trace(last=50)
    )
    [t] = traced()
    assert t["outcome"] == "committed"
    assert t["height"] == res["height"]
    assert t["source"] == "rpc"
    # the lifecycle stages a sole-validator commit must cross
    for stage in ("rpc_ingress", "mempool_admit", "proposal",
                  "block_commit", "apply", "event_delivery"):
        assert stage in t["stages"], (stage, t["stages"])
    # stamped instants are causally ordered
    from tendermint_tpu_torch.libs.txtrace import STAGES

    stamped = [t["stages"][s] for s in STAGES if s in t["stages"]]
    assert stamped == sorted(stamped)
    # spans through block_commit sum to the commit latency within 10%
    assert t["commit_latency_s"] is not None and t["commit_latency_s"] > 0
    commit_idx = STAGES.index("block_commit")
    span_sum = sum(
        v for k, v in t["spans"].items() if STAGES.index(k) <= commit_idx
    )
    assert abs(span_sum - t["commit_latency_s"]) <= max(
        0.10 * t["commit_latency_s"], 1e-4
    ), (span_sum, t["commit_latency_s"])
    assert t["visible_latency_s"] >= t["commit_latency_s"]
    # hash filter returns exactly this tx
    only = client.tx_trace(hash=want_hash, last=50)
    assert [x["hash"] for x in only["traces"]] == [want_hash]
    # the cross-node joiner + renderer work against the live scrape
    import io

    from tendermint_tpu.ops import txtrace as jops_txtrace
    from tendermint_tpu_torch.ops import txtrace as ops_txtrace

    url = f"127.0.0.1:{node.rpc_port()}"
    snapshot = ops_txtrace.collect_txtraces([url], tx_hash=want_hash)
    rows = ops_txtrace.join_tx_timelines(snapshot)
    assert len(rows) == 1 and rows[0]["committed"]
    assert rows[0]["submitted_on"] == url
    buf = io.StringIO()
    ops_txtrace.render(rows, out=buf)
    assert f"committed @h={res['height']}" in buf.getvalue()
    # the JAX package's join and render of the same scrape
    jrows = jops_txtrace.join_tx_timelines(snapshot)
    assert jrows == rows
    jbuf = io.StringIO()
    jops_txtrace.render(jrows, out=jbuf)
    assert jbuf.getvalue() == buf.getvalue()


def test_debug_flight_endpoint(node, client):
    """GET /debug/flight serves the live event ring: step transitions
    and WAL endheight marks from real commits, newest events carrying
    the current chain position."""
    assert wait_until(lambda: node.block_store.height() >= 2)
    with urllib.request.urlopen(
        f"http://127.0.0.1:{node.rpc_port()}/debug/flight", timeout=10
    ) as resp:
        body = json.loads(resp.read().decode())
    assert body["enabled"] is True
    assert body["recorded_total"] >= len(body["events"]) >= 1
    kinds = {e["kind"] for e in body["events"]}
    assert "step" in kinds and "wal_endheight" in kinds
    ts = [e["t"] for e in body["events"]]
    assert ts == sorted(ts)
    steps = [e for e in body["events"] if e["kind"] == "step"]
    assert steps[-1]["height"] >= node.block_store.height() - 1


def test_debug_stacks_endpoint(node):
    """GET /debug/stacks: every live thread with a readable stack — the
    consensus receive routine must be among them (the wedge-triage
    read)."""
    with urllib.request.urlopen(
        f"http://127.0.0.1:{node.rpc_port()}/debug/stacks", timeout=10
    ) as resp:
        body = json.loads(resp.read().decode())
    assert body["count"] >= 3
    names = {t["name"] for t in body["threads"]}
    assert any(n.startswith("cs.receiveRoutine") for n in names), names
    for t in body["threads"]:
        assert isinstance(t["stack"], list) and t["stack"]


def test_debug_queues_endpoint(node):
    """GET /debug/queues: the backlog view — consensus input queues,
    pipeline executor, mempool, vote batcher — every section present
    and numeric on a live node."""
    import urllib.error

    with urllib.request.urlopen(
        f"http://127.0.0.1:{node.rpc_port()}/debug/queues", timeout=10
    ) as resp:
        body = json.loads(resp.read().decode())
    for section in ("consensus", "pipeline", "vote_batcher", "mempool",
                    "p2p"):
        assert section in body, body.keys()
        assert "error" not in body[section], body[section]
    assert body["consensus"]["height"] >= 1
    assert body["consensus"]["inputs"] >= 0
    assert body["pipeline"]["poisoned"] is False
    assert body["mempool"]["size"] >= 0
    # unknown debug endpoints 404, not 500
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(
            f"http://127.0.0.1:{node.rpc_port()}/debug/nope", timeout=10
        )
    assert exc_info.value.code == 404
