"""Node telemetry wiring: THE canonical ``<plane>_<name>`` metric map.

Every gauge the node exports — through the legacy ``metrics`` JSON RPC
(flat dict) AND the Prometheus ``GET /metrics`` endpoint — is wired
here, in one place, with DIRECT attribute reads: a renamed field on any
producer object raises at collect time instead of silently exporting a
stale default (no ``getattr(..., 0.0)`` guards, no ``setdefault``
collisions).

Canonical plane prefixes (full catalog: docs/observability.md):

    consensus_*        ConsensusState position + liveness gauges
    blockstore_*       BlockStore head/base + prune accounting
    pruning_*          retention coordinator (node/retention.py):
                       enabled/target/runs, per-plane retention floors,
                       per-plane disk gauges
    wal_*              consensus WAL durability gauges (after start)
    evidence_*         duplicate-vote evidence pool
    mempool_*          pool depth + sig-gate accounting
    p2p_*              switch peer counts + per-peer gossip aggregates
    p2p_peer_*         labeled per-peer/per-channel families
                       (p2p/telemetry.py; node-registry-scoped, so two
                       in-process nodes keep separate series)
    node_health_*      health verdict (node/health.py): status
                       0 ok / 1 degraded / 2 failing + liveness age
    txtrace_*          tx-lifecycle sampling counters
                       (libs/txtrace.py; the per-stage distributions are
                       the tx_stage_seconds / tx_commit_latency_seconds /
                       tx_visible_latency_seconds histograms)
    flightrec_*        black-box recorder ring/dump accounting
                       (node/flightrec.py; the ring itself is
                       GET /debug/flight)
    fastsync_*         BlockchainReactor progress + stage seconds
    statesync_*        reactor serving/restore + producer cadence (incl.
                       the delta counters)
    statetree_*        authenticated app-state tree commit/hash shape
                       (scrape-only; present when the app carries one)
    gateway_verify_*   Verifier counters (+ stream/breaker/faults on devd)
    gateway_hash_*     Hasher counters (+ stream/breaker/faults on devd)
    gateway_breaker_*  the shared circuit breaker, every route (scrape-only)

plus the process-wide instruments the default registry carries
(devd_stream_chunk_seconds / devd_single_shot_seconds histograms,
wal_fsync_seconds / wal_group_records, mempool_sig_gate_batch_seconds,
gateway_hash_batch_seconds, the execution-pipeline histograms
consensus_height_seconds / pipeline_join_wait_seconds /
pipeline_overlap_seconds, the vote-plane histogram
consensus_vote_verify_batch_seconds, faults_*, p2p_secretconn_*
transport counters, netfaults_* network-chaos aggregates).

``legacy=True`` producers make up the byte-compatible metrics-RPC dict;
``legacy=False`` ones are scrape-only, so the legacy flat key set never
drifts.
"""

from __future__ import annotations

from tendermint_tpu_torch.libs import telemetry
from tendermint_tpu_torch.ops import gateway


def build_registry(node) -> telemetry.Registry:
    """Wire `node`'s subsystems into a Registry chained to the
    process-wide default (each node in a test process keeps its own
    producer table; instruments are shared)."""
    # materialize the process-wide instrument families up front so a
    # scrape's family set is STABLE from the first height: the devd
    # latency histograms otherwise appear only after the first devd op,
    # and the faults_* producer only once ops/faults is imported (it
    # registers itself at import)
    from tendermint_tpu_torch import devd
    from tendermint_tpu_torch.consensus import pipeline as cpipeline
    from tendermint_tpu_torch.consensus import trace as ctrace
    from tendermint_tpu_torch.consensus import vote_batcher as cvb
    from tendermint_tpu_torch.ops import faults  # noqa: F401 — import = register
    from tendermint_tpu_torch.ops import netfaults  # noqa: F401 — import =
    # register: the scrape-only netfaults_* family set (incl. the
    # netfaults_wan_* WAN-shaping counters) is stable from the
    # first scrape, all-zero outside a chaos harness
    from tendermint_tpu_torch.p2p import secret_connection
    from tendermint_tpu_torch.p2p import telemetry as p2p_telemetry

    devd._latency_hists()
    secret_connection._counters()
    cpipeline.pipeline_hists()
    cvb.vote_batch_hists()

    reg = telemetry.Registry(parent=telemetry.default_registry())
    cs = node.consensus_state

    # the per-peer p2p families and the quorum-formation
    # histograms live on the NODE registry — each in-process node keeps
    # its own series (the netchaos harness runs four nodes per process),
    # and a scrape's family set is stable from the first height. The
    # switch hands the registry to every admitted peer; the trace
    # recorder feeds the arrival histograms at each finish().
    peer_fams = p2p_telemetry.peer_metrics(reg)
    ctrace.arrival_hists(reg)
    node.sw.metrics_registry = reg
    cs.trace.metrics_registry = reg

    # the tx-lifecycle histograms (tx_stage_seconds{stage} +
    # the two end-to-end latencies) live on the NODE registry like the
    # per-peer families, materialized now for a stable family set
    from tendermint_tpu_torch.libs import txtrace as _txtrace

    _txtrace.txtrace_hists(reg)
    node.txtrace.metrics_registry = reg

    def consensus() -> dict:
        rs = cs.get_round_state()
        return {
            "height": rs.height,
            "round": rs.round_,
            "step": int(rs.step),
            # liveness: wall seconds per committed height —
            # the "did a round stall behind a sick device plane" signal
            "height_seconds_last": round(cs.height_seconds_last, 3),
            "height_seconds_max": round(cs.height_seconds_max, 3),
            "peer_msg_drops": cs.peer_msg_drops,
            # pipelined execution plane: deferred applies
            # taken, the last join wait the consensus thread paid, and
            # the last apply span hidden under the next height (full
            # distributions: the pipeline_join_wait_seconds /
            # pipeline_overlap_seconds histograms on GET /metrics)
            "pipeline_applies": cs.pipeline_applies,
            "pipeline_serial_commits": cs.pipeline_serial_commits,
            "pipeline_join_wait_seconds": round(cs.pipeline_join_wait_last, 6),
            "pipeline_overlap_seconds": round(cs.pipeline_overlap_last, 6),
            # big-committee vote plane: micro-batches the
            # receive routine dispatched, the signature lanes they
            # carried, and the verdicts that fell to the one-sig path
            # (latency distribution: consensus_vote_verify_batch_seconds
            # on GET /metrics)
            "vote_batches": cs.vote_batcher.batches,
            "vote_batched_sigs": cs.vote_batcher.batched_sigs,
            "vote_singletons": cs.vote_batcher.singletons,
            # gossiped votes screened as already-seen — the
            # 2NxN redundancy before-number for the gossip-dedup work
            # (per-peer attribution: p2p_peer_vote_duplicates_total)
            "vote_duplicates": cs.vote_duplicates,
            # gossiped votes genuinely added — the ratio
            # vote_duplicates/vote_accepted is the duplicate-vote ratio
            # BENCH_r20 reads off scrapes — plus the dedup plane's own
            # accounting: HasVotes that landed in a peer mirror, and
            # HasBlockPart announcements sent/applied
            "vote_accepted": cs.vote_accepted,
            "gossip_has_votes_applied":
                node.consensus_reactor.has_votes_applied,
            "gossip_part_announces_sent":
                node.consensus_reactor.part_announces_sent,
            "gossip_part_announces_applied":
                node.consensus_reactor.part_announces_applied,
        }

    reg.register_producer("consensus", consensus)

    reg.register_producer(
        "blockstore",
        lambda: {
            "height": node.block_store.height(),
            "base": node.block_store.base(),
            # retention accounting — base > 1 says "pruned or
            # restored"; this says how much and how often
            "pruned_heights_total": node.block_store.pruned_heights,
            "prune_runs": node.block_store.prune_runs,
        },
    )

    # the retention coordinator — enabled/target/runs, the
    # per-plane floors of the last pass (WHICH plane pinned retention),
    # and per-plane disk gauges (block store / WAL / snapshots; cached a
    # few seconds so scrapes stay cheap). Always registered — the family
    # set is stable whether or not [pruning] is armed.
    reg.register_producer("pruning", node.retention.stats)

    def wal() -> dict:
        # host durability plane: group-commit shape + repair
        # history. The WAL opens at consensus start, so the wal_* keys
        # appear once the node runs (same presence rule as pre-registry)
        w = cs.wal
        return {} if w is None else w.stats()

    reg.register_producer("wal", wal)

    reg.register_producer(
        "evidence", lambda: {"count": cs.evidence_pool.size()}
    )

    def mempool() -> dict:
        # cache_dups: already-seen txs shed at the dedup cache — under
        # a duplicate flood this is the shed counter; on a quiet net it
        # counts benign gossip redundancy
        mp = node.mempool
        out = {
            "size": mp.size(),
            "cache_dups": mp.cache_dups,
            # priority lanes + intake sheds (docs/serving.md);
            # the labeled mempool_lane_* families carry the same data
            # per lane — these flats are the legacy-RPC/fleet view
            "lane_priority_size": mp.lane_counts["priority"],
            "lane_default_size": mp.lane_counts["default"],
            "lane_bulk_size": mp.lane_counts["bulk"],
            "lane_full_rejects": sum(mp.lane_full.values()),
            "pool_full_rejects": mp.pool_full_rejects,
            "source_limit_rejects": mp.source_limited,
            "shed_writes_rejects": mp.shed_writes,
            "sources": len(mp.source_counts),
        }
        batcher = mp.sig_batcher
        if batcher is not None:
            out["sig_gate_dropped"] = batcher.dropped
            out["sig_gate_delivered"] = batcher.delivered
            out["sig_gate_fail_open"] = batcher.fail_open
            out["sig_gate_bad_sigs"] = batcher.bad_sigs
        return out

    reg.register_producer("mempool", mempool)

    # -- overload-control plane (docs/serving.md) -----------------
    # flat views: the ingress admission counters and the ladder position
    reg.register_producer("rpc", node.rpc_admission.snapshot)
    reg.register_producer("node_overload", node.overload.snapshot)

    # collect-time refresh of the per-peer staleness gauge: an age only
    # means something at read time, so every scrape sets the labeled
    # children for the CURRENT peer set before instruments are gathered.
    # Disconnected peers must keep AGING, not freeze at their last live
    # value (the staleness alert fires exactly when a peer dies): the
    # last recv instant of every peer ever refreshed is remembered and
    # dead peers' series keep growing from it; churn-evicted peers have
    # their series REMOVED from the family (a frozen series is the bug
    # this exists to prevent). The RPC server is threading — concurrent
    # scrapes share the table under a lock.
    import threading as _threading
    import time as _time

    last_recv_instants: dict[str, float] = {}
    ages_mtx = _threading.Lock()

    def refresh_peer_ages() -> None:
        age_gauge = peer_fams["last_recv_age"]
        now = _time.monotonic()
        live = []
        for peer in node.sw.peers.list():
            try:
                live.append((peer.id(), now - peer.last_recv_age()))
            except Exception:  # noqa: BLE001 — a peer mid-teardown must
                # not fail the whole scrape
                pass
        with ages_mtx:
            for pid, instant in live:
                last_recv_instants[pid] = instant
            if len(last_recv_instants) > 4 * telemetry.family_max_series(
                age_gauge.name
            ):
                # churn bound: evict the stalest remembered peers AND
                # drop their series so they vanish from the scrape
                # instead of freezing at the last written age
                for pid in sorted(last_recv_instants,
                                  key=last_recv_instants.get)[
                        : len(last_recv_instants) // 2]:
                    del last_recv_instants[pid]
                    age_gauge.remove_labels(peer=pid)
                    # the dead peer's point-in-time queue gauges must
                    # vanish too, not freeze (counters stay: a stopped
                    # counter is correct Prometheus semantics)
                    for d in node.sw.ch_descs:
                        ch = f"{d.id:#x}"
                        peer_fams["send_queue"].remove_labels(
                            peer=pid, channel=ch)
                        peer_fams["send_queue_high_water"].remove_labels(
                            peer=pid, channel=ch)
            snapshot = list(last_recv_instants.items())
        for pid, instant in snapshot:
            age_gauge.labels(peer=pid).set(round(now - instant, 3))

    reg.on_collect(refresh_peer_ages)

    def p2p() -> dict:
        outbound, inbound, dialing = node.sw.num_peers()
        out = {
            "peers_outbound": outbound,
            "peers_inbound": inbound,
            "peers_dialing": dialing,
        }
        # flat aggregates over the labeled gossip families
        # (sums across peers, the _other overflow series included) so
        # the legacy RPC sees the wedge signal too
        out.update(p2p_telemetry.family_totals(reg))
        # defense-side adversary accounting — what hostile
        # pressure this node shed (flat on both surfaces so the
        # adversarial scenario matrix asserts on scrapes alone)
        adv = node.sw.adversary_stats()
        out["adversary_eclipse_dials_refused"] = (
            adv["ip_range_refused"] + adv["max_peers_refused"]
        )
        out["adversary_handshake_rejects"] = adv["handshake_rejects"]
        out["adversary_frame_violations"] = adv["frame_violations"]
        # commit-schedule disagreements refused at handshake —
        # THE misconfiguration alarm during a rolling upgrade (a nonzero
        # value names a peer running a different genesis schedule;
        # docs/upgrade.md)
        out["adversary_schedule_refused"] = adv["schedule_refused"]
        # gate-level sheds only: bad signatures are unambiguously
        # hostile, saturation drops are shed load. Dedup-cache hits
        # deliberately do NOT count here — honest gossip re-delivery
        # and client resubmits hit the cache too, and an operator
        # alerting on an adversary_* family must not page on normal
        # redundancy (the dup-storm arm reads mempool_cache_dups)
        flood = 0
        batcher = node.mempool.sig_batcher
        if batcher is not None:
            flood = batcher.bad_sigs + batcher.dropped
        out["adversary_flood_txs_rejected"] = flood
        # address-book shape — size/new/old, churn counters,
        # and the group-domination containment gauge (max_group), so the
        # pex_churn scenario asserts eviction off scrapes alone
        for k, v in node.addr_book.stats().items():
            out[f"addrbook_{k}"] = v
        return out

    reg.register_producer("p2p", p2p)

    # the upgrade-at-height plane — where this node stands
    # relative to the scheduled commit-format flip, and every aggregate-
    # commit verdict it has rendered. upgrade_height is 0 when no flip is
    # scheduled; upgrade_active flips 0 -> 1 when the NEXT block this
    # node commits will carry an aggregate last-commit (the operator's
    # "has the cutover happened HERE yet" gauge, docs/upgrade.md).
    def upgrade() -> dict:
        gd = node.genesis_doc
        next_height = max(node.block_store.height(), 0) + 1
        return {
            "height": gd.upgrade_height,
            "active": 1 if gd.aggregate_commits_at(next_height) else 0,
            # consensus-thread verdicts: commit proofs accepted from
            # catchup gossip, forged/stale/sub-quorum refused, and
            # proposals this node built with an aggregate last-commit
            "agg_commit_proofs": cs.agg_commit_proofs,
            "agg_commit_rejects": cs.agg_commit_rejects,
            "agg_commits_proposed": cs.agg_commits_proposed,
            # peer-thread accounting: whole aggregates shipped to lagging
            # peers, and forged ones screened before they could enqueue
            "agg_commits_sent": node.consensus_reactor.agg_commits_sent,
            "agg_commits_rejected":
                node.consensus_reactor.agg_commits_rejected,
        }

    reg.register_producer("upgrade", upgrade)

    # the health verdict as flat gauges on both surfaces —
    # alerting keys off node_health_status without the JSON endpoint
    from tendermint_tpu_torch.node.health import health_gauges

    reg.register_producer("node_health", lambda: health_gauges(node))

    # tx-lifecycle sampling counters + the flight recorder's
    # ring/dump accounting (the distributions ride the histograms above;
    # the event ring itself is GET /debug/flight)
    reg.register_producer("txtrace", node.txtrace.stats)
    reg.register_producer("flightrec", node.flightrec.stats)

    def fastsync() -> dict:
        bc = node.blockchain_reactor
        out = {
            "active": int(bool(bc.fast_sync)),
            "blocks_synced": bc.blocks_synced,
            "rate_blocks_per_sec": round(bc.sync_rate, 3),
            # times the catchup path detected the network's
            # retained horizon above its target and armed statesync
            "below_horizon_fallbacks": bc.below_horizon_fallbacks,
        }
        for stage, secs in bc.stage_s.items():
            out[f"{stage}_s"] = round(secs, 3)
        return out

    reg.register_producer("fastsync", fastsync)

    def statesync() -> dict:
        # reactor owns the store gauges; the producer exports only its
        # own cadence keys (statesync/producer.py) — collision-free by
        # construction, so a plain merge is safe
        out = dict(node.statesync_reactor.stats())
        if node.snapshot_producer is not None:
            out.update(node.snapshot_producer.stats())
        return out

    reg.register_producer("statesync", statesync)

    # authenticated state tree: commit/hashing shape of the
    # app's commitment tree. Scrape-only — the legacy flat RPC key set
    # stays frozen; apps without a tree simply have no producer here.
    # Read app.tree per collect: a snapshot restore rebinds the tree
    # instance, and a producer pinned to the old one would freeze
    if node.app_state_tree_app is not None:
        reg.register_producer(
            "statetree",
            lambda: node.app_state_tree_app.tree.stats(),
            legacy=False,
        )

    # device plane: tpu_sigs moving is how an operator confirms the
    # device path is live; stream_*/breaker_*/faults_* fold in on the
    # devd route (ops/gateway stats contracts)
    reg.register_producer("gateway_verify", node.verifier.stats)
    reg.register_producer("gateway_hash", node.hasher.stats)

    # the shared breaker, exported UNCONDITIONALLY for scrapers (on
    # non-devd routes the verifier/hasher stats omit it, but a scrape
    # must always show the degradation plane). Scrape-only: adding it to
    # the flat RPC would change the legacy key set.
    reg.register_producer(
        "gateway", lambda: gateway.devd_breaker().stats(), legacy=False
    )

    # the sharded device plane — flat fleet aggregates on both
    # surfaces (stable key set even in single-socket mode: count=1,
    # dispatch counters at zero), plus labeled per-endpoint families
    # refreshed at collect time like the peer ages above. Counters carry
    # the repo's _total suffix; the dispatcher keeps monotonic totals
    # per endpoint, so children advance by delta-inc (an endpoint reset
    # — devd_shard.reset() in tests — restarts at zero, and a negative
    # delta is simply not applied: Prometheus counter semantics).
    from tendermint_tpu_torch.ops import devd_shard

    reg.register_producer("gateway_endpoints", devd_shard.plane_stats)

    ep_gauges = {
        "outstanding": reg.gauge(
            "gateway_endpoint_outstanding",
            "Slices in flight on this devd endpoint right now",
            labelnames=("endpoint",),
        ),
        "breaker_state": reg.gauge(
            "gateway_endpoint_breaker_state",
            "Endpoint circuit breaker: 0 closed / 1 half-open / 2 open",
            labelnames=("endpoint",),
        ),
        "sigs_per_s": reg.gauge(
            "gateway_endpoint_sigs_per_s",
            "EWMA verify throughput of this endpoint (signature lanes/s)",
            labelnames=("endpoint",),
        ),
    }
    ep_counters = {
        "dispatched_slices": reg.counter(
            "gateway_endpoint_dispatched_slices_total",
            "Verify/hash slices this endpoint completed",
            labelnames=("endpoint",),
        ),
        "stolen_slices": reg.counter(
            "gateway_endpoint_stolen_slices_total",
            "Completed slices this endpoint stole from another's queue",
            labelnames=("endpoint",),
        ),
        "redispatches": reg.counter(
            "gateway_endpoint_redispatches_total",
            "Slices that failed on this endpoint and re-queued elsewhere",
            labelnames=("endpoint",),
        ),
    }

    def refresh_endpoint_families() -> None:
        for path, st in devd_shard.endpoint_stats().items():
            for key, fam in ep_gauges.items():
                fam.labels(endpoint=path).set(st[key])
            for key, fam in ep_counters.items():
                child = fam.labels(endpoint=path)
                delta = st[key] - child.value
                if delta > 0:
                    child.inc(delta)

    reg.on_collect(refresh_endpoint_families)

    # -- overload-control labeled families (docs/serving.md) -----
    # every shed is visible BY REASON on the scrape surface; the sources
    # are monotonic python ints, so children advance by delta-inc (the
    # endpoint-family pattern above).
    shed_counter = reg.counter(
        "rpc_shed_total",
        "RPC requests shed at the ingress admission edge, by reason",
        labelnames=("reason",),
    )
    ws_evictions_counter = reg.counter(
        "ws_evictions_total",
        "WS subscribers evicted for persistent send-queue overflow",
    )
    ws_dropped_counter = reg.counter(
        "ws_dropped_events_total",
        "Events dropped from slow WS subscribers' bounded send queues",
    )
    lane_depth_gauge = reg.gauge(
        "mempool_lane_depth",
        "Txs currently pooled in this priority lane",
        labelnames=("lane",),
    )
    lane_bytes_gauge = reg.gauge(
        "mempool_lane_bytes",
        "Bytes currently pooled in this priority lane",
        labelnames=("lane",),
    )
    lane_full_counter = reg.counter(
        "mempool_lane_full_total",
        "CheckTx-ok txs rejected because this lane was at its cap",
        labelnames=("lane",),
    )

    def refresh_overload_families() -> None:
        admission = node.rpc_admission
        for reason, total in admission.sheds.items():
            child = shed_counter.labels(reason=reason)
            delta = total - child.value
            if delta > 0:
                child.inc(delta)
        for plain, source in (
            (ws_evictions_counter, admission.ws_evictions),
            (ws_dropped_counter, admission.ws_dropped_events),
        ):
            child = plain.labels()
            delta = source - child.value
            if delta > 0:
                child.inc(delta)
        mp = node.mempool
        for lane in mp.lane_counts:
            lane_depth_gauge.labels(lane=lane).set(mp.lane_counts[lane])
            lane_bytes_gauge.labels(lane=lane).set(mp.lane_bytes[lane])
            child = lane_full_counter.labels(lane=lane)
            delta = mp.lane_full[lane] - child.value
            if delta > 0:
                child.inc(delta)

    reg.on_collect(refresh_overload_families)

    return reg


def build_replica_registry(replica) -> telemetry.Registry:
    """Wire a ReplicaDaemon into a Registry chained to the process-wide
    default: the replica_* follower/cache plane plus the same
    rpc_* ingress families a full node exports — one dashboard works for
    validators and replicas alike. Catalog rows: docs/observability.md."""
    reg = telemetry.Registry(parent=telemetry.default_registry())

    # flat views on both surfaces: replica_{height,lag_heights,cache_*,
    # proof_verify_failures,upstream_reconnects,served_reads_total,...}
    reg.register_producer("replica", replica.stats)
    reg.register_producer("rpc", replica.rpc_admission.snapshot)

    # labeled ingress families, delta-inc'd from the monotonic admission
    # counters at collect time (the node-registry pattern above)
    shed_counter = reg.counter(
        "rpc_shed_total",
        "RPC requests shed at the replica's admission edge, by reason",
        labelnames=("reason",),
    )
    ws_evictions_counter = reg.counter(
        "ws_evictions_total",
        "WS subscribers evicted for persistent send-queue overflow",
    )
    ws_dropped_counter = reg.counter(
        "ws_dropped_events_total",
        "Events dropped from slow WS subscribers' bounded send queues",
    )

    def refresh_replica_families() -> None:
        admission = replica.rpc_admission
        for reason, total in admission.sheds.items():
            child = shed_counter.labels(reason=reason)
            delta = total - child.value
            if delta > 0:
                child.inc(delta)
        for plain, source in (
            (ws_evictions_counter, admission.ws_evictions),
            (ws_dropped_counter, admission.ws_dropped_events),
        ):
            child = plain.labels()
            delta = source - child.value
            if delta > 0:
                child.inc(delta)

    reg.on_collect(refresh_replica_families)

    return reg
