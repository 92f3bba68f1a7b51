"""Node assembly (reference: node/node.go).

Wires the whole stack in the reference's order (node.go:113-307):
DBs -> block store -> state -> proxy app (started here, with ABCI
handshake, node.go:152-158) -> tx indexer -> event switch -> reactors
(blockchain, mempool, consensus) -> p2p switch (+ optional PEX) ->
on start: listener, dial seeds, RPC.

The crypto gateway (ops.gateway) is constructed once here and shared
by every verification site — consensus vote verify, commit verify in
block execution, and fast-sync — so all hot-path signatures flow through
one batching point.

The port's copy of the JAX package's `node/node.py`. The node takes the
gateway's defaults, `default_verifier()` and `default_hasher()`: the
serving device daemon, else the card. Where neither is there, building
the node raises `resolve_device`'s RuntimeError before it binds a port;
the JAX node would verify on the CPU. A caller that wants the CPU sets
`gateway._default_verifier` / `_default_hasher` to CPU instances first.
"""

from __future__ import annotations

import logging
import os

from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.libs.db import db_provider
from tendermint_tpu_torch.libs.events import EventSwitch
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.mempool import Mempool
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.ops import gateway
from tendermint_tpu_torch.types import tx as tx_types
from tendermint_tpu_torch.p2p import NodeInfo, PeerConfig, Switch
from tendermint_tpu_torch.p2p.addrbook import AddrBook
from tendermint_tpu_torch.p2p.conn import MConnConfig
from tendermint_tpu_torch.p2p.listener import Listener
from tendermint_tpu_torch.p2p.node_info import default_version
from tendermint_tpu_torch.p2p.pex import PEXReactor
from tendermint_tpu_torch.proxy.client_creator import default_client_creator
from tendermint_tpu_torch.proxy.multi_app_conn import AppConns
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.state.txindex import KVTxIndexer, NullTxIndexer
from tendermint_tpu_torch.types import GenesisDoc, PrivValidatorFS
from tendermint_tpu_torch.version import VERSION

logger = logging.getLogger("node")


def _parse_laddr(laddr: str) -> str:
    """'tcp://host:port' -> 'host:port'."""
    return laddr.split("://", 1)[-1]


class _FailoverRPC:
    """Spread the statesync light client's reads over every configured
    rpc_server: each call tries the servers in order and the first
    TRANSPORT-level success wins (a server that answers with bad data
    still fails verification upstream — failover is for dead endpoints,
    not lying ones)."""

    def __init__(self, clients: list):
        self._clients = clients

    def __getattr__(self, name):
        def call(**kw):
            last_exc = None
            for c in self._clients:
                try:
                    return getattr(c, name)(**kw)
                except Exception as exc:  # noqa: BLE001 — try the next server
                    last_exc = exc
            raise last_exc

        return call


def default_new_node(config) -> "Node":
    """node/node.go:74-110: load/generate privval, default app client."""
    priv_validator = PrivValidatorFS.load_or_generate(
        config.base.priv_validator_file()
    )
    return Node(
        config,
        priv_validator,
        default_client_creator(
            config.base.proxy_app, config.base.db_dir(), transport=config.base.abci
        ),
    )


class Node(BaseService):
    def __init__(self, config, priv_validator, client_creator, genesis_doc=None):
        super().__init__(name="node")
        self.config = config

        # -- DBs + genesis (node.go:121-146) ------------------------------
        backend = config.base.db_backend
        db_dir = config.base.db_dir()
        block_store_db = db_provider("blockstore", backend, db_dir)
        state_db = db_provider("state", backend, db_dir)
        self.block_store = BlockStore(block_store_db)
        if genesis_doc is None:
            genesis_doc = GenesisDoc.from_file(config.base.genesis_file())
        self.genesis_doc = genesis_doc
        self.priv_validator = priv_validator

        # -- TPU crypto gateway: one batching point for every verify site,
        # one hashing gateway for the part/tx Merkle hot paths. The tx-tree
        # hook routes every Data.hash (block build + validate) through the
        # batched kernel (ref types/tx.go:33-46).
        # [device] config feeds the endpoint list BEFORE the gateway
        # resolves its kernel (the verifier's devd detection and the
        # sharded dispatcher both read the env). The env var wins when
        # already set — it is the operator's per-process override.
        dev_cfg = getattr(config, "device", None)
        if dev_cfg is not None and dev_cfg.socks and \
                not os.environ.get("TENDERMINT_DEVD_SOCKS"):
            os.environ["TENDERMINT_DEVD_SOCKS"] = dev_cfg.socks
        from tendermint_tpu_torch.ops import devd_shard

        if devd_shard.enabled():
            logger.info(
                "sharded device plane: %d devd endpoints (%s)",
                len(devd_shard.endpoint_paths()),
                ", ".join(devd_shard.endpoint_paths()),
            )
        self.verifier = gateway.default_verifier()
        self.hasher = gateway.default_hasher()
        tx_types.set_batch_tx_root(self.hasher.tx_merkle_root)
        # operator visibility at startup: which device plane this node
        # runs on, and (devd route) the breaker policy that governs its
        # degradation/recovery — the runtime state lives in the metrics
        # RPC (gateway_verify_breaker_* / gateway_hash_breaker_*)
        if self.verifier._kernel == "devd":
            br = gateway.devd_breaker()
            logger.info(
                "device plane: devd IPC (breaker: open after %d failures, "
                "probe backoff %.2gs..%.2gs)",
                br.threshold, br.base_backoff_s, br.max_backoff_s,
            )
        else:
            logger.info(
                "device plane: %s",
                self.verifier._kernel or "cpu (native batch verify)",
            )
        # the host durability plane's policy, stated next to the device
        # plane's: what a power failure can cost (runtime state lives in
        # the metrics RPC wal_* rows; docs/crash-recovery.md)
        cc = config.consensus
        if getattr(cc, "wal_sync_every_write", False):
            logger.info("host durability plane: WAL fsync per record")
        else:
            logger.info(
                "host durability plane: WAL group commit (flush interval "
                "%.3gs, sync on #ENDHEIGHT; repair-on-open)",
                getattr(cc, "wal_flush_interval_s", 0.1),
            )
        # warm the native marshal/verify library off the hot path: the
        # gateway's CPU fallback only uses it when ready() (never builds
        # inline), so trigger the build/load here in the background
        import threading as _threading

        from tendermint_tpu_torch import native as _native

        _threading.Thread(
            target=_native.available, daemon=True, name="native.warm"
        ).start()

        # -- tx index (node.go:164-176) -----------------------------------
        if config.base.tx_index == "kv":
            tx_indexer = KVTxIndexer(db_provider("tx_index", backend, db_dir))
        else:
            tx_indexer = NullTxIndexer()
        self.tx_indexer = tx_indexer

        # -- state --------------------------------------------------------
        state = State.get_state(state_db, genesis_doc)
        state.tx_indexer = tx_indexer

        # -- apps with an authenticated state tree route their
        # commit-time dirty-node hashing through the gateway hash plane
        # (the card, or the daemon's hash stream); wired before the
        # handshake, so the blocks it replays hash there too -------------
        local_app = getattr(client_creator, "app", None)
        app_tree = getattr(local_app, "tree", None)
        if app_tree is not None and hasattr(app_tree, "hasher"):
            app_tree.hasher = self.hasher

        # -- proxy app, started now with handshake so state/store/app are
        # in sync before anything else wires up (node.go:152-158) ---------
        self.proxy_app = AppConns(client_creator, Handshaker(state, self.block_store))
        self.proxy_app.start()

        # -- event switch (node.go:182-185) -------------------------------
        self.evsw = EventSwitch()

        # -- decide fast sync (node.go:188-196: skip if we're the sole
        # validator — we'd wait forever for peers) ------------------------
        fast_sync = config.base.fast_sync
        if state.validators.size() == 1 and priv_validator is not None:
            _addr, val = state.validators.get_by_index(0)
            if val.address == priv_validator.get_address():
                fast_sync = False
        self.fast_sync = fast_sync

        # -- mempool (node.go:206-212). A local app that publishes a tx
        # signature parser (e.g. apps/signedkv.py) gets the batched
        # signature gate: CheckTx bursts verify through the TPU gateway
        # BEFORE app dispatch (BASELINE config 5; the reference app
        # verifies per-tx on CPU, mempool/mempool.go:166-205) ------------
        # -- debugging substrate: one tx-lifecycle recorder
        # (libs/txtrace.py) stamped by mempool + reactor + consensus,
        # and one black-box flight recorder (node/flightrec.py) fed by
        # consensus/p2p/health — both constructed before the subsystems
        # that stamp them
        from tendermint_tpu_torch.libs.txtrace import TxTraceRecorder
        from tendermint_tpu_torch.node.flightrec import FlightRecorder

        self.txtrace = TxTraceRecorder()
        self.flightrec = FlightRecorder(home=config.base.root_dir)

        sig_batcher = None
        # kept for telemetry (statetree_* gauges, scrape-only). The app
        # is what's held, not the tree instance: a full-snapshot restore
        # REBINDS app.tree to a fresh VersionedTree, and gauges pinned
        # to the old instance would freeze forever
        self.app_state_tree_app = local_app if app_tree is not None else None
        tx_parser = getattr(local_app, "tx_sig_parser", None)
        if tx_parser is not None:
            from tendermint_tpu_torch.mempool.mempool import SigBatcher

            # the gate replaces the app's own CheckTx verification
            if hasattr(local_app, "verify_in_app"):
                local_app.verify_in_app = False
            sig_batcher = SigBatcher(self.verifier, tx_parser)
        self.mempool = Mempool(
            config.mempool, self.proxy_app.mempool(), sig_batcher=sig_batcher
        )
        self.mempool.txtrace = self.txtrace
        self.mempool.init_wal()
        self.mempool_reactor = MempoolReactor(config.mempool, self.mempool)

        # -- statesync (docs/state-sync.md): snapshot store is
        # always constructed (serving is free); the producer hooks the
        # post-apply point when an interval is configured and the local
        # app supports snapshots; restore mode arms when enabled on a
        # node that is still at genesis with an empty block store -------
        from tendermint_tpu_torch.statesync import SnapshotProducer, SnapshotStore

        sc = config.statesync
        self.snapshot_store = SnapshotStore(sc.snapshot_dir())
        from tendermint_tpu_torch.abci.types import Application

        self.snapshot_producer = None
        if sc.snapshot_interval > 0:
            # support probe by method identity — actually CALLING
            # snapshot() here would serialize the app's whole committed
            # state at node construction just to throw it away
            if local_app is not None and type(local_app).snapshot is not Application.snapshot:
                self.snapshot_producer = SnapshotProducer(
                    self.snapshot_store,
                    local_app,
                    self.block_store,
                    hasher=self.hasher,
                    interval=sc.snapshot_interval,
                    keep_recent=sc.snapshot_keep_recent,
                    chunk_size=sc.chunk_size,
                    full_every=sc.snapshot_full_every,
                )
            else:
                logger.warning(
                    "statesync.snapshot_interval=%d but app %s has no "
                    "snapshot support; producer disabled",
                    sc.snapshot_interval, config.base.proxy_app,
                )
        statesync_restore = (
            sc.enable
            and self.block_store.height() == 0
            and state.last_block_height == 0
        )
        if sc.enable and not statesync_restore:
            logger.info(
                "statesync enabled but node already has a chain "
                "(store height %d); using fast sync", self.block_store.height(),
            )

        # kept for statesync wiring: the runtime horizon fallback
        # (below-horizon laggard -> statesync) rebuilds a
        # Restorer with exactly what _make_restorer needs
        self._local_app = local_app
        self._state_db = state_db

        # -- consensus ----------------------------------------------------
        self.consensus_state = ConsensusState(
            config.consensus,
            state.copy(),
            self.proxy_app.consensus(),
            self.block_store,
            self.mempool,
            verifier=self.verifier,
        )
        if priv_validator is not None:
            self.consensus_state.set_priv_validator(priv_validator)
        self.consensus_state.txtrace = self.txtrace
        self.consensus_state.flightrec = self.flightrec
        self.consensus_state.set_event_switch(self.evsw)

        # -- retention coordinator (docs/state-sync.md §
        # Retention): [pruning] arms automatic block-store + WAL pruning
        # on the apply executor's tail, AFTER the snapshot producer in
        # the hook chain so a snapshot published at H is on disk before
        # the prune computes its snapshot floor. Constructed always
        # (stable pruning_* metric family); inert when retain_blocks=0.
        from tendermint_tpu_torch.node.retention import RetentionCoordinator

        self.retention = RetentionCoordinator(
            config.pruning,
            self.block_store,
            snapshot_store=self.snapshot_store,
            wal_fn=lambda: self.consensus_state.wal,
            evidence_pool=self.consensus_state.evidence_pool,
            tree_app=self.app_state_tree_app,
            tx_indexer=self.tx_indexer,
            db_dir=config.base.db_dir(),
            wal_dir=os.path.dirname(config.consensus.wal_file()),
            snapshot_dir=sc.snapshot_dir(),
        )
        post_apply_hook = self._compose_post_apply_hooks()
        if post_apply_hook is not None:
            self.consensus_state.post_apply_hook = post_apply_hook
        self.consensus_reactor = ConsensusReactor(self.consensus_state, fast_sync)
        self.consensus_reactor.set_event_switch(self.evsw)

        # -- blockchain (fast sync) reactor -------------------------------
        self.blockchain_reactor = BlockchainReactor(
            state.copy(),
            self.proxy_app.consensus(),
            self.block_store,
            fast_sync,
            event_cache=None,
            batch_verifier=self.verifier.commit_batch_verifier(),
            async_batch_verifier=self.verifier.verify_batch_async,
            part_hasher=self.hasher.part_leaf_hashes,
            part_tree_hasher=self.hasher.part_set_tree,
            post_apply_hook=post_apply_hook,
            defer_for_statesync=statesync_restore,
            evidence_pool=self.consensus_state.evidence_pool,
        )

        # -- statesync reactor: always serves local snapshots; in restore
        # mode it also drives discovery -> light-verified restore -> the
        # fast-sync handoff (start_after_statesync picks up the tail) ----
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

        restorer = None
        if statesync_restore:
            restorer = self._make_restorer(sc, local_app, genesis_doc, state_db)
            statesync_restore = restorer is not None
            if not statesync_restore:
                # misconfigured restore must not strand the node: fall
                # back to plain fast sync (the reactor stays serve-only)
                self.blockchain_reactor.start_after_statesync(None)
        self.statesync_reactor = StateSyncReactor(
            self.snapshot_store,
            restorer=restorer,
            enabled=statesync_restore,
            on_complete=self._on_statesync_complete,
        )
        if statesync_restore:
            logger.info(
                "statesync: restore armed (light verify via %s, trust height %d)",
                sc.rpc_servers or "genesis", sc.trust_height,
            )
        # horizon-aware catchup: a fast-syncing node whose
        # next height EVERY peer has pruned switches to statesync at
        # runtime instead of spinning on no_block_response forever
        self.blockchain_reactor.horizon_fallback = self._on_below_horizon

        # -- p2p switch (node.go:231-245) ---------------------------------
        peer_config = PeerConfig(
            mconfig=MConnConfig(
                send_rate=float(config.p2p.send_rate),
                recv_rate=float(config.p2p.recv_rate),
                flush_throttle=config.p2p.flush_throttle_timeout,
            )
        )
        self.sw = Switch(config.p2p, peer_config)
        self.sw.flightrec = self.flightrec
        self.blockchain_reactor.flightrec = self.flightrec
        self.sw.add_reactor("MEMPOOL", self.mempool_reactor)
        self.sw.add_reactor("BLOCKCHAIN", self.blockchain_reactor)
        self.sw.add_reactor("CONSENSUS", self.consensus_reactor)
        self.sw.add_reactor("STATESYNC", self.statesync_reactor)

        self.addr_book = AddrBook(
            config.p2p.addr_book(), config.p2p.addr_book_strict
        )
        if config.p2p.pex_reactor:
            # dial-cadence knob for harness tiers (ops/localnet pex_churn
            # runs whole discovery→dial→evict cycles in seconds; the 30s
            # production default would make that scenario minutes long)
            from tendermint_tpu_torch.libs.envknob import env_number
            from tendermint_tpu_torch.p2p.pex import DEFAULT_ENSURE_PEERS_PERIOD
            self.pex_reactor = PEXReactor(
                self.addr_book,
                ensure_peers_period=float(env_number(
                    "TENDERMINT_PEX_ENSURE_PERIOD_S",
                    DEFAULT_ENSURE_PEERS_PERIOD,
                )),
            )
            self.sw.add_reactor("PEX", self.pex_reactor)
        else:
            self.pex_reactor = None

        # -- ABCI-query-backed peer filters (node.go:250-272) -------------
        if config.base.filter_peers:
            def filter_addr(addr):
                res = self.proxy_app.query().query_sync(
                    data=b"", path=f"/p2p/filter/addr/{addr}"
                )
                if not res.is_ok:
                    raise ConnectionError(f"filtered addr {addr}: {res.log}")

            def filter_pubkey(pubkey):
                res = self.proxy_app.query().query_sync(
                    data=b"", path=f"/p2p/filter/pubkey/{pubkey.raw.hex()}"
                )
                if not res.is_ok:
                    raise ConnectionError(f"filtered pubkey: {res.log}")

            self.sw.filter_conn_by_addr = filter_addr
            self.sw.filter_conn_by_pubkey = filter_pubkey

        self.state = state
        self.listener: Listener | None = None
        self.rpc_server = None
        self.grpc_server = None

        # -- overload-control plane (docs/serving.md): one
        # ingress admission controller shared with the RPC server (its
        # counters feed telemetry), one pressure monitor feeding the
        # load-shed ladder to both the RPC edge and the mempool's lane
        # admission. Consensus paths never consult either.
        from tendermint_tpu_torch.node.health import OverloadMonitor
        from tendermint_tpu_torch.rpc.admission import AdmissionController

        self.rpc_admission = AdmissionController(config.rpc)
        self.overload = OverloadMonitor(self)
        self.rpc_admission.pressure_fn = self.overload.level
        self.mempool.pressure_fn = self.overload.level

        # -- telemetry plane: one registry wires every
        # subsystem's gauges + the process-wide instrument set; the
        # metrics RPC renders its flat legacy dict and GET /metrics its
        # Prometheus text (node/telemetry.py is the canonical naming map)
        from tendermint_tpu_torch.node.telemetry import build_registry

        self.telemetry = build_registry(self)

        # flight-dump counter snapshot: the p2p gossip totals (picks vs
        # sends vs failures vs duplicates — the wedge signature) and the
        # consensus position ride every dump, so a wedge is triaged
        # from the artifact alone (node/flightrec.py)
        from tendermint_tpu_torch.p2p import telemetry as p2p_telemetry

        def _flight_counters() -> dict:
            rs = self.consensus_state.rs
            out = {
                "height": rs.height,
                "round": rs.round_,
                "step": int(rs.step),
                "vote_duplicates": self.consensus_state.vote_duplicates,
                "peer_msg_drops": self.consensus_state.peer_msg_drops,
            }
            out.update(p2p_telemetry.family_totals(self.telemetry))
            return out

        self.flightrec.counters_fn = _flight_counters

    # -- retention wiring --------------------------------------------------

    def _compose_post_apply_hooks(self):
        """The apply executor's tail chain: snapshot producer first (a
        snapshot at H must publish before retention reads its floor),
        then the retention coordinator. A link logs any error of its own
        but a DeviceError, which the producer raises on to the caller:
        consensus stops on it and fast sync ends on it. Returns None
        when neither is armed (the pre-hook fast path)."""
        hooks = []
        if self.snapshot_producer is not None:
            hooks.append(self.snapshot_producer.maybe_snapshot)
        if self.retention.enabled:
            hooks.append(self.retention.maybe_prune)
        if not hooks:
            return None
        if len(hooks) == 1:
            return hooks[0]

        def chained(state, block=None):
            for hook in hooks:
                hook(state, block)

        return chained

    # -- statesync wiring --------------------------------------------------

    def _on_below_horizon(self, horizon: int) -> bool:
        """Blockchain-reactor fallback: fast sync proved the
        network pruned past our target. Arm a runtime statesync restore
        when this node can actually take one — a fresh node (empty store,
        app at 0) with light-client endpoints configured. Returns True
        when statesync was armed (the reactor then stops its pool)."""
        if self.statesync_reactor.restore_active:
            return False
        if self.block_store.height() != 0 or self.state.last_block_height != 0:
            logger.error(
                "node is below the network's retained horizon (%d) but "
                "already holds a chain at height %d — cannot statesync in "
                "place; wipe the home and restart with statesync, or find "
                "an archive peer", horizon, self.block_store.height(),
            )
            return False
        restorer = self._make_restorer(
            self.config.statesync, self._local_app, self.genesis_doc,
            self._state_db,
        )
        if restorer is None:
            logger.error(
                "node is below the network's retained horizon (%d) and "
                "statesync cannot arm (no in-process app or no "
                "statesync.rpc_servers configured) — fast sync will keep "
                "retrying but cannot converge", horizon,
            )
            return False
        armed = self.statesync_reactor.arm_restore(restorer)
        if armed:
            logger.warning(
                "auto-switching to statesync: network retains only "
                "heights >= %d", horizon,
            )
        return armed

    def _make_restorer(self, sc, local_app, genesis_doc, state_db):
        """Build the restore-side Restorer, or None (with a logged
        reason) when the configuration cannot support a restore."""
        from tendermint_tpu_torch.statesync import Restorer

        if local_app is None:
            logger.warning(
                "statesync restore needs an in-process app (got %s); "
                "falling back to fast sync", self.config.base.proxy_app,
            )
            return None
        servers = [s.strip() for s in sc.rpc_servers.split(",") if s.strip()]
        if not servers:
            logger.warning(
                "statesync.enable without statesync.rpc_servers; the light "
                "client has nothing to verify against — falling back to "
                "fast sync",
            )
            return None
        from tendermint_tpu_torch.rpc.client import HTTPClient
        from tendermint_tpu_torch.rpc.light import LightClient
        from tendermint_tpu_torch.types.validator import Validator
        from tendermint_tpu_torch.types.validator_set import ValidatorSet

        vs = ValidatorSet(
            [Validator.new(v.pub_key, v.power) for v in genesis_doc.validators]
        )
        trust_height = sc.trust_height
        trusted_header = None
        # resume from the deepest trust this home ever verified
        # — a prior restore's persisted anchor beats the configured pin
        # (never the other way: an operator pin ABOVE the anchor wins)
        from tendermint_tpu_torch.node.light_anchor import load_anchor

        anchor = load_anchor(self.config.base.root_dir, genesis_doc.chain_id)
        if anchor is not None and anchor[0] > trust_height:
            trust_height, vs, trusted_header = anchor
            logger.info(
                "light client resuming from persisted trust anchor at "
                "height %d", trust_height,
            )
        clients = [HTTPClient(s) for s in servers]
        light_client = LightClient(
            clients[0] if len(clients) == 1 else _FailoverRPC(clients),
            genesis_doc.chain_id,
            vs,
            trusted_height=trust_height,
            batch_verifier=self.verifier.commit_batch_verifier(),
        )
        light_client._trusted_header = trusted_header
        return Restorer(
            genesis_doc,
            local_app,
            state_db,
            self.block_store,
            hasher=self.hasher,
            light_client=light_client,
            batch_verifier=self.verifier.commit_batch_verifier(),
        )

    def _on_statesync_complete(self, restored_state) -> None:
        """Restore finished (or fell back with None): adopt the restored
        state everywhere that cached a genesis-height copy, then hand the
        tail to fast sync."""
        if restored_state is not None:
            # the consensus state keeps waiting in fast-sync mode: the
            # eventual switch_to_consensus (from the blockchain reactor)
            # seeds it with the fast-synced state, which now starts at
            # the restored height
            self.state = restored_state
            # the restorer's adopted walker holds the deepest
            # verified trust this home has ever reached — persist it so
            # a wipe-and-restore restart resumes there instead of
            # re-walking (and re-trusting) from the configured pin
            from tendermint_tpu_torch.node.light_anchor import save_anchor

            restorer = getattr(self.statesync_reactor, "restorer", None)
            lc = getattr(restorer, "light_client", None)
            if lc is not None and save_anchor(self.config.base.root_dir, lc):
                logger.info(
                    "persisted light-client trust anchor at height %d",
                    lc.height,
                )
            logger.info(
                "statesync restore complete at height %d; fast-syncing the tail",
                restored_state.last_block_height,
            )
        self.blockchain_reactor.start_after_statesync(restored_state)

    # -- lifecycle (node.go:310-352) --------------------------------------

    def on_start(self) -> None:
        self.evsw.start()

        # p2p listener
        if self.config.p2p.laddr:
            self.listener = Listener(
                _parse_laddr(self.config.p2p.laddr),
                skip_upnp=self.config.p2p.skip_upnp,
            )
            self.sw.add_listener(self.listener)

        info = NodeInfo(
            pub_key=self.sw.node_priv_key.pub_key(),
            moniker=self.config.base.moniker,
            network=self.genesis_doc.chain_id,
            version=default_version(VERSION),
            listen_addr=(
                str(self.listener.external_address()) if self.listener else ""
            ),
            other=[
                "consensus_version=v1",
                f"rpc_addr={self.config.rpc.laddr}",
                # the genesis commit-format flag and the full upgrade
                # SCHEDULE ride the handshake, so mixed-format nets
                # refuse loudly at peering (NodeInfo.compatible_with):
                # nodes disagreeing on the flip height refuse here,
                # never wedge at decode (docs/upgrade.md)
                f"commit_format={self.genesis_doc.commit_format}",
                f"commit_schedule={self.genesis_doc.schedule_string()}",
            ],
        )
        self.sw.set_node_info(info)
        if self.listener:
            self.addr_book.add_our_address(self.listener.external_address())
        self.sw.start()

        if self.config.p2p.seeds:
            seeds = [s.strip() for s in self.config.p2p.seeds.split(",") if s.strip()]
            self.sw.dial_seeds(seeds, self.addr_book if self.pex_reactor else None)

        if self.config.rpc.laddr:
            self._start_rpc()
        if self.config.rpc.grpc_laddr:
            self._start_grpc()

        # flight-recorder trigger scan: breaker transitions, the health
        # verdict (the failing-transition auto-dump fires even when
        # nothing scrapes), the height-age wedge dump
        self.flightrec.start_watchdog(self)

    def on_stop(self) -> None:
        self.flightrec.stop_watchdog()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.rpc_server is not None:
            self.rpc_server.stop()
        self.sw.stop()
        if self.mempool.sig_batcher is not None:
            self.mempool.sig_batcher.stop()
        self.mempool.close_wal()
        self.proxy_app.stop()
        self.evsw.stop()

    def _rpc_context(self):
        from tendermint_tpu_torch.rpc.core.pipe import RPCContext

        return RPCContext(
            event_switch=self.evsw,
            block_store=self.block_store,
            consensus_state=self.consensus_state,
            mempool=self.mempool,
            switch=self.sw,
            proxy_app_query=self.proxy_app.query(),
            genesis_doc=self.genesis_doc,
            priv_validator=self.priv_validator,
            tx_indexer=self.tx_indexer,
            state=self.state,
            node=self,
        )

    def _start_rpc(self) -> None:
        from tendermint_tpu_torch.rpc.server import RPCServer

        self.rpc_server = RPCServer(
            _parse_laddr(self.config.rpc.laddr),
            self._rpc_context(),
            unsafe=self.config.rpc.unsafe,
        )
        self.rpc_server.start()

    def _start_grpc(self) -> None:
        """BroadcastAPI port (rpc/grpc/api.go:14; node wiring
        node.go:341-345)."""
        from tendermint_tpu_torch.rpc.grpc import GRPCBroadcastServer

        self.grpc_server = GRPCBroadcastServer(
            _parse_laddr(self.config.rpc.grpc_laddr), self._rpc_context()
        )
        self.grpc_server.start()

    # -- introspection ------------------------------------------------------

    def rpc_port(self) -> int:
        assert self.rpc_server is not None
        return self.rpc_server.port
