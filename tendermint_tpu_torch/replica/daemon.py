"""Stateless verified read replica (docs/serving.md § Read replicas).

The daemon follows ONE upstream RPC endpoint — a full node, or another
replica (tiered fan-out; proofs compose unchanged because nothing here
can forge a validator signature) — with the existing light client,
persisting its trust anchor in the replica home. Every block the
upstream announces is verified (+2/3 commit check via ``advance``, block
bytes bound to the verified header hash) BEFORE it touches the serve
path: the recent-block window, the proof cache's invalidation log, and
the relayed NewBlock event all see only verified data.

Reads are served from a proof-carrying cache: an ``abci_query`` miss
fetches ``prove=1`` from upstream, checks the statetree proof against
the light-verified header at (proof height + 1), checks the bare value
against the proven one, and only then caches + serves. Clients re-verify
— ``LightClient.verified_query`` pointed at a replica runs the exact
same checks, so a corrupt replica is DETECTED, never trusted
(``TENDERMINT_REPLICA_TAMPER=value|proof`` exists to prove that in
benches/tests: it corrupts responses at serve time, after verification).

The listener is the ordinary rpc/server.py stack with a replica route
table, so the admission plane (connection/inflight caps, rate limits,
typed sheds) and WS bounded-queue fan-out apply unchanged: one upstream
subscription feeds N client subscriptions, and replicas shed reads
before the validator ever sees the flood.

The replica verifies on the gateway's `default_verifier()`, taken when it
is built: with no card and no serving device daemon, building it raises
`resolve_device`'s RuntimeError before its listener binds. Its light walk
batches a full commit's signatures through that Verifier (B1 on the
card); aggregate commits reach it through `AggregateCommit.verify` (dsm).
A DeviceError under the follower stops the follow loop: it is kept in
`device_error` and shown by `health_view` (failing) and `stats`
(`device_errors`), never retried as a connection fault.
"""

from __future__ import annotations

import copy
import json
import queue
import threading
from collections import OrderedDict

from tendermint_tpu_torch.libs.envknob import env_number, env_str
from tendermint_tpu_torch.libs.events import EventSwitch
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.node.light_anchor import load_anchor, save_anchor
from tendermint_tpu_torch.ops import gateway
from tendermint_tpu_torch.rpc import admission as adm
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError, WSClient
from tendermint_tpu_torch.rpc.core.handlers import RPCError
from tendermint_tpu_torch.rpc.core.pipe import RPCContext
from tendermint_tpu_torch.rpc.light import LightClient
from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.replica.cache import ProofCache
from tendermint_tpu_torch.types import events as tev
from tendermint_tpu_torch.types.block import Header


class _RecordingClient:
    """The light client's transport, recording every /commit response.

    A downstream replica walks ITS light client through this replica's
    ``commit`` endpoint; those responses must be the genuine upstream
    ones (a replica cannot re-sign anything), so the window of commits
    this replica can re-serve is exactly what its own walk fetched."""

    def __init__(self, inner, record):
        self._inner = inner
        self._record = record

    def commit(self, height: int = 0):
        res = self._inner.commit(height=height)
        self._record(int(height), res)
        return res

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ReplicaDaemon(BaseService):
    """One replica: light-client follower + proof cache + read RPC."""

    def __init__(self, config):
        super().__init__(name="replica")
        self.config = config
        cfg = config.replica
        if not cfg.upstream:
            raise ValueError(
                "replica requires an upstream RPC address "
                "([replica] upstream, or --upstream)"
            )
        self.cfg = cfg
        self.upstream = cfg.upstream
        self.verifier = gateway.default_verifier()
        self.device_error: gateway.DeviceError | None = None
        self.client = HTTPClient(cfg.upstream)
        self.cache = ProofCache(cfg.cache_entries)
        self.event_switch = EventSwitch()
        self.light: LightClient | None = None
        self.genesis_doc = None
        self._genesis_res: dict | None = None
        # verified serve window: height -> raw upstream /block response
        self._recent: OrderedDict[int, dict] = OrderedDict()
        # height -> raw upstream /commit response (recorded by the walk)
        self._commits: OrderedDict[int, dict] = OrderedDict()
        self._state_mtx = threading.Lock()
        self._ingest_mtx = threading.Lock()
        self._ingested = 0
        self.upstream_height = 0
        self.connected = False
        self.proof_verify_failures = 0
        self.upstream_reconnects = 0
        self.served_reads_total = 0
        self.relayed_events = 0
        # the ingress plane on the replica's OWN listener
        self.rpc_admission = adm.AdmissionController(config.rpc)
        self.rpc_admission.pressure_fn = self._pressure
        self.health_fn = self.health_view
        from tendermint_tpu_torch.node.telemetry import build_replica_registry

        self.telemetry = build_replica_registry(self)
        self._rpc: RPCServer | None = None
        self._follow: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        self.event_switch.start()
        self._bootstrap()
        self._follow = threading.Thread(
            target=self._follow_loop, daemon=True, name="replica.follow"
        )
        self._follow.start()
        ctx = RPCContext(event_switch=self.event_switch, node=self)
        from tendermint_tpu_torch.replica.handlers import REPLICA_ROUTES

        self._rpc = RPCServer(self.cfg.laddr, ctx, routes=REPLICA_ROUTES)
        self._rpc.start()
        self.logger.info(
            "replica serving %s (upstream %s, trust at %d)",
            self.cfg.laddr, self.upstream, self.light.height,
        )

    def on_stop(self) -> None:
        if self._rpc is not None:
            self._rpc.stop()
        if self._follow is not None:
            self._follow.join(timeout=5.0)
        self.event_switch.stop()
        if self.light is not None:
            save_anchor(self.cfg.root_dir, self.light)

    @property
    def rpc_port(self) -> int:
        return self._rpc.port if self._rpc is not None else 0

    def _bootstrap(self) -> None:
        """Fetch genesis and seed trust — from the persisted anchor when
        this home has one, genesis otherwise. Retries until the upstream
        answers or the service stops: a replica booting before its
        upstream is a normal fleet ordering."""
        from tendermint_tpu_torch.types.genesis import GenesisDoc
        from tendermint_tpu_torch.types.validator import Validator
        from tendermint_tpu_torch.types.validator_set import ValidatorSet

        delay = self.cfg.reconnect_backoff_s
        while True:
            try:
                self._genesis_res = self.client.genesis()
                break
            except Exception as exc:  # noqa: BLE001 — upstream not up yet
                if self._quit.is_set() or self._stopped:
                    raise
                self.logger.warning(
                    "upstream %s not answering genesis (%s); retrying",
                    self.upstream, exc,
                )
                if self._quit.wait(delay):
                    raise
                delay = min(delay * 2, self.cfg.reconnect_backoff_max_s)
        doc = GenesisDoc.from_json(self._genesis_res["genesis"])
        self.genesis_doc = doc
        rec = _RecordingClient(self.client, self._record_commit)
        anchor = load_anchor(self.cfg.root_dir, doc.chain_id)
        if anchor is not None:
            height, validators, header = anchor
            self.light = LightClient(rec, doc.chain_id, validators, height,
                                     batch_verifier=self.verifier.commit_batch_verifier())
            self.light._trusted_header = header
        else:
            vs = ValidatorSet(
                [Validator.new(v.pub_key, v.power) for v in doc.validators]
            )
            self.light = LightClient(rec, doc.chain_id, vs, 0,
                                     batch_verifier=self.verifier.commit_batch_verifier())
        # the memo must cover the serve window: every block/commit this
        # replica re-serves pairs with a memoized verified header
        self.light.header_memo_max = max(64, self.cfg.keep_blocks + 8)

    # -- upstream follower -------------------------------------------------

    def _record_commit(self, height: int, res: dict) -> None:
        if height < 1:
            return
        with self._state_mtx:
            self._commits[height] = res
            self._commits.move_to_end(height)
            while len(self._commits) > max(1, self.cfg.keep_blocks):
                self._commits.popitem(last=False)

    def _follow_loop(self) -> None:
        """One upstream WS subscription feeding everything: verification,
        cache invalidation, and the N-client event relay. Drops reconnect
        with doubling backoff and replay missed heights from /block. A
        DeviceError ends the loop: retrying cannot bring the card back."""
        backoff = self.cfg.reconnect_backoff_s
        first = True
        while not self._quit.is_set() and not self._stopped:
            ws = None
            try:
                ws = WSClient(self.upstream, timeout=10.0)
                ws.subscribe(tev.EVENT_NEW_BLOCK)
                if not first:
                    self.upstream_reconnects += 1
                first = False
                self.connected = True
                backoff = self.cfg.reconnect_backoff_s
                self._catch_up()
                while not self._quit.is_set() and not self._stopped:
                    try:
                        ev = ws.next_event(timeout=0.5)
                    except queue.Empty:
                        if not ws._recv_thread.is_alive():
                            raise ConnectionError(
                                "upstream event stream closed"
                            )
                        continue
                    data = ev.get("data") or {}
                    hdr = (data.get("block") or {}).get("header") or {}
                    h = hdr.get("height")
                    if isinstance(h, int) and not isinstance(h, bool) and h > 0:
                        self.upstream_height = max(self.upstream_height, h)
                        self._shed_paced(lambda h=h: self._ingest(h))
            except gateway.DeviceError as exc:
                self.device_error = exc
                self.connected = False
                self.logger.error(
                    "upstream follower stopped: device error (%s)", exc
                )
                break
            except Exception as exc:  # noqa: BLE001 — any follower fault
                # (dead socket, verification failure, upstream restart)
                # re-enters through a fresh subscription + catch-up
                if self._quit.is_set() or self._stopped:
                    break
                self.connected = False
                self.logger.warning(
                    "upstream follower error (%s: %s); reconnecting in %.2fs",
                    type(exc).__name__, exc, backoff,
                )
                self._quit.wait(backoff)
                backoff = min(backoff * 2, self.cfg.reconnect_backoff_max_s)
            finally:
                if ws is not None:
                    ws.close()

    def _shed_paced(self, fn):
        """Run one follower-side upstream call, absorbing typed sheds.

        An upstream running the admission plane answers over-
        budget requests with HTTP 429/503 + `shed:<reason>`. For an
        infrastructure follower (often sharing its source IP with real
        clients, e.g. behind one NAT) that is a PACING signal, not a
        dead connection — honoring it with a short wait keeps the walk
        alive; treating it as a fault would thrash the reconnect path
        with doubling backoff while the chain pulls further ahead."""
        while True:
            try:
                return fn()
            except RPCClientError as exc:
                if (
                    not str(exc).startswith("shed:")
                    or self._quit.is_set()
                    or self._stopped
                ):
                    raise
                self._quit.wait(0.25)

    def _catch_up(self) -> None:
        """Replay heights committed while the subscription was down: poll
        /status for the upstream head, then ingest forward from trust —
        bounded by keep_blocks (older history is servable upstream; a
        replica only promises its recent window)."""
        st = self._shed_paced(self.client.status)
        latest = st.get("latest_block_height") or 0
        if not isinstance(latest, int) or latest < 1:
            return
        self.upstream_height = max(self.upstream_height, latest)
        start = max(self._ingested + 1, latest - self.cfg.keep_blocks + 1, 1)
        for h in range(start, latest + 1):
            if self._quit.is_set() or self._stopped:
                return
            self._shed_paced(lambda h=h: self._ingest(h))

    def _ingest(self, h: int) -> None:
        """Verify block `h` and admit it to the serve path. Everything
        downstream of this point — recent window, invalidation log,
        relayed events, the anchor — sees only verified data."""
        with self._ingest_mtx:
            if h <= self._ingested:
                return
            light = self.light
            light.advance(h)  # +2/3 walk; records commits along the way
            hdr = light.header_at(h)
            block_res = self.client.block(height=h)
            blk = block_res.get("block") or {}
            try:
                block_header = Header.from_json(blk.get("header"))
            except ValueError as exc:
                self.proof_verify_failures += 1
                raise RPCError(f"malformed upstream block at {h}: {exc}")
            if block_header.hash() != hdr.hash():
                # upstream served block bytes that are NOT the ones the
                # verified commit signed — refuse the whole height
                self.proof_verify_failures += 1
                raise RPCError(
                    f"upstream block {h} does not match the verified header"
                )
            txs = [
                bytes.fromhex(t)
                for t in (blk.get("data") or {}).get("txs") or []
            ]
            with self._state_mtx:
                self._recent[h] = block_res
                self._recent.move_to_end(h)
                while len(self._recent) > max(1, self.cfg.keep_blocks):
                    self._recent.popitem(last=False)
                self._ingested = h
            self.upstream_height = max(self.upstream_height, h)
            self.cache.note_block(h, txs)
            self.cache.prune(h - self.cfg.keep_blocks)
            save_anchor(self.cfg.root_dir, light)
        # relay AFTER verification, outside the ingest lock: the WS
        # fan-out (bounded per-client queues, rpc/server.py) must never
        # stall the follower
        self.relayed_events += 1
        self.event_switch.fire_event(tev.EVENT_NEW_BLOCK, {"block": blk})

    # -- verified read path ------------------------------------------------

    def lag_heights(self) -> int:
        return max(0, self.upstream_height - self._ingested)

    def max_lag(self) -> int:
        return int(env_number(
            "TENDERMINT_REPLICA_MAX_LAG_HEIGHTS", self.cfg.max_lag_heights,
            cast=int,
        ))

    def query(self, data=b"", path: str = "", height: int = 0,
              prove: bool = False) -> dict:
        """abci_query off the proof cache. `height` pins the proven
        version; 0 serves the newest height this replica has verified —
        refusing (typed) when its view lags the upstream beyond
        ``max_lag_heights`` rather than serving silently stale reads."""
        self.served_reads_total += 1
        light = self.light
        if light is None or light.height < 2:
            raise RPCError("replica_warming: no verified state yet")
        key_hex = data.hex() if isinstance(data, bytes) else str(data)
        key_hex = key_hex.lower()
        height = int(height)
        if height == 0:
            lag = self.lag_heights()
            if lag > self.max_lag():
                raise RPCError(
                    f"replica_stale: {lag} heights behind upstream "
                    f"(max_lag_heights {self.max_lag()})"
                )
            # header H commits the app state of block H-1: the newest
            # height provable against the verified walk
            target = light.height - 1
            ent = self.cache.get_latest(
                path, key_hex, max(1, target - self.max_lag())
            )
        else:
            target = height
            ent = self.cache.get(path, key_hex, target)
        if ent is None:
            ent = self._fetch_verified(path, key_hex, target)
        return self._serve_entry(ent)

    def _fetch_verified(self, path: str, key_hex: str, target: int) -> dict:
        """Cache miss: fetch prove=1 from upstream and verify the proof
        against the light-verified header BEFORE caching. This is the
        same check chain as LightClient.verified_query — run here so the
        cache can never hold an unproven byte."""
        from tendermint_tpu_torch.merkle.statetree_proof import TreeProof

        key = bytes.fromhex(key_hex)
        res = self.client.abci_query(
            data=key_hex, path=path, height=int(target), prove=True
        )
        resp = res.get("response") if isinstance(res, dict) else None
        if not isinstance(resp, dict):
            raise RPCError("malformed upstream abci_query response")
        code = resp.get("code", 0)
        if code != 0:
            raise RPCError(
                f"query refused (code {code}): {resp.get('log', '')}"
            )
        proof_hex = resp.get("proof") or ""
        if not isinstance(proof_hex, str) or not proof_hex:
            raise RPCError("upstream returned no state proof")
        h = resp.get("height")
        if not isinstance(h, int) or isinstance(h, bool) or h < 1:
            raise RPCError("bad proof height in upstream response")
        try:
            proof = TreeProof.from_json(json.loads(bytes.fromhex(proof_hex)))
        except ValueError as exc:
            self.proof_verify_failures += 1
            raise RPCError(f"malformed upstream state proof: {exc}")
        if proof.key != key:
            self.proof_verify_failures += 1
            raise RPCError("upstream proof is for a different key")
        header = self.light.header_at(h + 1)
        if not proof.verify(header.app_hash):
            self.proof_verify_failures += 1
            raise RPCError(
                f"upstream state proof failed verification at header {h + 1}"
            )
        resp_value = bytes.fromhex(resp.get("value") or "")
        if proof.is_membership:
            if resp_value != proof.value:
                self.proof_verify_failures += 1
                raise RPCError("upstream value does not match proven value")
        elif resp_value:
            self.proof_verify_failures += 1
            raise RPCError("upstream value contradicts an absence proof")
        ent = {"response": dict(resp), "header": header.to_json()}
        self.cache.put(path, key_hex, h, ent)
        return ent

    @staticmethod
    def _serve_entry(ent: dict) -> dict:
        """Serve a cached entry: the verified response + the header it
        verified against (a convenience — clients re-verify through their
        own light client regardless). The tamper knob corrupts AT SERVE
        TIME, after verification: it exists so benches/tests can prove a
        lying replica is detected client-side, never accepted."""
        tamper = env_str("TENDERMINT_REPLICA_TAMPER", "",
                         allowed=("", "value", "proof"))
        if not tamper:
            return {"response": dict(ent["response"]),
                    "header": ent["header"]}
        out = copy.deepcopy(ent)
        resp = out["response"]
        if tamper == "value":
            flip = bytearray(bytes.fromhex(resp.get("value") or "")) or \
                bytearray(b"\x00")
            flip[-1] ^= 0x01
            resp["value"] = flip.hex().upper()
        else:  # proof: flip a byte of a step's value hash (still parses)
            raw = json.loads(bytes.fromhex(resp["proof"]))
            step = raw["steps"][-1]
            flip = bytearray(bytes.fromhex(step[1]))
            flip[0] ^= 0x01
            step[1] = flip.hex().upper()
            resp["proof"] = json.dumps(raw).encode().hex().upper()
        return {"response": resp, "header": out["header"]}

    # -- served views (replica/handlers.py routes) --------------------------

    def status_view(self) -> dict:
        light = self.light
        hdr = light.trusted_header() if light is not None else None
        with self._state_mtx:
            earliest = min(self._commits) if self._commits else 0
        return {
            # a replica's identity IS its upstream + role: downstream
            # light walks key off earliest_block_height for horizon jumps
            "node_info": {
                "moniker": f"replica({self.upstream})",
                "replica": True,
                "upstream": self.upstream,
            },
            "pub_key": None,
            "latest_block_hash":
                hdr.hash().hex().upper() if hdr is not None else "",
            "latest_app_hash":
                hdr.app_hash.hex().upper() if hdr is not None else "",
            "latest_block_height": light.height if light is not None else 0,
            "earliest_block_height": earliest,
            "latest_block_time": hdr.time_ns if hdr is not None else 0,
            "replica_lag_heights": self.lag_heights(),
            "replica": {
                "upstream": self.upstream,
                "upstream_height": self.upstream_height,
                "lag_heights": self.lag_heights(),
                "max_lag_heights": self.max_lag(),
                "connected": self.connected,
            },
        }

    def genesis_view(self) -> dict:
        if self._genesis_res is None:
            raise RPCError("replica_warming: genesis not fetched yet")
        return self._genesis_res

    def commit_view(self, height: int) -> dict:
        height = int(height)
        with self._state_mtx:
            res = self._commits.get(height)
            earliest = min(self._commits) if self._commits else 0
        if res is None:
            # downstream light walks catch this and horizon-jump via our
            # /status earliest_block_height
            raise RPCError(
                f"replica: no commit for height {height} "
                f"(window starts at {earliest})"
            )
        return res

    def validators_view(self, height: int = 0) -> dict:
        height = int(height)
        light = self.light
        if light is not None and height in (0, light.height):
            return {
                "block_height": light.height,
                "validators": light.validators.to_json(),
            }
        # historical sets pass through: the downstream verifier checks
        # the claimed set's hash against the header, so a replica cannot
        # lie here any more than the upstream could
        return self.client.validators(height=height)

    def block_view(self, height: int) -> dict:
        height = int(height)
        with self._state_mtx:
            res = self._recent.get(height)
            earliest = min(self._recent) if self._recent else 0
        if res is None:
            raise RPCError(
                f"replica: no block for height {height} "
                f"(window starts at {earliest})"
            )
        return res

    def blockchain_view(self, min_height: int = 0, max_height: int = 0) -> dict:
        min_height, max_height = int(min_height), int(max_height)
        if min_height and max_height and min_height > max_height:
            raise RPCError(
                f"min height {min_height} > max height {max_height}"
            )
        with self._state_mtx:
            heights = sorted(self._recent)
            window = {h: self._recent[h] for h in heights}
        last = heights[-1] if heights else 0
        base = heights[0] if heights else 0
        hi = min(last, max_height) if max_height else last
        lo = max(base, min_height) if min_height else max(base, hi - 20 + 1)
        metas = []
        for h in range(hi, lo - 1, -1):
            res = window.get(h)
            if res is not None and res.get("block_meta") is not None:
                metas.append(res["block_meta"])
        return {"last_height": last, "base": base, "block_metas": metas}

    # -- health / pressure / telemetry --------------------------------------

    def health_view(self) -> dict:
        light = self.light
        lag = self.lag_heights()
        checks = {
            "bootstrapped": {"ok": light is not None and light.height >= 1},
            "upstream_connected": {"ok": self.connected,
                                   "upstream": self.upstream},
            "lag": {"ok": lag <= self.max_lag(), "lag_heights": lag,
                    "max_lag_heights": self.max_lag()},
            "device": {"ok": self.device_error is None,
                       "error": None if self.device_error is None
                       else str(self.device_error)},
        }
        if light is None or light.height < 1 or self.device_error is not None:
            status, code = "failing", 2
        elif not self.connected or lag > self.max_lag():
            status, code = "degraded", 1
        else:
            status, code = "ok", 0
        return {"status": status, "code": code, "checks": checks}

    def _pressure(self) -> int:
        """The overload ladder on the replica's own listener: shed reads
        when the serve plane saturates (everything a replica serves is a
        read, so rung 1 is the whole ladder here)."""
        a = self.rpc_admission
        cap = a.max_inflight() or 1
        frac = max(a.inflight / cap, a.ws_queue_frac())
        if frac >= env_number("TENDERMINT_OVERLOAD_SHED_WRITES_AT", 0.90):
            return adm.PRESSURE_SHED_WRITES
        if frac >= env_number("TENDERMINT_OVERLOAD_SHED_READS_AT", 0.75):
            return adm.PRESSURE_SHED_READS
        return adm.PRESSURE_OK

    def stats(self) -> dict:
        """The replica_* flat keys (both metric surfaces; catalog rows in
        docs/observability.md)."""
        light = self.light
        cs = self.cache.stats()
        return {
            "height": light.height if light is not None else 0,
            "lag_heights": self.lag_heights(),
            "upstream_height": self.upstream_height,
            "upstream_connected": int(self.connected),
            "cache_hits": cs["hits"],
            "cache_misses": cs["misses"],
            "cache_entries": cs["entries"],
            "cache_invalidations": cs["invalidations"],
            "proof_verify_failures": self.proof_verify_failures,
            "upstream_reconnects": self.upstream_reconnects,
            "served_reads_total": self.served_reads_total,
            "relayed_events_total": self.relayed_events,
            "device_errors": int(self.device_error is not None),
        }
