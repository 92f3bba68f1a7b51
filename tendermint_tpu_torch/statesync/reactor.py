"""State-sync p2p reactor: serve local snapshots to joining peers and
drive a restore from peers' snapshots, on channel 0x60 (beyond the
reference: v0.11 predates statesync; the offer/request/chunk shape
follows the later statesync reactor, JSON-framed like this codebase's
blockchain reactor).

Wire messages (every field is attacker input — any decode violation is a
peer error, never an exception escaping the p2p recv routine):

    {"type": "snapshots_request"}
    {"type": "snapshots_response", "snapshots": [manifest-lite, ...]}
    {"type": "manifest_request", "height": H}
    {"type": "manifest_response", "manifest": {...}} | {"type": "no_manifest", "height": H}
    {"type": "chunk_request", "height": H, "index": i}
    {"type": "chunk_response", "height": H, "index": i, "chunk": hex}
      | {"type": "no_chunk", "height": H, "index": i}

Restore driver (enabled nodes only): discover offers -> pick the highest
height -> light-verify the manifest (Restorer) -> download chunks in
windows, digest-verifying each window in ONE gateway batch; a chunk whose
digest mismatches bans the serving peer (stop_peer_for_error) and is
re-fetched from another -> Restorer.restore -> on_complete(state) hands
off to the fast-sync reactor for the tail. Downloads are resumable:
verified chunks persist CRC-framed under <snapshots>/restore-<height>/
and are reloaded (re-verified) after a restart. If no usable snapshot
appears within the fallback window, on_complete(None) lets the node fall
back to plain fast sync from genesis — statesync must never strand a
node that could have synced the slow way.

The port's copy of the JAX package's `statesync/reactor.py`, with one
deliberate difference: a device error (ops.gateway.DeviceError) raised
by the restore — the light walk's commit checks, a window's digest
batch, the seen commit, the app's tree hashing — ends the restore
visibly. It is logged, kept in `sync_error`, and the driver stops with
`restore_active` 0: no peer is banned for it, and `on_complete` is not
called, so the node does not fall back to fast sync from genesis. The
JAX package's driver treats it as a crash and falls back. A bad chunk,
a forged manifest and a bad commit keep the JAX package's handling.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time

from tendermint_tpu_torch.libs.envknob import env_number
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.ops.gateway import DeviceError
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.p2p.switch import Reactor
from tendermint_tpu_torch.statesync.restore import (
    ManifestBindingError,
    RestoreError,
    SnapshotRejected,
    verify_chunk_batch,
)
from tendermint_tpu_torch.statesync.snapshot import (
    KIND_DELTA,
    MAX_CHUNK_BYTES,
    MAX_DELTA_CHAIN,
    Manifest,
    SnapshotError,
    frame_chunk,
    unframe_chunk,
)

logger = logging.getLogger("statesync.reactor")

STATESYNC_CHANNEL = 0x60
MAX_OFFERED_SNAPSHOTS = 16  # per snapshots_response, decode-time cap


def _enc(obj: dict) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


class StateSyncReactor(Reactor, BaseService):
    def __init__(
        self,
        snapshot_store,
        restorer=None,
        enabled: bool = False,
        on_complete=None,
        chunk_window: int | None = None,
        chunk_timeout_s: float | None = None,
        chunk_retries: int | None = None,
        discovery_s: float | None = None,
        fallback_s: float | None = None,
    ):
        BaseService.__init__(self, name="statesync.reactor")
        self.store = snapshot_store
        self.restorer = restorer
        self.enabled = enabled and restorer is not None
        self.on_complete = on_complete
        # all statesync knobs parse via the shared defensive helper: a
        # typo'd env var warns and uses the default, never kills startup
        self.chunk_window = chunk_window if chunk_window is not None else int(
            env_number("TENDERMINT_STATESYNC_WINDOW", 8, cast=int)
        )
        if self.chunk_window < 1:
            self.chunk_window = 1
        self.chunk_timeout_s = (
            chunk_timeout_s if chunk_timeout_s is not None
            else env_number("TENDERMINT_STATESYNC_CHUNK_TIMEOUT_S", 10.0)
        )
        self.chunk_retries = chunk_retries if chunk_retries is not None else int(
            env_number("TENDERMINT_STATESYNC_RETRIES", 4, cast=int)
        )
        self.discovery_s = (
            discovery_s if discovery_s is not None
            else env_number("TENDERMINT_STATESYNC_DISCOVERY_S", 5.0)
        )
        self.fallback_s = (
            fallback_s if fallback_s is not None
            else env_number("TENDERMINT_STATESYNC_FALLBACK_S", 60.0)
        )

        # NB: a dedicated lock — BaseService owns self._mtx for the
        # start/stop lifecycle, and is_running() acquires it, so reusing
        # that name here would deadlock every is_running() call made
        # while holding the condition
        self._cv = threading.Condition()
        # height -> offering peer ids; only the HEIGHTS and WHO offers
        # them matter (manifests are fetched separately), and the lite
        # dicts are attacker-sized — storing them would let every peer
        # pin megabytes here. Heights that failed verification stay out.
        self._offers: dict[int, set[str]] = {}
        self._blacklist: set[int] = set()
        # (height, peer_id) the driver is currently awaiting a manifest
        # from — responses from anyone else are IGNORED, or a malicious
        # peer could race a forged manifest into the inbox and poison
        # the restore of a height an honest peer offered
        self._manifest_expect: tuple[int, str] | None = None
        self._manifest_inbox: dict[int, Manifest | None] = {}
        # (height, index) -> (peer_id, payload | None); only keys in
        # _chunk_expect (the window currently being fetched) are ever
        # stored — an unsolicited chunk_response must not grow memory,
        # 4 MiB at a time, on a 2^62x2^20 attacker-chosen key space
        self._chunk_inbox: dict[tuple[int, int], tuple[str, bytes | None]] = {}
        self._chunk_expect: set[tuple[int, int]] = set()
        self._thread: threading.Thread | None = None
        # the device error that ended the restore, when one did (see the
        # module docstring); None while it runs or after a clean finish
        self.sync_error: BaseException | None = None

        # adversarial-offerer hardening: a peer whose chunk
        # (or manifest) requests repeatedly time out unanswered is a
        # STALLER — it costs the restore a full window timeout per
        # strike, so after `stall_ban_after` unanswered requests it is
        # banned like a corrupt one. Any answer (chunk, no_chunk,
        # manifest) clears the peer's strikes.
        self.stall_ban_after = max(
            int(env_number("TENDERMINT_STATESYNC_STALL_BAN", 3, cast=int)), 1
        )
        self._stall_strikes: dict[str, int] = {}

        # gauges (statesync_* in the metrics RPC)
        self.restore_active = 0
        self.chunks_fetched = 0
        self.chunk_failures = 0
        self.peers_banned = 0
        self.offers_seen = 0
        # offerer bans by proven kind (scrape-visible — the
        # adversarial scenario matrix asserts on these)
        self.offerers_banned = 0
        self.offerer_bans_forged = 0
        self.offerer_bans_corrupt = 0
        self.offerer_bans_stall = 0

    # -- Reactor interface -------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=STATESYNC_CHANNEL,
                priority=3,
                send_queue_capacity=32,
                # the capacity must admit every LEGAL frame: a chunk
                # rides hex-encoded inside a JSON chunk_response (2x
                # MAX_CHUNK_BYTES = 8 MiB of hex at the 4 MiB ceiling),
                # and a maximal manifest carries 2^18 44-byte digest
                # entries (~11.5 MiB) — 21 MiB covers both with headroom
                recv_message_capacity=22020096,
            )
        ]

    def add_peer(self, peer) -> None:
        if self.enabled and self.restore_active:
            peer.try_send(STATESYNC_CHANNEL, _enc({"type": "snapshots_request"}))

    def remove_peer(self, peer, reason) -> None:
        with self._cv:
            for offers in self._offers.values():
                offers.discard(peer.id())
            self._cv.notify_all()

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        from tendermint_tpu_torch.codec import jsonval as jv

        try:
            msg = json.loads(msg_bytes.decode())
            mtype = msg["type"]
            if mtype == "snapshots_request":
                self._serve_snapshots(peer)
            elif mtype == "snapshots_response":
                offers = jv.list_field(msg, "snapshots", MAX_OFFERED_SNAPSHOTS)
                self._note_offers(peer, offers)
            elif mtype == "manifest_request":
                self._serve_manifest(
                    peer, jv.int_field(msg, "height", 1, jv.MAX_HEIGHT)
                )
            elif mtype == "manifest_response":
                # decode FIRST (malformed = peer error even when
                # unsolicited), deliver only from the peer we asked
                manifest = Manifest.from_json(jv.dict_field(msg, "manifest"))
                with self._cv:
                    if self._manifest_expect == (manifest.height, peer.id()):
                        self._manifest_inbox[manifest.height] = manifest
                        self._cv.notify_all()
            elif mtype == "no_manifest":
                h = jv.int_field(msg, "height", 1, jv.MAX_HEIGHT)
                with self._cv:
                    # the peer disowning its own offer is always valid;
                    # the inbox wake-up only from the peer we asked
                    self._offers.get(h, set()).discard(peer.id())
                    if self._manifest_expect == (h, peer.id()):
                        self._manifest_inbox.setdefault(h, None)
                    self._cv.notify_all()
            elif mtype == "chunk_request":
                self._serve_chunk(
                    peer,
                    jv.int_field(msg, "height", 1, jv.MAX_HEIGHT),
                    jv.int_field(msg, "index", 0, jv.MAX_INDEX),
                )
            elif mtype == "chunk_response":
                h = jv.int_field(msg, "height", 1, jv.MAX_HEIGHT)
                i = jv.int_field(msg, "index", 0, jv.MAX_INDEX)
                chunk = jv.hex_field(msg, "chunk", max_bytes=MAX_CHUNK_BYTES)
                with self._cv:
                    if (h, i) in self._chunk_expect:
                        self._chunk_inbox[(h, i)] = (peer.id(), chunk)
                        self._cv.notify_all()
            elif mtype == "no_chunk":
                h = jv.int_field(msg, "height", 1, jv.MAX_HEIGHT)
                i = jv.int_field(msg, "index", 0, jv.MAX_INDEX)
                with self._cv:
                    if (h, i) in self._chunk_expect:
                        self._chunk_inbox[(h, i)] = (peer.id(), None)
                        self._cv.notify_all()
            else:
                raise ValueError(f"unknown statesync msg {mtype!r}")
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as exc:
            self.switch.stop_peer_for_error(peer, exc)

    # -- serving side ------------------------------------------------------

    def _serve_snapshots(self, peer) -> None:
        lites = []
        for h in reversed(self.store.heights()[-MAX_OFFERED_SNAPSHOTS:]):
            m = self.store.load_manifest(h)
            if m is not None:
                lites.append(m.lite())
        peer.try_send(
            STATESYNC_CHANNEL,
            _enc({"type": "snapshots_response", "snapshots": lites}),
        )

    def _serve_manifest(self, peer, height: int) -> None:
        m = self.store.load_manifest(height)
        if m is None:
            peer.try_send(
                STATESYNC_CHANNEL, _enc({"type": "no_manifest", "height": height})
            )
        else:
            peer.try_send(
                STATESYNC_CHANNEL,
                _enc({"type": "manifest_response", "manifest": m.to_json()}),
            )

    def _serve_chunk(self, peer, height: int, index: int) -> None:
        try:
            chunk = self.store.load_chunk(height, index)
        except SnapshotError as exc:
            # the LOCAL copy is damaged (bit rot / torn write): drop the
            # whole snapshot rather than serve bytes known to be bad —
            # the peer's digest check would just ban us
            logger.warning(
                "local snapshot %d damaged (%s); deleting", height, exc
            )
            self.store.delete(height)
            chunk = None
        if chunk is None:
            peer.try_send(
                STATESYNC_CHANNEL,
                _enc({"type": "no_chunk", "height": height, "index": index}),
            )
        else:
            peer.try_send(
                STATESYNC_CHANNEL,
                _enc({
                    "type": "chunk_response",
                    "height": height,
                    "index": index,
                    "chunk": chunk.hex().upper(),
                }),
            )

    def _note_offers(self, peer, offers: list) -> None:
        from tendermint_tpu_torch.codec import jsonval as jv

        if not self.restore_active:
            # serve-only nodes never consume offers; storing them would
            # let any peer grow this dict forever
            return
        with self._cv:
            for lite in offers:
                h = jv.int_field(jv.require_dict(lite), "height", 1, jv.MAX_HEIGHT)
                if h in self._blacklist:
                    continue
                self._offers.setdefault(h, set()).add(peer.id())
                self.offers_seen += 1
            # bound per-peer state across messages: a peer holds at most
            # MAX_OFFERED_SNAPSHOTS heights, its lowest dropped first
            mine = sorted(h for h, off in self._offers.items() if peer.id() in off)
            for h in mine[:-MAX_OFFERED_SNAPSHOTS]:
                self._offers[h].discard(peer.id())
                if not self._offers[h]:
                    del self._offers[h]
            self._cv.notify_all()

    # -- restore driver ----------------------------------------------------

    def on_start(self) -> None:
        if self.enabled:
            self.restore_active = 1
            self._thread = threading.Thread(
                target=self._restore_routine, daemon=True, name="statesync.restore"
            )
            self._thread.start()

    def arm_restore(self, restorer) -> bool:
        """Arm a restore on an ALREADY-RUNNING serve-only reactor — the
        horizon-aware catchup fallback: a fast-syncing node
        whose next height every peer has pruned switches to statesync at
        runtime instead of spinning on no_block_response. Returns True
        when the restore thread launched (False: already restoring, or
        the reactor is not running)."""
        if not self.is_running():
            return False
        with self._cv:
            if self.restore_active or (
                self._thread is not None and self._thread.is_alive()
            ):
                return False
            self.restorer = restorer
            self.enabled = True
            self.restore_active = 1
        self._thread = threading.Thread(
            target=self._restore_routine, daemon=True, name="statesync.restore"
        )
        self._thread.start()
        return True

    def on_stop(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def _peers_for(self, height: int) -> list:
        with self._cv:
            ids = sorted(self._offers.get(height, ()))
        peers = []
        for pid in ids:
            peer = self.switch.peers.get(pid)
            if peer is not None:
                peers.append(peer)
        return peers

    def _serving_peers(self, height: int, also_ask: int | None = None) -> list:
        peers = self._peers_for(height)
        if also_ask is not None and also_ask != height:
            have = {p.id() for p in peers}
            peers += [p for p in self._peers_for(also_ask) if p.id() not in have]
        return peers

    def _ban_peer(self, peer_id: str, reason: str,
                  kind: str | None = None) -> None:
        self.peers_banned += 1
        if kind is not None:
            self.offerers_banned += 1
            attr = f"offerer_bans_{kind}"
            setattr(self, attr, getattr(self, attr) + 1)
        with self._cv:
            for offers in self._offers.values():
                offers.discard(peer_id)
            self._stall_strikes.pop(peer_id, None)
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            self.switch.stop_peer_for_error(peer, reason)

    def _note_stall(self, peer_id: str, what: str) -> None:
        """One unanswered request from `peer_id` timed out. Bans the
        peer after stall_ban_after strikes — a stalling offerer must not
        cost the restore a window timeout forever."""
        strikes = self._stall_strikes.get(peer_id, 0) + 1
        self._stall_strikes[peer_id] = strikes
        if strikes >= self.stall_ban_after:
            logger.warning(
                "peer %s stalled %d statesync request(s) (%s); banning",
                peer_id[:8], strikes, what,
            )
            self._ban_peer(
                peer_id, f"statesync stall ({what})", kind="stall"
            )

    def _clear_stall(self, peer_id: str) -> None:
        self._stall_strikes.pop(peer_id, None)

    def _restore_routine(self) -> None:
        deadline = time.monotonic() + self.fallback_s
        transient_fails: dict[int, int] = {}
        try:
            while self.is_running():
                height = self._pick_snapshot(deadline)
                if height is None:
                    if not self.is_running():
                        # stopping, not failing: keep scratch for the
                        # next start's resume, no fallback handoff
                        return
                    logger.warning(
                        "no usable snapshot within %.0fs; falling back to "
                        "fast sync from genesis", self.fallback_s,
                    )
                    self._finish(None)
                    return
                try:
                    state = self._restore_height(height)
                except SnapshotRejected as exc:
                    # content proven bad / permanently unverifiable:
                    # write the height off and drop its scratch chunks
                    logger.warning("snapshot %d rejected: %s", height, exc)
                    with self._cv:
                        self._blacklist.add(height)
                        self._offers.pop(height, None)
                    shutil.rmtree(self._scratch_dir(height), ignore_errors=True)
                    continue
                except RestoreError as exc:
                    # transient (manifest timeout, no peers, transport):
                    # the height stays eligible for a BOUNDED number of
                    # attempts — without the bound, one peer offering a
                    # forged unverifiable max-height would starve every
                    # honest lower snapshot for the whole fallback window
                    # (the picker always takes max). Scratch survives in
                    # case the height is re-offered later.
                    transient_fails[height] = transient_fails.get(height, 0) + 1
                    logger.warning(
                        "snapshot %d attempt %d failed: %s",
                        height, transient_fails[height], exc,
                    )
                    if transient_fails[height] >= 2:
                        logger.warning(
                            "snapshot %d: giving up after repeated transient "
                            "failures; trying lower offers", height,
                        )
                        with self._cv:
                            self._blacklist.add(height)
                            self._offers.pop(height, None)
                    continue
                if state is not None:
                    self._finish(state)
                    return
        except DeviceError as exc:
            # not the snapshot's fault nor a peer's: no ban, no fallback
            self.sync_error = exc
            self.restore_active = 0
            logger.exception("statesync restore stopped by a device error: %s", exc)
        except Exception:  # noqa: BLE001 — the driver must fail CLOSED
            logger.exception("statesync restore driver crashed")
            self._finish(None)

    def _finish(self, state) -> None:
        self.restore_active = 0
        if state is None:
            # fallback to fast sync: no restore will ever resume here —
            # drop every scratch dir or abandoned downloads leak forever
            try:
                for name in os.listdir(self.store.base_dir):
                    if name.startswith("restore-"):
                        shutil.rmtree(
                            os.path.join(self.store.base_dir, name),
                            ignore_errors=True,
                        )
            except OSError:
                pass
        if self.on_complete is not None:
            try:
                self.on_complete(state)
            except Exception:  # noqa: BLE001
                logger.exception("statesync on_complete handoff failed")

    def _pick_snapshot(self, deadline: float) -> int | None:
        """Broadcast discovery, collect offers for a full discovery_s
        window (so a slow peer's HIGHER snapshot beats the first
        responder's lower one), then pick the highest offered height.
        Re-broadcasts window by window until `deadline` when nothing
        usable shows up."""
        while self.is_running():
            self.switch.broadcast(
                STATESYNC_CHANNEL, _enc({"type": "snapshots_request"})
            )
            collect_until = min(time.monotonic() + self.discovery_s, deadline)
            with self._cv:
                while self.is_running():
                    remaining = collect_until - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(min(remaining, 0.25))
                usable = [h for h, off in self._offers.items() if off]
                if usable:
                    logger.debug("offers in hand: %s; picking %d", usable, max(usable))
                    return max(usable)
            if time.monotonic() >= deadline:
                return None
        return None

    def _fetch_manifest(self, height: int, also_ask: int | None = None) -> Manifest:
        """Fetch AND light-verify a manifest for `height`, one offering
        peer at a time. A manifest that contradicts the verified chain
        (ManifestBindingError) proves its SERVER lied: that peer is
        banned and the next offerer tried — the height is only given up
        on when the light walk itself fails or no peer serves.
        `also_ask` adds the offerers of ANOTHER height (a delta's base
        may not be separately offered, but whoever serves the delta
        holds its whole chain)."""
        for peer in self._serving_peers(height, also_ask):
            with self._cv:
                self._manifest_inbox.pop(height, None)
                self._manifest_expect = (height, peer.id())
            logger.debug("requesting manifest %d from %s", height, peer.id()[:8])
            peer.try_send(
                STATESYNC_CHANNEL, _enc({"type": "manifest_request", "height": height})
            )
            deadline = time.monotonic() + self.chunk_timeout_s
            with self._cv:
                while (
                    height not in self._manifest_inbox
                    and time.monotonic() < deadline
                    and self.is_running()
                ):
                    self._cv.wait(0.25)
                answered = height in self._manifest_inbox
                m = self._manifest_inbox.pop(height, None)
                self._manifest_expect = None
            if not answered:
                # never answered at all: a stall strike (an honest
                # no_manifest answered and costs nothing) — but only
                # when the DEADLINE expired; a wait cut short by the
                # reactor stopping proves nothing about the peer
                if self.is_running() and time.monotonic() >= deadline:
                    self._note_stall(peer.id(), "manifest")
                continue
            self._clear_stall(peer.id())
            if m is None:
                continue
            try:
                self.restorer.verify_manifest(m)
            except ManifestBindingError as exc:
                logger.warning(
                    "manifest %d from %s contradicts the verified chain "
                    "(%s); banning", height, peer.id()[:8], exc,
                )
                self._ban_peer(
                    peer.id(), f"statesync manifest {height}: {exc}",
                    kind="forged",
                )
                continue
            return m
        raise RestoreError(f"no peer served a usable manifest for height {height}")

    # -- chunk download (windowed, batch-verified, resumable) --------------

    def _scratch_dir(self, height: int) -> str:
        return os.path.join(self.store.base_dir, f"restore-{height:010d}")

    def _load_scratch(self, manifest: Manifest) -> dict[int, bytes]:
        """Reload chunks a previous attempt persisted; anything damaged
        or digest-mismatching is discarded (it will re-download)."""
        d = self._scratch_dir(manifest.height)
        have: dict[int, bytes] = {}
        if not os.path.isdir(d):
            return have
        for i in range(manifest.chunks):
            path = os.path.join(d, self.store.chunk_name(i))
            try:
                with open(path, "rb") as f:
                    have[i] = unframe_chunk(f.read())
            except (OSError, SnapshotError):
                continue
        if have:
            items = sorted(have.items())
            bad = verify_chunk_batch(
                manifest, items, hasher=self.restorer.hasher
            )
            for i in bad:
                have.pop(i, None)
            logger.info(
                "resuming restore at height %d: %d/%d chunk(s) on disk",
                manifest.height, len(have), manifest.chunks,
            )
        return have

    def _save_scratch(self, height: int, index: int, payload: bytes) -> None:
        d = self._scratch_dir(height)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, self.store.chunk_name(index)), "wb") as f:
            f.write(frame_chunk(payload))

    def _restore_height(self, height: int):
        # _fetch_manifest binds the manifest to the light-verified header
        # chain BEFORE anything downloads: a forged manifest costs us two
        # RPC round-trips (and its server a ban), not a chunk download.
        # Delta manifests pull in their base chain — fetched
        # TARGET-FIRST (the walk to height+1 caches every lower header,
        # so the bases bind off the cache), restored base-first.
        manifest = self._fetch_manifest(height)
        chain = [manifest]
        while chain[0].kind == KIND_DELTA:
            if len(chain) > MAX_DELTA_CHAIN:
                raise SnapshotRejected(
                    f"snapshot {height}: delta chain exceeds {MAX_DELTA_CHAIN}"
                )
            base = self._fetch_manifest(chain[0].base_height, also_ask=height)
            chain.insert(0, base)
        logger.debug(
            "snapshot %d bound (%d-link chain, %d chunk(s) at the head); "
            "downloading", height, len(chain), manifest.chunks,
        )

        # links the app already holds (a crashed earlier run persisted
        # the app per link) skip straight past download; any divergence
        # a skip could hide dies at the next delta's base/root checks.
        # Skips only apply when the app sits EXACTLY on a chain height —
        # an app at an unaligned height must hit the base restore's
        # "needs a fresh app" gate, not silently skip the base and die
        # with a misleading stale-delta error
        app_h = self.restorer.app.info().last_block_height
        resumable = app_h in {m.height for m in chain}
        state = None
        for k, m in enumerate(chain):
            last = k == len(chain) - 1
            if not last and resumable and app_h >= m.height:
                logger.info(
                    "resuming: skipping chain link %d (app at %d)",
                    m.height, app_h,
                )
                continue
            ordered = self._download_chunks(m, also_ask=height)
            try:
                state = self.restorer.restore_step(m, ordered, seed=last)
            except SnapshotRejected:
                raise
            except RestoreError as exc:
                # everything restore_step() touches is local and fully
                # downloaded: a failure here is CONTENT, not weather —
                # blacklist the TARGET height
                raise SnapshotRejected(str(exc))
        for m in chain:
            shutil.rmtree(self._scratch_dir(m.height), ignore_errors=True)
        return state

    def _download_chunks(self, manifest: Manifest, also_ask: int | None = None):
        """Windowed, digest-verified, scratch-resumable download of one
        manifest's chunks. Returns them in order; raises RestoreError
        when peers can't serve within the retry budget."""
        chunks = self._load_scratch(manifest)
        missing = [i for i in range(manifest.chunks) if i not in chunks]
        attempts: dict[int, int] = {}
        while missing and self.is_running():
            window, missing = (
                missing[: self.chunk_window], missing[self.chunk_window:],
            )
            got = self._fetch_window(manifest, window, attempts, also_ask=also_ask)
            retry = [i for i in window if i not in got]
            chunks.update(got)
            missing.extend(retry)
            for i in retry:
                attempts[i] = attempts.get(i, 0) + 1
                if attempts[i] > self.chunk_retries:
                    raise RestoreError(
                        f"chunk {i} unavailable after {self.chunk_retries} retries"
                    )
        if missing:
            raise RestoreError("reactor stopped mid-download")
        return [chunks[i] for i in range(manifest.chunks)]

    def _fetch_window(
        self, manifest: Manifest, window: list[int], attempts: dict[int, int],
        also_ask: int | None = None,
    ) -> dict[int, bytes]:
        """Request `window` chunks spread over the offering peers, wait,
        then digest-verify the arrivals in ONE gateway batch. Returns the
        verified chunks; a mismatching chunk bans its serving peer and is
        left for the caller to retry."""
        height = manifest.height
        peers = self._serving_peers(height, also_ask)
        if not peers:
            raise RestoreError(f"no peers left offering snapshot {height}")
        with self._cv:
            for i in window:
                self._chunk_inbox.pop((height, i), None)
            self._chunk_expect = {(height, i) for i in window}
        asked: dict[int, str] = {}
        for k, i in enumerate(window):
            peer = peers[(k + attempts.get(i, 0)) % len(peers)]
            asked[i] = peer.id()
            peer.try_send(
                STATESYNC_CHANNEL,
                _enc({"type": "chunk_request", "height": height, "index": i}),
            )
        deadline = time.monotonic() + self.chunk_timeout_s
        arrived: dict[int, tuple[str, bytes]] = {}
        answered: set[int] = set()  # incl. honest no_chunk — a window
        # whose every request is answered must not sit out the timeout
        answered_by: dict[int, str] = {}  # chunk -> actual RESPONDER
        with self._cv:
            while len(answered) < len(window) and self.is_running():
                for i in window:
                    if i in answered:
                        continue
                    entry = self._chunk_inbox.pop((height, i), None)
                    if entry is None:
                        continue
                    pid, payload = entry
                    answered.add(i)
                    answered_by[i] = pid
                    if payload is None:  # honest no_chunk
                        self._offers.get(height, set()).discard(pid)
                        self.chunk_failures += 1
                    else:
                        arrived[i] = (pid, payload)
                if len(answered) >= len(window) or time.monotonic() >= deadline:
                    break
                self._cv.wait(0.25)
            self._chunk_expect = set()
        # stall accounting: a request NOBODY answered (not
        # even a no_chunk) by the deadline strikes the peer it was asked
        # of; any answer clears the peer that ACTUALLY responded — never
        # the asked peer on someone else's answer, or a staller whose
        # chunks an accomplice keeps answering would launder its strikes
        # forever while the window still burned its timeout. A wait cut
        # short by the reactor STOPPING (not the deadline) strikes
        # nobody — an honest peer must not be banned at shutdown.
        for pid in answered_by.values():
            self._clear_stall(pid)
        if self.is_running() and time.monotonic() >= deadline:
            for i, pid in asked.items():
                if i not in answered_by:
                    self._note_stall(
                        pid, f"chunk {i} of snapshot {height}"
                    )
        if not arrived:
            self.chunk_failures += len(window)
            return {}
        items = sorted((i, payload) for i, (_pid, payload) in arrived.items())
        bad = set(
            verify_chunk_batch(manifest, items, hasher=self.restorer.hasher)
        )
        self.chunks_fetched += len(items) - len(bad)
        self.chunk_failures += len(bad)
        good: dict[int, bytes] = {}
        banned_this_pass: set[str] = set()
        for i, (pid, payload) in arrived.items():
            if i in bad:
                # the digest PROVES the peer served corrupt bytes for
                # the manifest it offered: penalize and refetch
                # elsewhere — ONCE per peer per pass, so a window of N
                # corrupt chunks counts one banned OFFERER, not N
                # (offerers_banned counts peers, the counter's contract)
                logger.warning(
                    "chunk %d of snapshot %d failed digest check; banning "
                    "peer %s", i, height, pid[:8],
                )
                if pid not in banned_this_pass:
                    banned_this_pass.add(pid)
                    self._ban_peer(
                        pid, f"statesync chunk {i} digest mismatch",
                        kind="corrupt",
                    )
            else:
                good[i] = payload
                self._save_scratch(height, i, payload)
        return good

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        out = {
            "restore_active": self.restore_active,
            "chunks_fetched": self.chunks_fetched,
            "chunk_failures": self.chunk_failures,
            "peers_banned": self.peers_banned,
            "offers_seen": self.offers_seen,
            # adversarial-offerer bans by proven kind
            "offerers_banned": self.offerers_banned,
            "offerer_bans_forged": self.offerer_bans_forged,
            "offerer_bans_corrupt": self.offerer_bans_corrupt,
            "offerer_bans_stall": self.offerer_bans_stall,
            **self.store.stats(),
        }
        if self.restorer is not None:
            out.update(self.restorer.stats())
        return out
