"""Crash recovery (reference: consensus/replay.go).

Two tiers, run in order on node start (SURVEY.md §3.5):
1. ABCI handshake (Handshaker): query the app's (height, hash) via Info,
   then replay committed blocks from the store until app, state, and
   store agree — including the delicate "committed to app but state not
   saved" case, replayed against a mock app built from the saved
   ABCIResponses so the real app never sees Commit twice
   (consensus/replay.go:180-403).
2. WAL catchup (catchup_replay): feed every WAL line since the last
   #ENDHEIGHT marker back through the consensus state machine; the
   priv-validator's double-sign guard makes re-signing idempotent
   (consensus/replay.go:98-148).

Pipelined execution (docs/execution-pipeline.md): replay is
SERIAL by contract — cs.replay_mode forces the inline finalize path, so
the WAL's single-thread total order is reproduced exactly. The pipeline
also widens the legal crash images this module must absorb: the WAL
``#ENDHEIGHT: H`` marker is written BEFORE the deferred apply of H runs,
so a crash leaves store=H, state=H-1, app=H-1 with the marker (and even
H+1 messages) on disk. That is the handshake's store==state+1 /
app==state case — `_apply_final_block` replays block H against the real
app — and catchup then resumes from the surviving marker as ever; no new
machinery, proven end to end by tests/test_wal_torture.py's
pipeline-stage crash cycles.
"""

from __future__ import annotations

import logging

from tendermint_tpu_torch.abci.types import Application, ResponseCommit, ResponseDeliverTx
from tendermint_tpu_torch.consensus.wal import decode_wal_line
from tendermint_tpu_torch.state import execution as sm
from tendermint_tpu_torch.types.services import MockMempool

logger = logging.getLogger("consensus.replay")


# -- tier 2: WAL catchup ------------------------------------------------------


def catchup_replay(cs, cs_height: int) -> None:
    """Replay WAL lines since the last height boundary through `cs`
    (consensus/replay.go:98-148). Call before the receive routine starts."""
    lines = cs.wal.lines_after_height(cs_height - 1)
    if lines is None:
        # The exact boundary can be legitimately gone after a tail repair
        # (a torn `#ENDHEIGHT: h` write is cut by wal.py's repair pass).
        # Fall back to the last surviving marker: the extra lines replayed
        # belong to heights <= cs_height-1, which the state machine drops
        # (wrong height) or the privval double-sign guard makes idempotent
        # — strictly more live than the reference's panic, and safe
        # (docs/crash-recovery.md "Repair semantics").
        fallback = cs.wal.lines_after_last_marker()
        if fallback is not None and fallback[0] < cs_height - 1:
            logger.warning(
                "WAL missing #ENDHEIGHT %d (tail repair?); replaying from "
                "surviving #ENDHEIGHT %d", cs_height - 1, fallback[0],
            )
            lines = fallback[1]
        elif cs_height > 1:
            raise RuntimeError(
                f"WAL has no #ENDHEIGHT for height {cs_height - 1}; cannot replay"
            )
        else:
            return  # fresh chain, nothing to replay
    replayed = 0
    cs.replay_mode = True
    try:
        for i, line in enumerate(lines):
            try:
                entry = decode_wal_line(line)
            except Exception as e:
                if i == len(lines) - 1:
                    # a truncated/corrupt FINAL line is the expected residue
                    # of a crash mid-write; everything before it replayed
                    logger.warning("skipping corrupt WAL tail line: %s", e)
                    break
                raise RuntimeError(
                    f"corrupt WAL line {i} (not at tail): {e}"
                ) from e
            if entry is None:
                continue
            kind = entry[0]
            if kind == "endheight":
                # a later ENDHEIGHT means this height completed; stop
                if entry[1] >= cs_height:
                    break
                continue
            if kind == "event":
                continue  # step markers are for sanity only
            if kind == "msg_info":
                from tendermint_tpu_torch.consensus.state import MsgInfo

                _, msg, peer_id = entry
                cs.handle_msg(MsgInfo(msg, peer_id))
            elif kind == "timeout":
                cs.handle_timeout(entry[1])
            replayed += 1
    finally:
        cs.replay_mode = False
    logger.info("replayed %d WAL messages for height %d", replayed, cs_height)


# -- tier 1: ABCI handshake ---------------------------------------------------


class HandshakeError(Exception):
    pass


class Handshaker:
    def __init__(self, state, store):
        self.state = state
        self.store = store
        self.n_blocks = 0  # blocks applied to the app (for tests)

    def handshake(self, proxy_app) -> None:
        """consensus/replay.go:194-226. proxy_app: AppConns."""
        res = proxy_app.query().info_sync()
        app_block_height = res.last_block_height
        app_hash = res.last_block_app_hash
        logger.info(
            "ABCI handshake: app height %d hash %s", app_block_height, app_hash.hex()[:12]
        )
        app_hash = self.replay_blocks(app_hash, app_block_height, proxy_app)
        self.state.app_hash = app_hash

    def replay_blocks(self, app_hash: bytes, app_block_height: int, proxy_app) -> bytes:
        """The (storeH, stateH, appH) case analysis
        (consensus/replay.go:230-301)."""
        store_height = self.store.height()
        state_height = self.state.last_block_height
        logger.info(
            "replay_blocks: store %d state %d app %d",
            store_height, state_height, app_block_height,
        )

        if app_block_height == 0:
            # fresh app: play genesis validators via InitChain
            from tendermint_tpu_torch.types.protobuf import tm2pb_validators

            validators = tm2pb_validators(self.state.genesis_doc.validators)
            proxy_app.consensus().init_chain_sync(validators)

        if store_height == 0:
            return app_hash

        if store_height < state_height:
            raise HandshakeError(f"store height {store_height} < state height {state_height}")
        if store_height > state_height + 1:
            raise HandshakeError(
                f"store height {store_height} > state height {state_height}+1"
            )

        if store_height == state_height:
            # chain and state agree; bring the app up to them
            if app_block_height < store_height:
                return self._replay_through_app(app_block_height, store_height, proxy_app, False)
            if app_block_height == store_height:
                return app_hash
            raise HandshakeError(
                f"app height {app_block_height} > store height {store_height}"
            )

        # store == state + 1: we crashed between SaveBlock and state.save
        if app_block_height < state_height:
            # app even further behind: replay up to state height, then the
            # final block with the real app
            app_hash = self._replay_through_app(app_block_height, store_height, proxy_app, True)
            return app_hash
        if app_block_height == state_height:
            # app committed through the state height; apply the last block
            # fully (updates state) with the real app
            return self._apply_final_block(proxy_app)
        if app_block_height == store_height:
            # app already has the last block but our state doesn't: replay
            # it against a mock app fed the saved ABCIResponses, so the
            # real app never re-executes (consensus/replay.go:280-295)
            responses = self.state.load_abci_responses()
            if responses is None:
                raise HandshakeError("missing saved ABCIResponses for final block replay")
            mock_conn = _mock_proxy_conn(responses, app_hash)
            self._apply_block(mock_conn, store_height)
            return app_hash
        raise HandshakeError(f"unexpected app height {app_block_height}")

    def _replay_through_app(
        self, app_block_height: int, store_height: int, proxy_app, mutate_state: bool
    ) -> bytes:
        """Replay blocks appH+1..storeH against the real app without state
        mutation, except possibly the final one (consensus/replay.go:303-337)."""
        app_hash = b""
        final_block = store_height if not mutate_state else store_height - 1
        for h in range(app_block_height + 1, final_block + 1):
            logger.info("applying block %d to the app", h)
            block = self.store.load_block(h)
            app_hash = sm.exec_commit_block(proxy_app.consensus(), block)
            self.n_blocks += 1
        if mutate_state:
            # final block gets the full ApplyBlock treatment
            return self._apply_final_block(proxy_app)
        return app_hash

    def _apply_final_block(self, proxy_app) -> bytes:
        return self._apply_block(proxy_app.consensus(), self.store.height())

    def _apply_block(self, consensus_conn, height: int) -> bytes:
        block = self.store.load_block(height)
        meta = self.store.load_block_meta(height)
        event_cache = _NullCache()
        sm.apply_block(
            self.state, event_cache, consensus_conn, block,
            meta.block_id.parts_header, MockMempool(),
        )
        self.n_blocks += 1
        return self.state.app_hash


class _NullCache:
    def fire_event(self, event, data):
        pass

    def flush(self):
        pass


# -- mock app built from saved ABCIResponses ---------------------------------


class _MockReplayApp(Application):
    """Replays recorded DeliverTx/Commit results (consensus/replay.go:367-403)."""

    def __init__(self, responses, app_hash: bytes):
        self._responses = responses
        self._app_hash = app_hash
        self._tx_index = 0

    def deliver_tx(self, tx: bytes) -> ResponseDeliverTx:
        r = self._responses.deliver_tx[self._tx_index]
        self._tx_index += 1
        return r or ResponseDeliverTx()

    def end_block(self, height: int):
        return self._responses.end_block

    def commit(self) -> ResponseCommit:
        return ResponseCommit(data=self._app_hash)


def _mock_proxy_conn(responses, app_hash: bytes):
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus

    return AppConnConsensus(LocalClient(_MockReplayApp(responses, app_hash)))
