"""Consensus gossip reactor (reference: consensus/reactor.go).

Four p2p channels (reactor.go:21-24):
  0x20 STATE       — NewRoundStep / CommitStep / HasVote / ProposalHeartbeat
  0x21 DATA        — Proposal / ProposalPOL / BlockPart
  0x22 VOTE        — Vote
  0x23 VOTE_SET_BITS — VoteSetMaj23 / VoteSetBits

Each peer gets a mirrored PeerRoundState and three gossip threads
(reactor.go:133-135): gossip_data (block parts + catch-up), gossip_votes
(needed-vote picker), query_maj23. Step transitions and new votes are
broadcast event-driven via the event switch (reactor.go:321-337).

The port's copy of the JAX package's `consensus/reactor.py`. One
difference: a device error (ops.gateway.DeviceError) raised in `receive`
(today only the aggregate catch-up screen's verify) stops the consensus
state as its receive routine's own would
(ConsensusState.stop_on_device_error), and the peer that sent the message
stays connected. Decoding errors and forged or sub-quorum commits still
stop the peer.
"""

from __future__ import annotations

import json
import random
import threading
import time

from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus.round_state import RoundStep
from tendermint_tpu_torch.libs.bitarray import BitArray
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.ops.gateway import DeviceError
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor
from tendermint_tpu_torch.p2p.switch import Reactor
from tendermint_tpu_torch.types import events as tev
from tendermint_tpu_torch.types.agg_commit import AggregateLastCommit, commit_is_aggregate
from tendermint_tpu_torch.types.validator_set import CommitError
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

PEER_GOSSIP_SLEEP = 0.1  # reactor.go peerGossipSleepDuration
PEER_QUERY_MAJ23_SLEEP = 2.0
# lazy-relay hold (gossip_dedup): a vote we RECEIVED moments
# ago is being fanned out by its origin right now, and every recipient
# announces it via HasVote within the same window — re-pushing it
# immediately is how k relayers race each other into the 2NxN
# redundancy. One gossip tick is enough for those announcements to set
# the mirror bit (ms on loopback, ~one link RTT under WAN); after it,
# anything still unmarked is genuinely needed and relays normally.
VOTE_RELAY_DELAY = PEER_GOSSIP_SLEEP
# RTT-adaptive hold: the window that lets HasVote
# announcements win the relay race is ~one link RTT — on a fast LAN the
# 0.1 s constant over-holds (announcements land in ms), under a slow WAN
# it under-holds (re-pushes fire before the announcement arrives). When
# ping RTT samples exist (the p2p ping_rtt EWMA), the hold tracks 2x the
# smoothed RTT (ping->pong is a full round trip; the announcement needs
# one leg each way too), clamped to [0.5x, 4x] of the constant so a
# garbage sample can neither disable the hold nor stall relays. The
# constant remains the exact no-sample fallback.
VOTE_RELAY_DELAY_MIN = 0.5 * VOTE_RELAY_DELAY
VOTE_RELAY_DELAY_MAX = 4.0 * VOTE_RELAY_DELAY

PEER_STATE_KEY = "ConsensusReactor.peerState"


def adaptive_relay_delay(rtt_s: float | None) -> float:
    """The lazy-relay hold for a smoothed peer RTT: None (no samples
    yet) keeps the VOTE_RELAY_DELAY constant; otherwise 2x the RTT
    clamped into [VOTE_RELAY_DELAY_MIN, VOTE_RELAY_DELAY_MAX]."""
    if rtt_s is None:
        return VOTE_RELAY_DELAY
    return min(VOTE_RELAY_DELAY_MAX, max(VOTE_RELAY_DELAY_MIN, 2.0 * rtt_s))


def _enc(msg) -> bytes:
    return json.dumps(msgs.msg_to_json(msg), sort_keys=True).encode()


def _dec(raw: bytes):
    return msgs.msg_from_json(json.loads(raw.decode()))


class PeerRoundState:
    """What we believe the peer's consensus state is (reactor.go:757-773)."""

    def __init__(self):
        self.height = 0
        self.round_ = -1
        self.step = RoundStep.NEW_HEIGHT
        self.start_time = 0.0
        self.proposal = False
        self.proposal_block_parts_header: PartSetHeader | None = None
        self.proposal_block_parts: BitArray | None = None
        self.proposal_pol_round = -1
        self.proposal_pol: BitArray | None = None
        self.prevotes: BitArray | None = None
        self.precommits: BitArray | None = None
        self.last_commit_round = -1
        self.last_commit: BitArray | None = None
        self.catchup_commit_round = -1
        self.catchup_commit: BitArray | None = None


def _peer_label(peer) -> str:
    """Best-effort peer id for metric labels ("?" for harness stubs)."""
    try:
        return peer.id()
    except Exception:  # noqa: BLE001 — labels must never break gossip
        return "?"


class PeerState:
    """Thread-safe mirror + vote bookkeeping for one peer
    (reactor.go:778-1060)."""

    def __init__(self, peer):
        self.peer = peer
        self.prs = PeerRoundState()
        self._mtx = threading.RLock()
        # per-peer gossip instrumentation: child series resolved once —
        # picks vs successful sends is the signal of a
        # pick-marks-before-send wedge
        from tendermint_tpu_torch.p2p.telemetry import peer_metrics

        fams = peer_metrics(getattr(peer, "metrics_registry", None))
        pid = _peer_label(peer)
        self.m_vote_picks = fams["vote_gossip_picks"].labels(peer=pid)
        self.m_vote_sends = fams["vote_gossip_sends"].labels(peer=pid)
        self.m_vote_send_failures = fams["vote_gossip_send_failures"].labels(
            peer=pid
        )
        self.m_catchup_commits = fams["catchup_commits"].labels(peer=pid)
        # aggregate catchup: one whole-commit send per lagging
        # height, re-armed after a hold so a lost frame can't wedge the
        # peer — (height, monotonic send time) of the last send
        self._agg_commit_sent: tuple[int, float] | None = None

    # -- reads -------------------------------------------------------------

    def get_round_state(self) -> PeerRoundState:
        with self._mtx:
            import copy

            return copy.copy(self.prs)

    def get_height(self) -> int:
        with self._mtx:
            return self.prs.height

    # -- proposal/parts ----------------------------------------------------

    def set_has_proposal(self, proposal) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != proposal.height or prs.round_ != proposal.round_:
                return
            if prs.proposal:
                return
            prs.proposal = True
            prs.proposal_block_parts_header = proposal.block_parts_header
            prs.proposal_block_parts = BitArray(proposal.block_parts_header.total)
            prs.proposal_pol_round = proposal.pol_round
            prs.proposal_pol = None  # until ProposalPOLMessage arrives

    def set_has_proposal_block_part(self, height: int, round_: int, index: int) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != height or prs.round_ != round_:
                return
            if prs.proposal_block_parts is None:
                return
            prs.proposal_block_parts.set_index(index, True)

    def apply_proposal_pol(self, msg: msgs.ProposalPOLMessage) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != msg.height or prs.proposal_pol_round != msg.proposal_pol_round:
                return
            prs.proposal_pol = msg.proposal_pol

    # -- votes -------------------------------------------------------------

    def set_has_vote(self, height: int, round_: int, type_: int, index: int) -> bool:
        """Mark the peer as holding a vote. Returns True when a tracking
        array existed and the bit landed — False means the coordinates
        matched no array (wrong height/round for this mirror) and the
        information was dropped."""
        with self._mtx:
            ba = self._get_vote_bit_array(height, round_, type_)
            if ba is not None:
                ba.set_index(index, True)
                return True
            return False

    def _get_vote_bit_array(self, height: int, round_: int, type_: int) -> BitArray | None:
        """reactor.go:813-850 — except the round-equal branch must not
        SHADOW the catchup branch with a None: for a peer lagging far
        behind, nothing ever ensures bit arrays at the PEER's height
        (gossip ensures them at OUR heights), so prs.precommits is None
        there and the stored-commit catchup picker would never find a
        tracking array (a chaos-soak stall)."""
        prs = self.prs
        if prs.height == height:
            if prs.round_ == round_:
                ba = prs.prevotes if type_ == VOTE_TYPE_PREVOTE else prs.precommits
                if ba is not None:
                    return ba
            if prs.catchup_commit_round == round_ and type_ == VOTE_TYPE_PRECOMMIT:
                return prs.catchup_commit
            if prs.proposal_pol_round == round_ and type_ == VOTE_TYPE_PREVOTE:
                return prs.proposal_pol
            return None
        if prs.height == height + 1 and prs.last_commit_round == round_ and \
           type_ == VOTE_TYPE_PRECOMMIT:
            return prs.last_commit
        return None

    def ensure_vote_bit_arrays(self, height: int, num_validators: int) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height == height:
                if prs.prevotes is None:
                    prs.prevotes = BitArray(num_validators)
                if prs.precommits is None:
                    prs.precommits = BitArray(num_validators)
                if prs.proposal_pol is None and prs.proposal_pol_round >= 0:
                    prs.proposal_pol = BitArray(num_validators)
                if prs.catchup_commit is None and prs.catchup_commit_round >= 0:
                    prs.catchup_commit = BitArray(num_validators)
            elif prs.height == height + 1:
                if prs.last_commit is None:
                    prs.last_commit = BitArray(num_validators)

    def ensure_catchup_commit_round(self, height: int, round_: int, num_validators: int) -> None:
        """reactor.go:855-873."""
        with self._mtx:
            prs = self.prs
            if prs.height != height or round_ < 0:
                return
            if prs.catchup_commit_round == round_:
                return
            prs.catchup_commit_round = round_
            self.m_catchup_commits.inc()
            # alias the live precommit array only when it EXISTS; a
            # far-behind peer's mirror has none at its own height, and
            # aliasing None here left the catchup picker with no
            # tracking array at all (it must be a fresh BitArray then)
            prs.catchup_commit = (
                prs.precommits
                if prs.round_ == round_ and prs.precommits is not None
                else BitArray(num_validators)
            )

    def pick_vote_to_send(self, vote_set) -> object | None:
        """A random vote the peer needs from `vote_set` (reactor.go:899-933).

        Does NOT mark the peer as having it — the caller marks via
        set_has_vote only AFTER peer.send succeeds (reactor.go's
        PickSendVote order). Marking at pick time meant a vote whose
        send failed on a full channel queue (exactly the burst-load
        moment) was skipped for that peer FOREVER — no other mechanism
        resends it, and a 2-2 height split could wedge the whole net
        (the netchaos smoke's stall signature)."""
        if vote_set is None or vote_set.size() == 0:
            return None
        with self._mtx:
            ps_bits = self._get_vote_bit_array(
                vote_set.height, vote_set.round_, vote_set.type_
            )
            if ps_bits is None:
                return None
            needed = vote_set.bit_array().sub(ps_bits)
            if needed.is_empty():
                return None
            index, ok = needed.pick_random()
            if not ok:
                return None
            return vote_set.get_by_index(index)

    def agg_commit_due(self, height: int, hold: float = 1.0) -> bool:
        """Whether the aggregate catchup commit for `height` should be
        (re)sent to this peer: never sent, sent for another height, or
        sent over `hold` seconds ago with the peer still stuck there."""
        with self._mtx:
            sent = self._agg_commit_sent
            if sent is None or sent[0] != height:
                return True
            return time.monotonic() - sent[1] >= hold

    def mark_agg_commit_sent(self, height: int) -> None:
        with self._mtx:
            self._agg_commit_sent = (height, time.monotonic())

    # -- step transitions --------------------------------------------------

    def apply_new_round_step(self, msg: msgs.NewRoundStepMessage) -> None:
        """reactor.go:1046-1090."""
        with self._mtx:
            prs = self.prs
            psheight, psround, psstep = prs.height, prs.round_, prs.step
            # stale/duplicate guard (reactor.go:1050-1053): a reordered or
            # replayed step message must never move peer state backwards —
            # without this, an attacker replaying an old NewRoundStep wipes
            # the vote bit-arrays we track for the peer
            if (msg.height, msg.round_, msg.step) <= (psheight, psround, int(psstep)):
                return
            ps_catchup_round = prs.catchup_commit_round
            ps_catchup = prs.catchup_commit

            ps_precommits = prs.precommits  # before the reset below

            prs.height = msg.height
            prs.round_ = msg.round_
            prs.step = msg.step
            prs.start_time = time.time() - msg.seconds_since_start_time
            if psheight != msg.height or psround != msg.round_:
                prs.proposal = False
                prs.proposal_block_parts_header = None
                prs.proposal_block_parts = None
                prs.proposal_pol_round = -1
                prs.proposal_pol = None
                prs.prevotes = None
                prs.precommits = None
            if psheight == msg.height and psround != msg.round_ and \
               msg.round_ == ps_catchup_round:
                prs.precommits = ps_catchup
            if psheight != msg.height:
                # shift the H-precommits the peer had to last_commit
                if psheight + 1 == msg.height and psround == msg.last_commit_round:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = ps_precommits
                else:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = None
                prs.catchup_commit_round = -1
                prs.catchup_commit = None

    def apply_commit_step(self, msg: msgs.CommitStepMessage) -> None:
        with self._mtx:
            prs = self.prs
            if prs.height != msg.height:
                return
            prs.proposal_block_parts_header = msg.block_parts_header
            prs.proposal_block_parts = msg.block_parts

    def apply_has_vote(self, msg: msgs.HasVoteMessage,
                       allow_last_commit: bool = False) -> bool:
        """Feed a HasVote announcement into the mirror. The strict gate
        (peer height only) is the behavior without dedup; with
        allow_last_commit (the gossip_dedup knob) a HasVote for the
        height BELOW the peer's also lands — _get_vote_bit_array routes
        it to the last_commit array, which is exactly the height a node
        keeps broadcasting HasVotes for right after committing (those
        announcements were silently dropped before, so the laggard's
        commit votes kept being re-pushed by everyone)."""
        with self._mtx:
            if self.prs.height != msg.height and not (
                allow_last_commit and self.prs.height == msg.height + 1
            ):
                return False
        return self.set_has_vote(msg.height, msg.round_, msg.type_, msg.index)

    def apply_vote_set_bits(self, msg: msgs.VoteSetBitsMessage, our_votes: BitArray | None) -> None:
        """reactor.go:1126-1149. ourVotes is a MASK of what we know we
        hold for that BlockID: keep the peer-bits that aren't ours, OR in
        the peer's report, and REPLACE — never mark the peer as having
        votes only we hold."""
        with self._mtx:
            ba = self._get_vote_bit_array(msg.height, msg.round_, msg.type_)
            if ba is None:
                return
            if our_votes is not None:
                ba.update(ba.sub(our_votes).or_(msg.votes))
            else:
                ba.update(msg.votes)


class ConsensusReactor(Reactor, BaseService):
    def __init__(self, consensus_state, fast_sync: bool = False):
        BaseService.__init__(self, name="consensus.reactor")
        self.con_s = consensus_state
        self.fast_sync = fast_sync
        self.evsw = None
        self._peer_threads: dict[str, list] = {}
        self._peer_stops: dict[str, threading.Event] = {}
        self._mtx = threading.Lock()
        # has-vote-aware gossip dedup: when on, STATE-channel
        # HasVotes ensure the tracking arrays before applying (a fresh
        # height's first announcement window was silently dropped
        # before), last-commit-height HasVotes land, local part adds
        # broadcast HasBlockPart screens, and the vote pick loops hold
        # re-pushes of just-received votes for one gossip tick so the
        # announcements can set the mirror bits first (_relay_ready).
        # Off restores the gossip without dedup for the before/after
        # bench.
        self.gossip_dedup = bool(
            getattr(consensus_state.config, "gossip_dedup", True)
        )
        # flat dedup accounting (consensus_gossip_* on both surfaces)
        self.has_votes_applied = 0
        self.part_announces_sent = 0
        self.part_announces_applied = 0
        # aggregate-format catchup accounting (docs/upgrade.md)
        self.agg_commits_sent = 0      # whole-commit catchup sends
        self.agg_commits_rejected = 0  # forged/sub-quorum screened out

    # -- wiring ------------------------------------------------------------

    def set_event_switch(self, evsw) -> None:
        """Subscribe broadcast triggers (reactor.go:321-337)."""
        self.evsw = evsw
        evsw.add_listener_for_event(
            "conR", tev.EVENT_NEW_ROUND_STEP, lambda _d: self._broadcast_step()
        )
        evsw.add_listener_for_event(
            "conR", tev.EVENT_VOTE, lambda d: self._broadcast_has_vote(d.vote)
        )
        evsw.add_listener_for_event(
            "conR",
            tev.EVENT_PROPOSAL_BLOCK_PART,
            lambda d: self._broadcast_has_part(d),
        )
        evsw.add_listener_for_event(
            "conR",
            tev.EVENT_PROPOSAL_HEARTBEAT,
            lambda d: self._broadcast_heartbeat(d.heartbeat),
        )

    # -- Reactor interface -------------------------------------------------

    def get_channels(self) -> list[ChannelDescriptor]:
        from tendermint_tpu_torch.types.params import MAX_BLOCK_PART_SIZE_BYTES

        # recv_message_capacity right-sized per channel: the
        # default 21 MiB is the BLOCK ceiling — on the consensus
        # channels the largest legal messages are a block part at the
        # params-validated MAX_BLOCK_PART_SIZE_BYTES bound (hex-doubled
        # + proof inside JSON — the DATA cap derives from that bound)
        # and sub-KiB steps/votes/bitarrays. Before this, an
        # oversized-frame peer could park 21 MiB of never-delivered
        # reassembly bytes on EVERY channel of every connection
        # (~147 MiB per hostile peer); now an over-claim errors the
        # peer at the right-sized bound.
        return [
            ChannelDescriptor(id=STATE_CHANNEL, priority=5, send_queue_capacity=100,
                              recv_message_capacity=1 << 16),
            ChannelDescriptor(
                id=DATA_CHANNEL, priority=10, send_queue_capacity=100,
                recv_buffer_capacity=50 * 4096,
                # 2x for hex + proof steps / envelope headroom
                recv_message_capacity=2 * MAX_BLOCK_PART_SIZE_BYTES + (1 << 16),
            ),
            ChannelDescriptor(
                id=VOTE_CHANNEL, priority=5, send_queue_capacity=100,
                recv_buffer_capacity=100 * 100,
                recv_message_capacity=1 << 16,
            ),
            ChannelDescriptor(
                id=VOTE_SET_BITS_CHANNEL, priority=1, send_queue_capacity=2,
                recv_buffer_capacity=1024,
                recv_message_capacity=1 << 16,
            ),
        ]

    def add_peer(self, peer) -> None:
        ps = PeerState(peer)
        peer.set(PEER_STATE_KEY, ps)
        stop = threading.Event()
        threads = []
        for fn, nm in (
            (self._gossip_data_routine, "gossipData"),
            (self._gossip_votes_routine, "gossipVotes"),
            (self._query_maj23_routine, "queryMaj23"),
        ):
            t = threading.Thread(
                target=fn, args=(peer, ps, stop), daemon=True,
                name=f"conR.{nm}:{peer.id()[:8]}",
            )
            threads.append(t)
        with self._mtx:
            self._peer_stops[peer.id()] = stop
            self._peer_threads[peer.id()] = threads
        for t in threads:
            t.start()
        # tell the new peer our current state
        if not self.fast_sync:
            for m in self._round_step_messages():
                peer.send(STATE_CHANNEL, _enc(m))

    def remove_peer(self, peer, reason) -> None:
        with self._mtx:
            stop = self._peer_stops.pop(peer.id(), None)
            self._peer_threads.pop(peer.id(), None)
        if stop:
            stop.set()

    def receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        """reactor.go:159-302. A device error stops consensus, not the
        peer."""
        try:
            self._receive(ch_id, peer, msg_bytes)
        except DeviceError as exc:
            self.con_s.stop_on_device_error(exc)

    def _receive(self, ch_id: int, peer, msg_bytes: bytes) -> None:
        if not self.is_running():
            return
        try:
            msg = _dec(msg_bytes)
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as exc:
            self.switch.stop_peer_for_error(peer, exc)
            return
        ps: PeerState | None = peer.get(PEER_STATE_KEY)
        if ps is None:
            return

        if ch_id == STATE_CHANNEL:
            if isinstance(msg, msgs.NewRoundStepMessage):
                ps.apply_new_round_step(msg)
            elif isinstance(msg, msgs.CommitStepMessage):
                ps.apply_commit_step(msg)
            elif isinstance(msg, msgs.HasVoteMessage):
                if self.gossip_dedup:
                    # ensure the tracking arrays BEFORE applying — at a
                    # fresh height the mirror has none yet, and every
                    # HasVote in that first window used to vanish into
                    # the set_has_vote no-op (the biggest single source
                    # of the 2NxN duplicate pushes: peers kept picking
                    # votes the neighbor had announced long ago)
                    rs = self.con_s.get_round_state()
                    size = rs.validators.size() if rs.validators else 0
                    last_size = rs.last_commit.size() if rs.last_commit else 0
                    ps.ensure_vote_bit_arrays(rs.height, size)
                    ps.ensure_vote_bit_arrays(rs.height - 1, last_size)
                if ps.apply_has_vote(msg, allow_last_commit=self.gossip_dedup):
                    self.has_votes_applied += 1
            elif isinstance(msg, msgs.HasBlockPartMessage):
                # part dedup screen: the peer announced a part
                # it holds — mark the mirror so gossip_data skips it
                # (applied regardless of our own knob: the information
                # is free and only ever REDUCES redundant sends)
                ps.set_has_proposal_block_part(msg.height, msg.round_, msg.index)
                self.part_announces_applied += 1
            elif isinstance(msg, msgs.ProposalHeartbeatMessage):
                self.con_s._fire(
                    tev.EVENT_PROPOSAL_HEARTBEAT,
                    tev.EventDataProposalHeartbeat(msg.heartbeat),
                )
            elif isinstance(msg, msgs.VoteSetMaj23Message):
                self._handle_vote_set_maj23(peer, ps, msg)
            else:
                self.switch.stop_peer_for_error(peer, f"bad state msg {type(msg)}")
        elif ch_id == DATA_CHANNEL:
            if self.fast_sync:
                return
            if isinstance(msg, msgs.ProposalMessage):
                ps.set_has_proposal(msg.proposal)
                self.con_s.add_peer_message(msg, peer.id())
            elif isinstance(msg, msgs.ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
            elif isinstance(msg, msgs.BlockPartMessage):
                ps.set_has_proposal_block_part(msg.height, msg.round_, msg.part.index)
                self.con_s.add_peer_message(msg, peer.id())
            elif isinstance(msg, msgs.AggregateCommitMessage):
                if self._screen_agg_commit(peer, msg):
                    self.con_s.add_peer_message(msg, peer.id())
            else:
                self.switch.stop_peer_for_error(peer, f"bad data msg {type(msg)}")
        elif ch_id == VOTE_CHANNEL:
            if self.fast_sync:
                return
            if isinstance(msg, msgs.VoteMessage):
                rs = self.con_s.get_round_state()
                height = rs.height
                size = rs.validators.size() if rs.validators else 0
                # the height-1 array tracks LastCommit votes, whose set can
                # differ in size from the current one (reactor.go:291-296
                # uses cs.LastCommit.Size(), not cs.Validators.Size())
                last_size = rs.last_commit.size() if rs.last_commit else 0
                ps.ensure_vote_bit_arrays(height, size)
                ps.ensure_vote_bit_arrays(height - 1, last_size)
                ps.set_has_vote(
                    msg.vote.height, msg.vote.round_, msg.vote.type_,
                    msg.vote.validator_index,
                )
                self.con_s.add_peer_message(msg, peer.id())
            else:
                self.switch.stop_peer_for_error(peer, f"bad vote msg {type(msg)}")
        elif ch_id == VOTE_SET_BITS_CHANNEL:
            if self.fast_sync:
                return
            if isinstance(msg, msgs.VoteSetBitsMessage):
                rs = self.con_s.get_round_state()
                if rs.height == msg.height and rs.votes is not None:
                    vs = (
                        rs.votes.prevotes(msg.round_)
                        if msg.type_ == VOTE_TYPE_PREVOTE
                        else rs.votes.precommits(msg.round_)
                    )
                    ours = vs.bit_array_by_block_id(msg.block_id) if vs else None
                else:
                    ours = None
                ps.apply_vote_set_bits(msg, ours)
            else:
                self.switch.stop_peer_for_error(peer, f"bad bits msg {type(msg)}")

    def _screen_agg_commit(self, peer, msg: msgs.AggregateCommitMessage) -> bool:
        """Verify a received aggregate catchup commit on the peer thread
        BEFORE it reaches the consensus queue: a forged or sub-quorum
        aggregate is a peer error (stop_peer_for_error) — the aggregate
        form makes the whole commit one signature check, so the screen
        costs one gateway batch, not N serial verifies. True = enqueue
        for the consensus thread (which re-verifies: WAL replay must
        re-derive the verdict). A device error in the verify is no peer
        error: it leaves here for `receive`."""
        rs = self.con_s.get_round_state()
        if msg.height != msg.commit.height():
            self.switch.stop_peer_for_error(
                peer, "aggregate commit message height mismatch"
            )
            return False
        if msg.height != rs.height or rs.validators is None:
            return False  # stale (we moved on) or not ready — drop quietly
        err = msg.commit.validate_basic()
        if err is None:
            try:
                msg.commit.verify(self.con_s.state.chain_id, rs.validators)
            except CommitError as exc:
                err = str(exc)
        if err is not None:
            self.agg_commits_rejected += 1
            fr = getattr(self.con_s, "flightrec", None)
            if fr is not None:
                fr.record("agg_commit_reject", height=msg.height,
                          err=err, peer=_peer_label(peer))
            self.switch.stop_peer_for_error(
                peer, f"bad aggregate commit: {err}"
            )
            return False
        return True

    def _handle_vote_set_maj23(self, peer, ps: PeerState, msg: msgs.VoteSetMaj23Message) -> None:
        """reactor.go:230-263: record the claim, respond with our bits."""
        rs = self.con_s.get_round_state()
        if rs.height != msg.height or rs.votes is None:
            return
        rs.votes.set_peer_maj23(msg.round_, msg.type_, peer.id(), msg.block_id)
        vs = (
            rs.votes.prevotes(msg.round_)
            if msg.type_ == VOTE_TYPE_PREVOTE
            else rs.votes.precommits(msg.round_)
        )
        ours = vs.bit_array_by_block_id(msg.block_id) if vs else None
        if ours is None:
            return
        peer.try_send(
            VOTE_SET_BITS_CHANNEL,
            _enc(
                msgs.VoteSetBitsMessage(
                    msg.height, msg.round_, msg.type_, msg.block_id, ours
                )
            ),
        )

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        if not self.fast_sync:
            self.con_s.start()

    def on_stop(self) -> None:
        self.con_s.stop()
        with self._mtx:
            stops = list(self._peer_stops.values())
        for s in stops:
            s.set()

    def switch_to_consensus(self, state) -> None:
        """Fast sync complete (reactor.go:78-90). Note: update BEFORE
        reconstruct (the NewConsensusState ordering, state.go:327-330) —
        the reactor's reconstruct-first ordering in the reference lets
        updateToState clobber the freshly rebuilt LastCommit to nil,
        which breaks proposing at the switch height."""
        self.logger.info("switching to consensus at height %d", state.last_block_height + 1)
        self.con_s.update_to_state(state.copy())
        if state.last_block_height > 0:
            self.con_s.reconstruct_last_commit(state)
        self.fast_sync = False
        self.con_s.start()

    # -- broadcasts --------------------------------------------------------

    def _round_step_messages(self) -> list:
        rs = self.con_s.get_round_state()
        out = [
            msgs.NewRoundStepMessage(
                height=rs.height,
                round_=rs.round_,
                step=rs.step,
                seconds_since_start_time=int(time.time() - rs.start_time),
                last_commit_round=rs.last_commit.round_ if rs.last_commit else -1,
            )
        ]
        if rs.step == RoundStep.COMMIT and rs.proposal_block_parts is not None:
            out.append(
                msgs.CommitStepMessage(
                    height=rs.height,
                    block_parts_header=rs.proposal_block_parts.header(),
                    block_parts=rs.proposal_block_parts.bit_array(),
                )
            )
        return out

    def _broadcast_step(self) -> None:
        if not hasattr(self, "switch") or self.switch is None:
            return
        for m in self._round_step_messages():
            self.switch.broadcast(STATE_CHANNEL, _enc(m))

    def _broadcast_has_vote(self, vote) -> None:
        if not hasattr(self, "switch") or self.switch is None:
            return
        msg = msgs.HasVoteMessage(
            height=vote.height, round_=vote.round_, type_=vote.type_,
            index=vote.validator_index,
        )
        self.switch.broadcast(STATE_CHANNEL, _enc(msg))

    def _broadcast_has_part(self, data) -> None:
        """A part landed in OUR part-set — announce it so
        peers' mirrors mark the bit and their gossip_data loops stop
        picking it for us. try_send like the maj23 path: a full STATE
        queue drops the announcement (the part relay itself still dedups
        the hard way), it must never block the consensus thread firing
        the event."""
        if not self.gossip_dedup:
            return
        if not hasattr(self, "switch") or self.switch is None:
            return
        msg = msgs.HasBlockPartMessage(
            height=data.height, round_=data.round_, index=data.index
        )
        self.switch.broadcast(STATE_CHANNEL, _enc(msg))
        self.part_announces_sent += 1

    def _broadcast_heartbeat(self, heartbeat) -> None:
        if not hasattr(self, "switch") or self.switch is None:
            return
        self.switch.broadcast(
            STATE_CHANNEL, _enc(msgs.ProposalHeartbeatMessage(heartbeat))
        )

    # -- gossip_data (reactor.go:413-535) ----------------------------------

    def _gossip_data_routine(self, peer, ps: PeerState, stop: threading.Event) -> None:
        while self.is_running() and not stop.is_set():
            if self.fast_sync:
                stop.wait(PEER_GOSSIP_SLEEP)
                continue
            rs = self.con_s.get_round_state()
            prs = ps.get_round_state()
            # 1. send a block part the peer lacks
            if (
                rs.proposal_block_parts is not None
                and prs.proposal_block_parts is not None
                and rs.height == prs.height
                and rs.round_ == prs.round_
            ):
                have = rs.proposal_block_parts.bit_array()
                needed = have.sub(prs.proposal_block_parts)
                if not needed.is_empty():
                    index, ok = needed.pick_random()
                    if ok:
                        part = rs.proposal_block_parts.get_part(index)
                        msg = msgs.BlockPartMessage(rs.height, rs.round_, part)
                        if peer.send(DATA_CHANNEL, _enc(msg)):
                            ps.set_has_proposal_block_part(prs.height, prs.round_, index)
                        continue
            # 2. peer is on an older height: catch them up from the store
            if prs.height != 0 and rs.height > prs.height:
                if self._gossip_data_catchup(peer, ps, prs):
                    continue
                stop.wait(PEER_GOSSIP_SLEEP)
                continue
            # 3. send the proposal (+POL) if the peer doesn't have it
            if (
                rs.height == prs.height
                and rs.round_ == prs.round_
                and rs.proposal is not None
                and not prs.proposal
            ):
                if peer.send(DATA_CHANNEL, _enc(msgs.ProposalMessage(rs.proposal))):
                    ps.set_has_proposal(rs.proposal)
                if 0 <= rs.proposal.pol_round < rs.round_ and rs.votes is not None:
                    pol = rs.votes.prevotes(rs.proposal.pol_round)
                    if pol is not None:
                        peer.send(
                            DATA_CHANNEL,
                            _enc(
                                msgs.ProposalPOLMessage(
                                    rs.height, rs.proposal.pol_round, pol.bit_array()
                                )
                            ),
                        )
                continue
            stop.wait(PEER_GOSSIP_SLEEP)

    def _gossip_data_catchup(self, peer, ps: PeerState, prs: PeerRoundState) -> bool:
        """Send a part of a committed block (reactor.go:494-535)."""
        store = getattr(self.con_s, "block_store", None)
        if store is None:
            return False
        meta = store.load_block_meta(prs.height)
        if meta is None:
            return False
        if prs.proposal_block_parts is None:
            # init from the committed block's part-set header
            ps_header = meta.block_id.parts_header
            ps.apply_commit_step(
                msgs.CommitStepMessage(
                    height=prs.height,
                    block_parts_header=ps_header,
                    block_parts=BitArray(ps_header.total),
                )
            )
            return True
        if meta.block_id.parts_header != prs.proposal_block_parts_header:
            return False
        needed = prs.proposal_block_parts.not_()
        if needed.is_empty():
            return False
        index, ok = needed.pick_random()
        if not ok:
            return False
        part = store.load_block_part(prs.height, index)
        if part is None:
            return False
        msg = msgs.BlockPartMessage(prs.height, prs.round_, part)
        if peer.send(DATA_CHANNEL, _enc(msg)):
            ps.set_has_proposal_block_part(prs.height, prs.round_, index)
        return True

    # -- gossip_votes (reactor.go:537-645) ---------------------------------

    def _gossip_votes_routine(self, peer, ps: PeerState, stop: threading.Event) -> None:
        while self.is_running() and not stop.is_set():
            if self.fast_sync:
                stop.wait(PEER_GOSSIP_SLEEP)
                continue
            rs = self.con_s.get_round_state()
            prs = ps.get_round_state()
            if rs.validators is not None:
                ps.ensure_vote_bit_arrays(rs.height, rs.validators.size())
                # a peer lagging one height needs last-commit bit arrays
                # before pick_vote_to_send can track what it has
                if rs.last_validators is not None:
                    ps.ensure_vote_bit_arrays(
                        rs.height - 1, rs.last_validators.size()
                    )
            if self._pick_and_send_vote(peer, ps, rs, prs):
                continue
            stop.wait(PEER_GOSSIP_SLEEP)

    def _send_vote(self, peer, ps: PeerState, vote) -> bool:
        """Send one vote and, ONLY on success, mark the peer as having
        it (the vote carries its own coordinates). A failed send leaves
        the bit clear so the gossip loop retries it later — and counts
        on the per-peer failure series, so a wedge shows up as picks
        outrunning sends instead of a frozen height vector."""
        ps.m_vote_picks.inc()
        if peer.send(VOTE_CHANNEL, _enc(msgs.VoteMessage(vote))):
            ps.set_has_vote(
                vote.height, vote.round_, vote.type_, vote.validator_index
            )
            ps.m_vote_sends.inc()
            return True
        ps.m_vote_send_failures.inc()
        fr = getattr(getattr(self, "con_s", None), "flightrec", None)
        if fr is not None:
            # picks-without-sends IS the gossip-stall signature a wedge
            # dump must carry (node/flightrec.py)
            fr.record("gossip_send_fail", peer=_peer_label(peer))
        return False

    def _relay_delay(self) -> float:
        """The current lazy-relay hold: RTT-adaptive when the switch's
        registry carries ping RTT samples (adaptive_relay_delay), the
        VOTE_RELAY_DELAY constant otherwise — including for harness
        reactors with no switch at all."""
        reg = getattr(getattr(self, "switch", None), "metrics_registry",
                      None)
        if reg is None:
            return VOTE_RELAY_DELAY
        from tendermint_tpu_torch.p2p.telemetry import peer_metrics

        return adaptive_relay_delay(peer_metrics(reg)["ping_rtt_ewma"].value())

    def _relay_ready(self, vote) -> bool:
        """The lazy-relay screen: hold re-pushes of a vote we received
        less than _relay_delay() ago (VOTE_RELAY_DELAY, RTT-adapted when
        samples exist). Unstamped votes — our own, and store-backed
        catchup commits — relay immediately; a held vote stays pickable
        and goes out on a later tick if the peer's mirror bit is still
        clear then."""
        if not self.gossip_dedup:
            return True
        t = self.con_s.vote_recv_mono.get(
            (vote.height, vote.round_, vote.type_, vote.validator_index)
        )
        return t is None or time.monotonic() - t >= self._relay_delay()

    def _pick_and_send_vote(self, peer, ps: PeerState, rs, prs: PeerRoundState) -> bool:
        """One needed vote, if any (reactor.go:609-645 gossipVotesForHeight
        + same-height/lastCommit/catchup cases)."""
        # same height
        if rs.height == prs.height and rs.votes is not None:
            # peer is lagging in rounds: their POL prevotes
            if prs.step <= RoundStep.PROPOSE and prs.round_ != -1 and \
               prs.round_ <= rs.round_ and prs.proposal_pol_round != -1:
                pol = rs.votes.prevotes(prs.proposal_pol_round)
                vote = ps.pick_vote_to_send(pol) if pol else None
                if vote is not None and self._relay_ready(vote):
                    return self._send_vote(peer, ps, vote)
            if prs.step <= RoundStep.PREVOTE_WAIT and prs.round_ != -1 and \
               prs.round_ <= rs.round_:
                vote = ps.pick_vote_to_send(rs.votes.prevotes(prs.round_))
                if vote is not None and self._relay_ready(vote):
                    return self._send_vote(peer, ps, vote)
            if prs.step <= RoundStep.PRECOMMIT_WAIT and prs.round_ != -1 and \
               prs.round_ <= rs.round_:
                vote = ps.pick_vote_to_send(rs.votes.precommits(prs.round_))
                if vote is not None and self._relay_ready(vote):
                    return self._send_vote(peer, ps, vote)
            if prs.proposal_pol_round != -1:
                pol = rs.votes.prevotes(prs.proposal_pol_round)
                vote = ps.pick_vote_to_send(pol) if pol else None
                if vote is not None and self._relay_ready(vote):
                    return self._send_vote(peer, ps, vote)
        # peer is at our last height: send from our last commit. The
        # peer's CURRENT round usually raced past the commit round (it
        # entered a timeout round precisely because the commit votes
        # didn't reach it), so its prevote/precommit arrays track the
        # wrong round and _get_vote_bit_array would find NOTHING —
        # ensure the catchup-commit tracking array at the commit's round
        # first, exactly like the >= +2 stored-commit branch below. This
        # hole wedged 2-2 height splits permanently: the two ahead nodes
        # couldn't advance (no quorum at the new height), so the +2
        # branch never engaged, and the laggards never saw the commit.
        if rs.height == prs.height + 1 and rs.last_commit is not None:
            if isinstance(rs.last_commit, AggregateLastCommit):
                # our last commit exists only in aggregate form (we
                # ourselves finalized from a proof): no per-vote sends
                # possible — ship the whole commit
                return self._send_agg_commit(
                    peer, ps, prs.height, rs.last_commit.agg
                )
            if rs.last_validators is not None:
                ps.ensure_catchup_commit_round(
                    prs.height, rs.last_commit.round_,
                    rs.last_validators.size(),
                )
                prs = ps.get_round_state()
            vote = ps.pick_vote_to_send(rs.last_commit)
            if vote is not None and self._relay_ready(vote):
                return self._send_vote(peer, ps, vote)
        # peer is far behind: catch up with the stored seen-commit
        if rs.height >= prs.height + 2 and prs.height > 0:
            store = getattr(self.con_s, "block_store", None)
            if store is not None:
                commit = store.load_block_commit(prs.height)
                if commit is not None:
                    if commit_is_aggregate(commit):
                        # the stored commit IS the aggregate (post-flip
                        # heights, docs/upgrade.md): per-vote catchup is
                        # impossible — one AggregateCommitMessage carries
                        # the whole quorum
                        return self._send_agg_commit(
                            peer, ps, prs.height, commit
                        )
                    ps.ensure_catchup_commit_round(
                        prs.height, commit.round_(), len(commit.precommits)
                    )
                    vote = self._pick_commit_vote_to_send(ps, prs, commit)
                    if vote is not None:
                        return self._send_vote(peer, ps, vote)
        return False

    def _send_agg_commit(self, peer, ps: PeerState, height: int, agg) -> bool:
        """One whole-commit catchup send, per-peer deduplicated: the
        aggregate replaces N per-vote sends, so it goes out once per
        lagging height (re-armed after a short hold in case the frame
        was lost). Marks only on successful send, like _send_vote."""
        if not ps.agg_commit_due(height):
            return False
        msg = msgs.AggregateCommitMessage(height, agg)
        if peer.send(DATA_CHANNEL, _enc(msg)):
            ps.mark_agg_commit_sent(height)
            ps.m_catchup_commits.inc()
            self.agg_commits_sent += 1
            return True
        fr = getattr(self.con_s, "flightrec", None)
        if fr is not None:
            fr.record("gossip_send_fail", peer=_peer_label(peer))
        return False

    def _pick_commit_vote_to_send(self, ps: PeerState, prs: PeerRoundState, commit):
        """Catch-up votes come from a Commit, not a VoteSet. Like
        pick_vote_to_send, this does NOT mark — _send_vote marks only
        after the send actually succeeds."""
        with ps._mtx:
            ba = ps._get_vote_bit_array(prs.height, commit.round_(), VOTE_TYPE_PRECOMMIT)
            if ba is None:
                return None
            have = BitArray.from_indices(
                len(commit.precommits),
                [i for i, pc in enumerate(commit.precommits) if pc is not None],
            )
            needed = have.sub(ba)
            if needed.is_empty():
                return None
            index, ok = needed.pick_random()
            if not ok:
                return None
            return commit.precommits[index]

    # -- query_maj23 (reactor.go:647-739) ----------------------------------

    def _query_maj23_routine(self, peer, ps: PeerState, stop: threading.Event) -> None:
        while self.is_running() and not stop.is_set():
            stop.wait(PEER_QUERY_MAJ23_SLEEP)
            if self.fast_sync or not self.is_running() or stop.is_set():
                continue
            rs = self.con_s.get_round_state()
            prs = ps.get_round_state()
            if rs.votes is None or rs.height != prs.height:
                continue
            sends = []
            prevotes = rs.votes.prevotes(prs.round_)
            if prevotes is not None:
                maj = prevotes.two_thirds_majority()
                if maj is not None:
                    sends.append((prs.round_, VOTE_TYPE_PREVOTE, maj))
            precommits = rs.votes.precommits(prs.round_)
            if precommits is not None:
                maj = precommits.two_thirds_majority()
                if maj is not None:
                    sends.append((prs.round_, VOTE_TYPE_PRECOMMIT, maj))
            if prs.proposal_pol_round >= 0:
                pol = rs.votes.prevotes(prs.proposal_pol_round)
                if pol is not None:
                    maj = pol.two_thirds_majority()
                    if maj is not None:
                        sends.append((prs.proposal_pol_round, VOTE_TYPE_PREVOTE, maj))
            for round_, type_, block_id in sends:
                # maj23 claims ride the STATE channel, where receive()
                # handles them (reference reactor.go:662 sends these on
                # StateChannel too)
                peer.try_send(
                    STATE_CHANNEL,
                    _enc(msgs.VoteSetMaj23Message(prs.height, round_, type_, block_id)),
                )
