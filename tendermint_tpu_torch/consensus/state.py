"""ConsensusState: the Tendermint BFT state machine
(reference: consensus/state.go — SURVEY.md §3.2 is the call-stack map).

One receive routine serializes ALL inputs — peer messages, our own
messages, timeouts, the mempool's txs-available signal — into a total
order, writes each to the WAL before acting, and drives the step cycle
NewHeight → NewRound → Propose → Prevote(+Wait) → Precommit(+Wait) →
Commit (consensus/state.go:604-659). That single-owner discipline is what
makes WAL replay deterministic.

Device integration: gossiped vote signatures ride the VoteBatcher
(consensus/vote_batcher.py — the receive routine drains each queued run
into ONE `verifier.verify_batch_async` gateway call per (height, round,
type) group, per-lane verdicts popped by each add_vote; singletons take
the CPU latency path) and block validation's VerifyCommit rides
`verifier.commit_batch_verifier()` (wide batch → B1 on the card), both from
ops.gateway; an aggregate LastCommit verifies on the dsm kernel.
Accept/reject semantics are identical to the reference's sequential
loops.

Pipelined execution (docs/execution-pipeline.md): with
``config.pipeline_apply`` (default on), finalize_commit stages the
height: stage 1 — validate, save the block, write the WAL ``#ENDHEIGHT``
marker — stays synchronous on this routine; stage 2 — ``sm.apply_block``
+ app Commit + snapshot hook + event flush — runs on a single ordered
executor thread (consensus/pipeline.py) while this routine advances to
H+1 over a PROVISIONAL next state (the no-valset-diff transform of
``set_block_and_validators``; its ``app_hash`` is still H−1's, which is
exactly what header H claims). The first H+1 step that actually needs
the applied state — entering propose, verifying a received proposal,
adding an H+1 vote — calls ``_join_apply()``, which blocks on the
deferred apply, swaps in the applied state, and (in the rare case a
valset diff landed) reconciles ``rs.validators``/``rs.votes`` before any
H+1 vote was verified (every vote path joins FIRST, so the provisional
set is never consulted for crypto). Replay and the FAIL_TEST_INDEX crash
model force the serial path — their determinism is single-thread by
construction (state/fail.py).

Test seams, as in the reference (consensus/state.go:222-226): the
decide_proposal / do_prevote / set_proposal methods are assignable, and
the ticker is injectable (MockTicker fires only NewHeight).
``propose_time_source`` (height -> time_ns) lets benches pin block
times for cross-run byte-identity.

The port's copy of the JAX package's `consensus/state.py`, with one
deliberate difference: a kernel or device failure (ops.gateway
.DeviceError, from a vote micro-batch, a commit verify, a hash or a
deferred apply) is not caught as a bad input. The receive routine's
handlers re-raise it, the routine stops, and the error is logged once and
kept in ``device_error``; the JAX package would fall through to
singleton CPU verifies or drop the proposal as invalid. The consensus
reactor hands it one met on a peer's receive thread
(``stop_on_device_error``), and so does the post-apply hook (the snapshot
producer's chunk digests), where the JAX package logs every error and
carries on. Input errors from peers, and any other error of the hook,
keep the JAX handling.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass

from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus import pipeline as cpipeline
from tendermint_tpu_torch.consensus import trace as ctrace
from tendermint_tpu_torch.consensus import vote_batcher as cvb
from tendermint_tpu_torch.consensus.height_vote_set import HeightVoteSet
from tendermint_tpu_torch.consensus.round_state import RoundState, RoundStep
from tendermint_tpu_torch.consensus.ticker import TickerI, TimeoutInfo, TimeoutTicker
from tendermint_tpu_torch.consensus.wal import WAL, WALMessage
from tendermint_tpu_torch.libs.events import EventCache, EventSwitch
from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.ops import gateway
from tendermint_tpu_torch.state import execution as sm
from tendermint_tpu_torch.state.fail import fail_point
from tendermint_tpu_torch.types import (
    VOTE_TYPE_PRECOMMIT,
    VOTE_TYPE_PREVOTE,
    Block,
    BlockID,
    ConflictingVotesError,
    Heartbeat,
    Proposal,
    Vote,
    VoteError,
    VoteSet,
)
from tendermint_tpu_torch.types import events as tev
from tendermint_tpu_torch.types.agg_commit import (
    AggregateCommit,
    AggregateLastCommit,
    commit_is_aggregate,
)
from tendermint_tpu_torch.types.block import empty_commit
from tendermint_tpu_torch.types.validator_set import CommitError
from tendermint_tpu_torch.types.vote import UnexpectedStepError


@dataclass
class MsgInfo:
    msg: object
    peer_id: str = ""  # "" = internal (our own proposal/parts/votes)


class ConsensusState(BaseService):
    def __init__(
        self,
        config,
        state,
        proxy_app_conn,
        block_store,
        mempool,
        verifier: gateway.Verifier | None = None,
    ):
        super().__init__("ConsensusState")
        self.config = config
        self.proxy_app_conn = proxy_app_conn
        self.block_store = block_store
        self.mempool = mempool
        self.verifier = verifier or gateway.default_verifier()
        self.part_hasher = gateway.default_hasher()

        self.priv_validator = None
        self.rs = RoundState()
        self.state = None  # sm.State, set by update_to_state

        self.peer_msg_queue: queue.Queue = queue.Queue(maxsize=1000)
        self._peer_msg_drops = 0
        self._peer_msg_drop_logged = 0.0
        self._peer_drop_mtx = threading.Lock()
        self.internal_msg_queue: queue.Queue = queue.Queue(maxsize=1000)
        self.timeout_ticker: TickerI = TimeoutTicker()
        # combined input queue preserving the reference's select semantics
        self._inputs: queue.Queue = queue.Queue()

        self.wal: WAL | None = None
        self.replay_mode = False
        # post-apply hook: called synchronously after a block
        # applies, between Commit and the next height — the statesync
        # snapshot producer's interval point (node/node.py wires it)
        self.post_apply_hook = None
        self.done_height = threading.Event()  # pulses on each commit (tests)
        self.n_steps = 0
        # liveness observability: wall seconds per committed
        # height, last and max — the direct gauge for "a consensus round
        # stalled past its budget" (e.g. behind a sick device plane, the
        # exact regression the chaos soak guards), exported by the
        # metrics RPC as consensus_height_seconds_{last,max}
        self._height_started = time.monotonic()
        self.height_seconds_last = 0.0
        self.height_seconds_max = 0.0
        # per-height trace spans: the liveness gauges say a
        # height was slow, the recorder says WHERE the time went —
        # step-partitioned wall clock + device-vs-CPU attribution,
        # served by the consensus_trace RPC (consensus/trace.py)
        self.trace = ctrace.TraceRecorder(
            device_probe=self._trace_device_probe
        )
        # observability plane (node/node.py wires both; None in
        # bare harnesses — every site guards):
        # - txtrace: sampled per-tx lifecycle spans (libs/txtrace.py)
        # - flightrec: the black-box event ring (node/flightrec.py)
        self.txtrace = None
        self.flightrec = None
        # the kernel or device failure that stopped the receive routine
        # (ops.gateway.DeviceError), None while it runs: a broken device
        # never turns into singleton CPU verifies or a proposal dropped
        # as invalid
        self.device_error: BaseException | None = None
        # votes begin_add screened as already-seen — the 2NxN gossip
        # redundancy number the queued dedup PR needs a before for
        # (per-peer attribution rides p2p_peer_vote_duplicates_total)
        self.vote_duplicates = 0
        # gossiped votes genuinely ADDED: the denominator of
        # the duplicate-vote ratio duplicates/accepted that the
        # committee benches read off scrapes — own re-delivered votes stay uncounted like
        # the duplicate side
        self.vote_accepted = 0
        # when each gossiped vote was ACCEPTED, by coordinates (round
        # 20): the reactor's lazy-relay screen holds re-pushes of a
        # just-received vote for one gossip tick so the origin's own
        # fan-out + the recipients' HasVote announcements win the race
        # (reactor._relay_ready). Own votes are never stamped — they
        # relay immediately.
        self.vote_recv_mono: dict[tuple, float] = {}
        # aggregate commit-proof plane (docs/upgrade.md):
        # catchup under the aggregate format ships whole commits, and a
        # lagging node finalizes from the proof instead of a VoteSet —
        # counted so an upgrade flip's catchup traffic is scrape-visible
        self.agg_commit_proofs = 0    # verified proofs accepted
        self.agg_commit_rejects = 0   # stale/forged/sub-quorum refused
        self.agg_commits_proposed = 0  # proposals built with an aggregate

        # pipelined execution plane: stage-2 (apply) rides an
        # ordered executor; the consensus thread holds at most ONE
        # pending apply (for rs.height - 1) and joins it at the first
        # H+1 step needing the applied state
        self.pipeline_apply = bool(getattr(config, "pipeline_apply", True))
        self._apply_executor: cpipeline.ApplyExecutor | None = None
        self._pending_apply: cpipeline.DeferredApply | None = None
        self._state_provisional = False  # self.state awaits the join
        self._apply_poisoned: BaseException | None = None
        self.pipeline_applies = 0      # heights committed via stage 2
        self.pipeline_serial_commits = 0
        self.pipeline_valset_reconciles = 0
        self.pipeline_join_wait_last = 0.0
        self.pipeline_overlap_last = 0.0
        # test/bench seam: height -> block time_ns for deterministic
        # cross-run block bytes (None = wall clock, the default)
        self.propose_time_source = None

        # big-committee vote plane (docs/committee.md): the
        # receive routine drains each run of gossiped votes into
        # per-(height, round, type) micro-batches — ONE gateway call per
        # group — and every add_vote pops its per-lane verdict.
        # vote_batching=False (bench A/B seam) restores the true
        # one-signature-at-a-time path; replay never batches (the WAL
        # feeds messages outside the receive routine's drain).
        self.vote_batching = True
        self.vote_batcher = cvb.VoteBatcher(lambda: self.verifier)

        # duplicate-vote evidence (beyond reference: state.go:1438-1447
        # punts with a TODO; we record validated pairs — types/evidence)
        from tendermint_tpu_torch.types.evidence import EvidencePool

        self.evidence_pool = EvidencePool()

        self.evsw: EventSwitch | None = None

        # test seams (consensus/state.go:222-226)
        self.decide_proposal = self.default_decide_proposal
        self.do_prevote = self.default_do_prevote
        self.set_proposal = self.default_set_proposal

        self._thread: threading.Thread | None = None
        self._forwarders: list[threading.Thread] = []
        self._stopping = threading.Event()

        self.update_to_state(state)
        self.reconstruct_last_commit(state)

    # -- wiring ------------------------------------------------------------

    def set_event_switch(self, evsw: EventSwitch) -> None:
        self.evsw = evsw

    def set_priv_validator(self, pv) -> None:
        self.priv_validator = pv

    def set_timeout_ticker(self, ticker: TickerI) -> None:
        self.timeout_ticker = ticker

    def get_round_state(self) -> RoundState:
        return self.rs  # single-writer; readers treat as snapshot

    def height_age_s(self) -> float:
        """Seconds since the current height opened — the liveness signal
        the health plane (node/health.py) gates on: a stalled chain is a
        growing age, a healthy one resets every commit."""
        return time.monotonic() - self._height_started

    def pipeline_poisoned(self) -> bool:
        """True once a deferred apply failed — the node is wedged at the
        join and the health plane must report FAILING."""
        return self._apply_poisoned is not None

    def _trace_device_probe(self) -> dict:
        """Gateway counter snapshot for per-height device attribution
        (consensus/trace.py): how many verify sigs / hash leaves this
        height ran on-device vs on the CPU fallback, and the breaker
        state bracketing it. breaker_state -1 = no breaker (not the devd
        route)."""
        v = self.verifier.stats()
        h = self.part_hasher.stats()
        return {
            "verify_tpu_sigs": v.get("tpu_sigs", 0),
            "verify_cpu_sigs": v.get("cpu_sigs", 0),
            "hash_tpu_leaves": h.get("tpu_leaves", 0),
            "hash_cpu_leaves": h.get("cpu_leaves", 0),
            "breaker_opens": v.get("breaker_opens",
                                   h.get("breaker_opens", 0)),
            "breaker_state": v.get("breaker_state",
                                   h.get("breaker_state", -1)),
        }

    def is_proposer(self) -> bool:
        proposer = self.rs.validators.get_proposer()
        return (
            self.priv_validator is not None
            and proposer is not None
            and proposer.address == self.priv_validator.get_address()
        )

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        if self.wal is None and not self.replay_mode:
            self.open_wal(self.config.wal_file())
        self.timeout_ticker.start()
        self._stopping.clear()

        # WAL catchup BEFORE accepting new inputs (consensus/state.go:337-344).
        # A replay error (e.g. fresh WAL after fast sync, with no ENDHEIGHT
        # marker for our height) is logged and consensus starts anyway
        # (consensus/state.go:340-344 does exactly this).
        if self.wal is not None and not self.replay_mode:
            from tendermint_tpu_torch.consensus.replay import catchup_replay

            try:
                catchup_replay(self, self.rs.height)
            except gateway.DeviceError as exc:
                self._note_device_error(exc)
                raise
            except Exception:
                self.logger.exception(
                    "error on catchup replay; proceeding to start anyway"
                )

        self._start_forwarders()
        self._thread = threading.Thread(
            target=self.receive_routine, args=(0,), daemon=True, name="cs.receiveRoutine"
        )
        self._thread.start()
        # height clock starts when consensus starts CONSUMING, not at
        # construction — otherwise the first height's gauge absorbs
        # fast-sync/handshake/idle time and pins height_seconds_max to a
        # number that never measured a consensus round
        self._height_started = time.monotonic()
        self.trace.begin(self.rs.height, now=self._height_started)
        self.schedule_round_0(self.rs)

    def start_routines(self, max_steps: int = 0) -> None:
        """Test entry (consensus/state.go:363-370): start ticker +
        routines without WAL replay or scheduling."""
        self.timeout_ticker.start()
        self._stopping.clear()
        self._start_forwarders()
        self._thread = threading.Thread(
            target=self.receive_routine, args=(max_steps,), daemon=True,
            name="cs.receiveRoutine",
        )
        self._thread.start()
        self._height_started = time.monotonic()  # see on_start
        self.trace.begin(self.rs.height, now=self._height_started)

    # soft cap on peer-originated messages waiting in _inputs: beyond it
    # the PEER forwarder drops instead of growing the combined queue
    # without bound (a flooding peer would otherwise OOM a live node —
    # peer_msg_queue alone can't bound anything while its forwarder
    # drains it). Internal/timeout forwarders are never capped: the
    # receive routine itself enqueues internal messages, so blocking or
    # dropping THOSE could deadlock or corrupt the state machine.
    PEER_INPUT_BACKLOG_CAP = 2000

    def _start_forwarders(self) -> None:
        """Drain the three source queues into the combined input queue."""

        def fwd(src: queue.Queue, tag: str, peer_capped: bool = False):
            while not self._stopping.is_set():
                try:
                    item = src.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is None:
                    continue
                if peer_capped and self._inputs.qsize() >= self.PEER_INPUT_BACKLOG_CAP:
                    self._note_peer_drop(item)
                    continue
                self._inputs.put((tag, item))

        for src, tag, capped in (
            (self.peer_msg_queue, "msg", True),
            (self.internal_msg_queue, "msg", False),
            (self.timeout_ticker.chan, "timeout", False),
        ):
            t = threading.Thread(target=fwd, args=(src, tag, capped), daemon=True)
            t.start()
            self._forwarders.append(t)

        if hasattr(self.mempool, "enable_txs_available") and not self.config.create_empty_blocks:
            self.mempool.enable_txs_available(lambda: self._inputs.put(("txs_available", None)))

    def on_stop(self) -> None:
        self._stopping.set()
        self.timeout_ticker.stop()
        self._inputs.put(("quit", None))
        if self._thread:
            self._thread.join(timeout=5)
        # drain the deferred apply so state/app land on a consistent
        # height for the restart handshake; a wedged app is abandoned
        # (bounded wait — shutdown never blocks on a stuck apply, the
        # executor thread is a daemon)
        pending = self._pending_apply
        if pending is not None:
            if not pending.wait(timeout=10):
                self.logger.warning(
                    "deferred apply of %d still running at stop; abandoning",
                    pending.height,
                )
            self._pending_apply = None
        if self._apply_executor is not None:
            self._apply_executor.stop(timeout=2)
            self._apply_executor = None
        if self.wal is not None:
            self.wal.stop()

    def open_wal(self, wal_file: str) -> None:
        wal = WAL(
            wal_file,
            light=self.config.wal_light,
            flush_interval_s=self.config.wal_flush_interval_s,
            sync_every_write=self.config.wal_sync_every_write,
        )
        wal.start()
        self.wal = wal

    # -- queues ------------------------------------------------------------

    def send_internal_message(self, mi: MsgInfo) -> None:
        self.internal_msg_queue.put(mi)

    # every peer-originated enqueue goes through _enqueue_peer_msg so the
    # bounded-wait invariant below cannot be bypassed by a sibling entry
    # point
    PEER_PUT_TIMEOUT = 0.5  # s

    def _enqueue_peer_msg(self, msg, peer_id: str) -> None:
        """Called (indirectly) from the peer RECV routine — must never
        wedge it. A bounded-timeout put gives a briefly-behind state
        machine time to drain (no message loss under transient pressure —
        important because gossip senders optimistically mark parts/votes
        as delivered and won't re-offer them within the round); only when
        the queue stays full past the timeout — a flooding peer or a
        stopped state machine — is the message dropped. An UNbounded put
        here wedges the recv routine, freezes the whole multiplexed
        connection, and hands any flooding peer a denial-of-service lever
        (found via the fast-sync stall flake: a stopped consensus state
        filled the queue, the blocked put froze the peer, and both sides
        eventually dropped 'stream closed'). Drops are counted and logged
        at most once per 5s so the flood can't also spam the log."""
        try:
            self.peer_msg_queue.put(MsgInfo(msg, peer_id), timeout=self.PEER_PUT_TIMEOUT)
            return
        except queue.Full:
            self._note_peer_drop(MsgInfo(msg, peer_id))

    def _note_peer_drop(self, mi) -> None:
        """Count + rate-limited-log a dropped peer message (locked: drop
        sites run on concurrent peer recv/forwarder threads, and an
        unsynchronized read-modify-write would undercount exactly during
        the floods the counter exists to observe)."""
        with self._peer_drop_mtx:
            self._peer_msg_drops += 1
            drops = self._peer_msg_drops
            now = time.monotonic()
            if now - self._peer_msg_drop_logged <= 5.0:
                return
            self._peer_msg_drop_logged = now
        self.logger.warning(
            "peer message backlog full; dropped %d total (latest: %s from %.8s)",
            drops, type(mi.msg).__name__, mi.peer_id,
        )

    def add_peer_message(self, msg, peer_id: str) -> None:
        self._enqueue_peer_msg(msg, peer_id)

    @property
    def peer_msg_drops(self) -> int:
        """Messages dropped by the ingress backpressure (/metrics)."""
        return self._peer_msg_drops

    def set_proposal_msg(self, proposal: Proposal, peer_id: str = "") -> None:
        m = msgs.ProposalMessage(proposal)
        if peer_id:
            self._enqueue_peer_msg(m, peer_id)
        else:
            self.internal_msg_queue.put(MsgInfo(m, peer_id))

    def add_vote_msg(self, vote: Vote, peer_id: str = "") -> None:
        m = msgs.VoteMessage(vote)
        if peer_id:
            self._enqueue_peer_msg(m, peer_id)
        else:
            self.internal_msg_queue.put(MsgInfo(m, peer_id))

    # -- state sync --------------------------------------------------------

    def reconstruct_last_commit(self, state) -> None:
        """Rebuild rs.last_commit from the block store's seen commit
        (consensus/state.go:407-429)."""
        if state.last_block_height == 0:
            return
        seen_commit = self.block_store.load_seen_commit(state.last_block_height)
        if seen_commit is None:
            raise RuntimeError(
                f"failed to reconstruct last commit; seen commit for height {state.last_block_height} missing"
            )
        if commit_is_aggregate(seen_commit):
            # fast-sync/statesync stored the NEXT block's aggregate
            # last_commit as the seen commit — there are no individual
            # precommits to rebuild a VoteSet from. Verify the aggregate
            # against the signing set and install it as the last-commit
            # stand-in: proposing at the next height emits it verbatim
            # (the schedule requires the aggregate form there anyway)
            try:
                seen_commit.verify(state.chain_id, state.last_validators)
            except CommitError as exc:
                raise RuntimeError(
                    f"failed to reconstruct last commit; stored aggregate "
                    f"for height {state.last_block_height} is invalid: {exc}"
                )
            self.rs.last_commit = AggregateLastCommit(
                seen_commit, state.last_validators
            )
            return
        last_precommits = VoteSet(
            state.chain_id,
            state.last_block_height,
            seen_commit.round_(),
            VOTE_TYPE_PRECOMMIT,
            state.last_validators,
        )
        # one gateway batch for the whole seen commit: each
        # add_vote's verify_one below pops its primed lane instead of
        # paying a cold-start serial verify per precommit
        items = []
        sb_cache: dict[bytes, bytes] = {}  # quorum = ONE canonical payload
        for pc in seen_commit.precommits:
            if pc is None or pc.signature is None:
                continue
            _, val = state.last_validators.get_by_index(pc.validator_index)
            if val is not None:
                sbk = pc.block_id.key()
                sb = sb_cache.get(sbk)
                if sb is None:
                    sb = sb_cache[sbk] = pc.sign_bytes(state.chain_id)
                items.append((val.pub_key.raw, sb, pc.signature.raw))
        if len(items) >= 2:
            self.verifier.prime_cache(items)
        for pc in seen_commit.precommits:
            if pc is None:
                continue
            added = last_precommits.add_vote(pc, verifier=self.verifier.vote_verifier())
            if not added:
                raise RuntimeError("failed to reconstruct last commit: vote not added")
        if not last_precommits.has_two_thirds_majority():
            raise RuntimeError("failed to reconstruct last commit: no +2/3")
        self.rs.last_commit = last_precommits

    def update_to_state(self, state) -> None:
        """Reset RoundState for the next height (consensus/state.go:432-488)."""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height != state.last_block_height:
            raise RuntimeError(
                f"update_to_state expected state height {rs.height}, got {state.last_block_height}"
            )
        if self.state is not None and self.state.last_block_height + 1 != rs.height:
            raise RuntimeError(
                f"inconsistent internal state: {self.state.last_block_height + 1} vs cs height {rs.height}"
            )
        # ignore stale states (consensus/state.go:449-455)
        if self.state is not None and state.last_block_height <= self.state.last_block_height:
            self.logger.debug("ignoring update_to_state for stale height")
            return

        validators = state.validators
        # the +2/3 precommits we just committed with become the next
        # height's last_commit (consensus/state.go:457-464); on cold start
        # (commit_round == -1) reconstruct_last_commit fills it instead
        last_precommits = None
        if rs.commit_round > -1 and rs.votes is not None:
            pc = rs.votes.precommits(rs.commit_round)
            if pc is not None and pc.has_two_thirds_majority():
                last_precommits = pc
            elif rs.commit_proof is not None:
                # finalized from an aggregate commit proof (catchup under
                # the aggregate format): the proof, already verified, IS
                # the last commit — wrapped so H+1 proposing works
                last_precommits = AggregateLastCommit(
                    rs.commit_proof, state.last_validators
                )
            else:
                raise RuntimeError("update_to_state called but last precommit round lacks +2/3")

        height = state.last_block_height + 1
        rs.height = height
        rs.round_ = 0
        rs.step = RoundStep.NEW_HEIGHT
        if rs.commit_time == 0:
            rs.start_time = time.time() + self.config.timeout_commit
        else:
            rs.start_time = rs.commit_time + self.config.timeout_commit
        rs.commit_time = 0.0
        rs.validators = validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.votes = HeightVoteSet(state.chain_id, height, validators)
        rs.commit_round = -1
        rs.commit_proof = None
        rs.last_commit = last_precommits
        rs.last_validators = state.last_validators
        self.state = state
        self.new_step()

    def new_step(self) -> None:
        rs_event = self.rs.round_state_event()
        if self.wal is not None:
            self.wal.save(WALMessage.event_round_state(rs_event))
        self.n_steps += 1
        # step transitions drive the height trace's segment clock
        # (single-writer: only this receive routine marks)
        self.trace.mark(ctrace.step_segment(self.rs.step))
        self.trace.note_round(self.rs.round_)
        fr = self.flightrec
        if fr is not None:
            # the flight ring's progress spine: a wedge reads as these
            # freezing at one height (node/flightrec.py)
            fr.record("step", height=self.rs.height, round=self.rs.round_,
                      step=int(self.rs.step))
        if self.evsw is not None:
            self.evsw.fire_event(tev.EVENT_NEW_ROUND_STEP, rs_event)

    # -- the receive routine ----------------------------------------------

    def receive_routine(self, max_steps: int) -> None:
        """consensus/state.go:609-659. max_steps=0 means run forever.

        An exception ESCAPING this routine kills the consensus thread —
        the node is dead from that instant, silently. The flight
        recorder captures the crash and dumps the ring first,
        so the post-mortem artifact exists even when nobody was
        watching; the exception still propagates (the thread must not
        limp on). A device error (ops.gateway.DeviceError) ends the
        routine: it is logged once and kept in `device_error`."""
        try:
            self._receive_routine(max_steps)
        except gateway.DeviceError as exc:
            self._note_device_error(exc)
        except BaseException as exc:
            fr = self.flightrec
            if fr is not None:
                fr.note_exception("consensus", exc)
            raise

    def stop_on_device_error(self, exc: BaseException) -> None:
        """A device error met off the receive routine (the consensus
        reactor's aggregate screen, on a peer's receive thread) stops
        consensus as one in the routine does: the first is kept and
        logged, and the routine handles no input after it."""
        if self.device_error is None:
            self._note_device_error(exc)
        self._inputs.put(("quit", None))

    def _note_device_error(self, exc: BaseException) -> None:
        """Keep, log and record the device error that stops consensus."""
        self.device_error = exc
        self.logger.error(
            "consensus stopped at height %d: device error: %s",
            self.rs.height, exc, exc_info=exc,
        )
        fr = self.flightrec
        if fr is not None:
            fr.note_exception("consensus", exc)

    def _receive_routine(self, max_steps: int) -> None:
        steps = 0
        while True:
            if max_steps > 0 and steps >= max_steps:
                self.logger.debug("receive_routine reached max_steps")
                return
            try:
                tag, item = self._inputs.get(timeout=0.5)
            except queue.Empty:
                if self._stopping.is_set():
                    return
                continue
            if tag == "quit" or self.device_error is not None:
                return
            # When a vote heads a burst, drain the already-queued run and
            # batch-verify the signatures ahead of dispatch (SURVEY §7;
            # groups per (height, round, type) through the
            # VoteBatcher): each item is then handled strictly in order —
            # WAL layout and observable accept/reject are identical to
            # one-at-a-time — but the signature work rode one batched
            # gateway call per group.
            batch = [(tag, item)]
            if max_steps == 0 and tag == "msg" and isinstance(item.msg, msgs.VoteMessage):
                while len(batch) < 512:
                    try:
                        batch.append(self._inputs.get_nowait())
                    except queue.Empty:
                        break
                try:
                    if self.vote_batching and not self.replay_mode:
                        self.vote_batcher.prepare(
                            [
                                i.msg.vote
                                for t, i in batch
                                if t == "msg" and isinstance(i.msg, msgs.VoteMessage)
                            ],
                            self.rs,
                            self.state.chain_id,
                        )
                except gateway.DeviceError:
                    raise
                except Exception:
                    # batching is purely an accelerator over adversarial
                    # input — it must never kill the receive routine; a
                    # failed device does (above)
                    self.logger.exception("vote verify-ahead failed; falling through")
            for tag, item in batch:
                if tag == "quit" or self.device_error is not None:
                    return
                steps += 1
                try:
                    if tag == "msg":
                        mi: MsgInfo = item
                        if self.wal is not None:
                            self.wal.save(WALMessage.msg_info(mi.msg, mi.peer_id))
                        self.handle_msg(mi)
                    elif tag == "timeout":
                        ti: TimeoutInfo = item
                        if self.wal is not None:
                            self.wal.save(WALMessage.timeout(ti))
                        self.handle_timeout(ti)
                    elif tag == "txs_available":
                        self.handle_txs_available(self.rs.height)
                except gateway.DeviceError:
                    raise
                except Exception:
                    self.logger.exception("error in receive routine handling %s", tag)

    def handle_msg(self, mi: MsgInfo) -> None:
        """consensus/state.go:662-698."""
        msg, peer_id = mi.msg, mi.peer_id
        if isinstance(msg, msgs.ProposalMessage):
            self.set_proposal(msg.proposal)
        elif isinstance(msg, msgs.BlockPartMessage):
            self.add_proposal_block_part(msg.height, msg.part, verify=bool(peer_id))
        elif isinstance(msg, msgs.VoteMessage):
            self.try_add_vote(msg.vote, peer_id)
        elif isinstance(msg, msgs.AggregateCommitMessage):
            self.apply_commit_proof(msg.commit, peer_id)
        else:
            self.logger.warning("unknown msg type %r", type(msg))

    def handle_timeout(self, ti: TimeoutInfo) -> None:
        """consensus/state.go:701-745."""
        rs = self.rs
        if ti.height != rs.height or ti.round_ < rs.round_ or (
            ti.round_ == rs.round_ and ti.step < rs.step
        ):
            self.logger.debug("ignoring tock because we're ahead: %s", ti)
            return
        if ti.step == RoundStep.NEW_HEIGHT:
            self.enter_new_round(ti.height, 0)
        elif ti.step == RoundStep.NEW_ROUND:
            self.enter_propose(ti.height, 0)
        elif ti.step == RoundStep.PROPOSE:
            self._fire(tev.EVENT_TIMEOUT_PROPOSE, rs.round_state_event())
            self.enter_prevote(ti.height, ti.round_)
        elif ti.step == RoundStep.PREVOTE_WAIT:
            self._fire(tev.EVENT_TIMEOUT_WAIT, rs.round_state_event())
            self.enter_precommit(ti.height, ti.round_)
        elif ti.step == RoundStep.PRECOMMIT_WAIT:
            self._fire(tev.EVENT_TIMEOUT_WAIT, rs.round_state_event())
            self.enter_new_round(ti.height, ti.round_ + 1)
        else:
            raise ValueError(f"invalid timeout step {ti.step}")

    def handle_txs_available(self, height: int) -> None:
        """consensus/state.go:747-750."""
        self.enter_propose(height, 0)

    def _fire(self, event: str, data) -> None:
        if self.evsw is not None:
            self.evsw.fire_event(event, data)

    def _schedule_timeout(self, duration: float, height: int, round_: int, step: int) -> None:
        self.timeout_ticker.schedule_timeout(TimeoutInfo(duration, height, round_, step))

    def schedule_round_0(self, rs: RoundState) -> None:
        sleep = max(0.0, rs.start_time - time.time())
        self._schedule_timeout(sleep, rs.height, 0, RoundStep.NEW_HEIGHT)

    # -- step: new round ---------------------------------------------------

    def enter_new_round(self, height: int, round_: int) -> None:
        """consensus/state.go:753-804."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step != RoundStep.NEW_HEIGHT
        ):
            self.logger.debug(
                "enter_new_round(%d/%d): invalid args, currently %d/%d/%d",
                height, round_, rs.height, rs.round_, rs.step,
            )
            return
        self.logger.info("enter_new_round(%d/%d)", height, round_)

        if round_ != 0:
            # later rounds copy + re-accum the validator set: that must
            # be the APPLIED set, not the provisional one
            self._join_apply("new_round")

        validators = rs.validators
        if rs.round_ < round_:
            validators = validators.copy()
            validators.increment_accum(round_ - rs.round_)

        rs.round_ = round_
        rs.step = RoundStep.NEW_ROUND
        rs.validators = validators
        if round_ != 0:
            # keeps proposal from NewHeight setup; later rounds reset
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)  # track next-round votes too

        self._fire(tev.EVENT_NEW_ROUND, rs.round_state_event())

        # no-empty-blocks: wait for txs before proposing (state.go:786-803)
        wait_for_txs = (
            not self.config.create_empty_blocks and round_ == 0 and not self.need_proof_block(height)
        )
        if wait_for_txs:
            if self.config.create_empty_blocks_interval > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval, height, round_, RoundStep.NEW_ROUND
                )
            if self.mempool.size() > 0:
                # txs already waiting — the one-shot signal may have fired
                # before we subscribed at this height
                self.enter_propose(height, round_)
            elif not self.replay_mode:
                self._maybe_start_heartbeat(height, round_)
        else:
            self.enter_propose(height, round_)

    def need_proof_block(self, height: int) -> bool:
        """Propose an empty block anyway if the app hash changed — it
        "proves" the app results (consensus/state.go:806-816)."""
        if height == 1:
            return True
        self._join_apply("need_proof_block")  # reads the applied app_hash
        last_block_meta = self.block_store.load_block_meta(height - 1)
        if last_block_meta is None:
            return False
        return self.state.app_hash != last_block_meta.header.app_hash

    def _maybe_start_heartbeat(self, height: int, round_: int) -> None:
        """Proposer liveness beacon while waiting for txs
        (consensus/state.go:818-848)."""
        if self.priv_validator is None or not self.is_proposer():
            return

        def beat():
            counter = 0
            addr = self.priv_validator.get_address()
            while self.is_running():
                rs = self.rs
                if rs.height != height or rs.round_ != round_ or rs.step != RoundStep.NEW_ROUND:
                    return
                val_index, _ = rs.validators.get_by_address(addr)
                hb = Heartbeat(
                    validator_address=addr,
                    validator_index=val_index,
                    height=height,
                    round_=round_,
                    sequence=counter,
                )
                hb = self.priv_validator.sign_heartbeat(self.state.chain_id, hb)
                self._fire(tev.EVENT_PROPOSAL_HEARTBEAT, tev.EventDataProposalHeartbeat(hb))
                counter += 1
                time.sleep(self.config.peer_gossip_sleep_duration * 2)

        threading.Thread(target=beat, daemon=True, name="cs.heartbeat").start()

    # -- step: propose -----------------------------------------------------

    def enter_propose(self, height: int, round_: int) -> None:
        """consensus/state.go:850-895."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= RoundStep.PROPOSE
        ):
            return
        self.logger.info("enter_propose(%d/%d)", height, round_)
        # propose is THE join point of the deferred-app-hash contract:
        # everything from here on (our proposal's header, proposer
        # selection, proposal/vote verification) reads the applied state
        self._join_apply("propose")

        def defer_():
            rs.round_ = round_
            rs.step = RoundStep.PROPOSE
            self.new_step()
            if self.is_proposal_complete():
                self.enter_prevote(height, rs.round_)

        self._schedule_timeout(self.config.propose(round_), height, round_, RoundStep.PROPOSE)

        if self.priv_validator is not None and self.is_proposer():
            self.decide_proposal(height, round_)
        defer_()

    def default_decide_proposal(self, height: int, round_: int) -> None:
        """consensus/state.go:897-944."""
        rs = self.rs
        if rs.locked_block is not None:
            block, block_parts = rs.locked_block, rs.locked_block_parts
        else:
            block, block_parts = self.create_proposal_block()
            if block is None:
                return  # nothing to propose (no txs and no commit yet)

        pol_round, pol_block_id = rs.votes.pol_info()
        proposal = Proposal(
            height=height,
            round_=round_,
            block_parts_header=block_parts.header(),
            pol_round=pol_round,
            pol_block_id=pol_block_id or BlockID(),
        )
        try:
            proposal = self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except Exception:
            if not self.replay_mode:
                self.logger.exception("enter_propose: error signing proposal")
            return

        self.send_internal_message(MsgInfo(msgs.ProposalMessage(proposal)))
        for i in range(block_parts.total):
            part = block_parts.get_part(i)
            self.send_internal_message(MsgInfo(msgs.BlockPartMessage(rs.height, rs.round_, part)))
        self.logger.info("signed proposal %d/%d", height, round_)

    def is_proposal_complete(self) -> bool:
        """consensus/state.go:946-957."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    def create_proposal_block(self):
        """consensus/state.go:959-985: reap mempool, build block+parts.
        PartSet leaf hashing routes through the card's hasher."""
        rs = self.rs
        # the header needs the applied app_hash, and the reap must run
        # AFTER the deferred apply's mempool.update(H) — joining first
        # covers both (the mempool-lock-scope invariant,
        # docs/execution-pipeline.md)
        self._join_apply("create_proposal")
        if rs.height == 1:
            commit = empty_commit()
        elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
            commit = self._commit_for_proposal(rs.last_commit.make_commit())
        else:
            self.logger.error("propose without last commit (+2/3 missing)")
            return None, None
        txs = self.mempool.reap(self.config.max_block_size_txs)
        if self.txtrace is not None:
            # lifecycle mark: reaped into OUR proposal (a non-proposer
            # stamps the same stage when the gossiped proposal block
            # completes — add_proposal_block_part)
            self.txtrace.stamp_present(txs, "proposal")
        t0 = time.perf_counter()
        # submitted-early future: the tx root starts hashing on the hash
        # plane NOW, overlapping commit/evidence/header assembly below;
        # Data.hash() joins it inside make_block (gateway in-flight table)
        submit_tx_root = getattr(self.part_hasher, "submit_tx_root", None)
        if submit_tx_root is not None and len(txs) >= 2:
            submit_tx_root([bytes(t) for t in txs])
        time_ns = None
        if self.propose_time_source is not None:
            time_ns = self.propose_time_source(rs.height)
        try:
            return Block.make_block(
                height=rs.height,
                chain_id=self.state.chain_id,
                txs=txs,
                commit=commit,
                prev_block_id=self.state.last_block_id,
                val_hash=self.state.validators.hash(),
                app_hash=self.state.app_hash,
                part_size=self.state.params().block_gossip.block_part_size_bytes,
                time_ns=time_ns,
                part_hasher=self.part_hasher.part_leaf_hashes,
                # proposal part sets: leaf digests + the whole proof tree in
                # one offload pass when the hash plane serves (devd
                # hash_stream tree frame); None -> the flat host builder.
                # submitted as a future so the device round trip
                # overlaps Part construction (types/part_set.py)
                part_tree_hasher=self.part_hasher.part_set_tree,
                part_tree_submitter=getattr(
                    self.part_hasher, "submit_part_set_tree", None
                ),
                # drain detected-but-uncommitted double-signs into the
                # proposal: one detecting node puts the proof ON CHAIN
                # for everyone (types/evidence.py; a block may
                # only carry evidence STRICTLY older than itself)
                evidence=self.evidence_pool.pending(before_height=rs.height),
            )
        finally:
            # overlapping attribution: block build (part hashing + tx
            # root) happens INSIDE the propose segment, so it rides the
            # trace's aux table, never the segment sum
            self.trace.note("part_hash_s", time.perf_counter() - t0)

    def _commit_for_proposal(self, commit):
        """The last_commit section in the format the chain's schedule
        requires at rs.height (genesis commit_format_at, docs/upgrade.md):
        the quorum half-aggregates into an AggregateCommit when the
        aggregate format is active, and passes through untouched below
        the upgrade height — the proposer is where the cutover actually
        happens on a live net."""
        gd = getattr(self.state, "genesis_doc", None)
        if gd is None or not gd.aggregate_commits_at(self.rs.height):
            return commit
        if commit_is_aggregate(commit):
            return commit  # AggregateLastCommit.make_commit() already is
        if not commit.is_commit():
            return commit  # empty (height 1); schedule never aggregates it
        agg = AggregateCommit.from_commit(
            commit, self.state.chain_id, self.rs.last_validators
        )
        self.agg_commits_proposed += 1
        if self.agg_commits_proposed == 1 and self.flightrec is not None:
            # the flip itself, in the black box: this proposer just built
            # its first aggregate last-commit (height == upgrade_height on
            # a clean flip)
            self.flightrec.record(
                "upgrade_flip", height=self.rs.height,
                signers=agg.num_signers(), of=agg.size(),
            )
        return agg

    # -- step: prevote -----------------------------------------------------

    def enter_prevote(self, height: int, round_: int) -> None:
        """consensus/state.go:987-1017."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= RoundStep.PREVOTE
        ):
            return
        self.logger.info("enter_prevote(%d/%d)", height, round_)

        # fire Polka event if we have one from a previous condition check
        self.do_prevote(height, round_)

        rs.round_ = round_
        rs.step = RoundStep.PREVOTE
        self.new_step()
        # wait for more prevotes; the 2/3-any case schedules prevote_wait

    def default_do_prevote(self, height: int, round_: int) -> None:
        """consensus/state.go:1019-1057."""
        rs = self.rs
        self._join_apply("prevote")  # validate_block reads self.state
        if rs.locked_block is not None:
            self.logger.info("prevote: locked block")
            self.sign_add_vote(VOTE_TYPE_PREVOTE, rs.locked_block.hash(), rs.locked_block_parts.header())
            return
        if rs.proposal_block is None:
            self.logger.info("prevote: proposal block is nil")
            self.sign_add_vote(VOTE_TYPE_PREVOTE, b"", None)
            return
        try:
            sm.validate_block(
                self.state, rs.proposal_block,
                batch_verifier=self.verifier.commit_batch_verifier(),
            )
        except sm.InvalidBlockError as e:
            self.logger.error("prevote: proposal block invalid: %s", e)
            self.sign_add_vote(VOTE_TYPE_PREVOTE, b"", None)
            return
        self.sign_add_vote(
            VOTE_TYPE_PREVOTE, rs.proposal_block.hash(), rs.proposal_block_parts.header()
        )

    def enter_prevote_wait(self, height: int, round_: int) -> None:
        """consensus/state.go:1059-1073."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= RoundStep.PREVOTE_WAIT
        ):
            return
        prevotes = rs.votes.prevotes(round_)
        if prevotes is None or not prevotes.has_two_thirds_any():
            raise RuntimeError(f"enter_prevote_wait({height}/{round_}) without +2/3 prevotes")
        self.logger.info("enter_prevote_wait(%d/%d)", height, round_)
        rs.round_ = round_
        rs.step = RoundStep.PREVOTE_WAIT
        self.new_step()
        self._schedule_timeout(self.config.prevote(round_), height, round_, RoundStep.PREVOTE_WAIT)

    # -- step: precommit ---------------------------------------------------

    def enter_precommit(self, height: int, round_: int) -> None:
        """The locking logic (consensus/state.go:1075-1188)."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= RoundStep.PRECOMMIT
        ):
            return
        self.logger.info("enter_precommit(%d/%d)", height, round_)

        def defer_():
            rs.round_ = round_
            rs.step = RoundStep.PRECOMMIT
            self.new_step()

        prevotes = rs.votes.prevotes(round_)
        block_id = prevotes.two_thirds_majority() if prevotes else None

        # no +2/3 for anything: precommit nil
        if block_id is None:
            self.logger.info("precommit: no +2/3 prevotes; precommitting nil")
            self.sign_add_vote(VOTE_TYPE_PRECOMMIT, b"", None)
            defer_()
            return

        self._fire(tev.EVENT_POLKA, rs.round_state_event())

        pol_round, _ = rs.votes.pol_info()
        if pol_round < round_:
            raise RuntimeError(f"POLRound {pol_round} < round {round_}")

        # +2/3 for nil: unlock if locked, precommit nil (state.go:1112-1126)
        if not block_id.hash:
            if rs.locked_block is None:
                self.logger.info("precommit: +2/3 prevoted nil")
            else:
                self.logger.info("precommit: +2/3 prevoted nil; unlocking")
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
                self._fire(tev.EVENT_UNLOCK, rs.round_state_event())
            self.sign_add_vote(VOTE_TYPE_PRECOMMIT, b"", None)
            defer_()
            return

        # +2/3 for the block we're locked on: relock (state.go:1130-1138)
        if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
            self.logger.info("precommit: relocking")
            rs.locked_round = round_
            self._fire(tev.EVENT_RELOCK, rs.round_state_event())
            self.sign_add_vote(VOTE_TYPE_PRECOMMIT, block_id.hash, block_id.parts_header)
            defer_()
            return

        # +2/3 for the proposal block: lock it (state.go:1142-1157)
        if rs.proposal_block is not None and rs.proposal_block.hashes_to(block_id.hash):
            try:
                sm.validate_block(
                    self.state, rs.proposal_block,
                    batch_verifier=self.verifier.commit_batch_verifier(),
                )
            except sm.InvalidBlockError as e:
                raise RuntimeError(f"enter_precommit: +2/3 prevoted an invalid block: {e}")
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            self._fire(tev.EVENT_LOCK, rs.round_state_event())
            self.sign_add_vote(VOTE_TYPE_PRECOMMIT, block_id.hash, block_id.parts_header)
            defer_()
            return

        # +2/3 for a block we don't have: unlock, fetch it (state.go:1160-1177)
        self.logger.info("precommit: +2/3 for unknown block; unlocking and precommitting nil")
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
            block_id.parts_header
        ):
            rs.proposal_block = None
            from tendermint_tpu_torch.types import PartSet

            rs.proposal_block_parts = PartSet.from_header(block_id.parts_header)
        self._fire(tev.EVENT_UNLOCK, rs.round_state_event())
        self.sign_add_vote(VOTE_TYPE_PRECOMMIT, b"", None)
        defer_()

    def enter_precommit_wait(self, height: int, round_: int) -> None:
        """consensus/state.go:1190-1204."""
        rs = self.rs
        if rs.height != height or round_ < rs.round_ or (
            rs.round_ == round_ and rs.step >= RoundStep.PRECOMMIT_WAIT
        ):
            return
        precommits = rs.votes.precommits(round_)
        if precommits is None or not precommits.has_two_thirds_any():
            raise RuntimeError(f"enter_precommit_wait({height}/{round_}) without +2/3 precommits")
        self.logger.info("enter_precommit_wait(%d/%d)", height, round_)
        rs.round_ = round_
        rs.step = RoundStep.PRECOMMIT_WAIT
        self.new_step()
        self._schedule_timeout(self.config.precommit(round_), height, round_, RoundStep.PRECOMMIT_WAIT)

    # -- step: commit ------------------------------------------------------

    def enter_commit(self, height: int, commit_round: int) -> None:
        """consensus/state.go:1206-1258."""
        rs = self.rs
        if rs.height != height or rs.step >= RoundStep.COMMIT:
            return
        self.logger.info("enter_commit(%d/%d)", height, commit_round)

        def defer_():
            rs.step = RoundStep.COMMIT
            rs.commit_round = commit_round
            rs.commit_time = time.time()
            self.new_step()
            self.try_finalize_commit(height)

        block_id = rs.votes.precommits(commit_round).two_thirds_majority()
        if block_id is None:
            raise RuntimeError("enter_commit expects +2/3 precommits")

        # locked block takes priority if it IS the committed block
        if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
            if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                block_id.parts_header
            ):
                self.logger.info("commit is for a block we don't know about; fetching")
                rs.proposal_block = None
                from tendermint_tpu_torch.types import PartSet

                rs.proposal_block_parts = PartSet.from_header(block_id.parts_header)
        defer_()

    def apply_commit_proof(self, agg, peer_id: str = "") -> bool:
        """Adopt a received AggregateCommit as this height's commit
        proof (the aggregate-format catchup path, docs/upgrade.md): the
        reactor already crypto-verified it against rs.validators before
        enqueueing, but the consensus thread re-verifies here — the WAL
        replays this message, and replay must re-derive every verdict
        rather than trust the recorded one. On success the height
        finalizes exactly like enter_commit, with the proof standing in
        for the +2/3 VoteSet."""
        rs = self.rs
        if agg.height() != rs.height or rs.step >= RoundStep.COMMIT:
            return False  # stale or already committing — not an error
        err = agg.validate_basic()
        if err is None:
            self._join_apply("commit_proof")
            try:
                agg.verify(self.state.chain_id, rs.validators)
            except CommitError as exc:
                err = str(exc)
        if err is not None:
            self.agg_commit_rejects += 1
            if self.flightrec is not None:
                self.flightrec.record(
                    "agg_commit_reject", height=agg.height(),
                    err=err, peer=peer_id or "self",
                )
            self.logger.warning(
                "rejected aggregate commit proof from %s: %s",
                peer_id or "self", err,
            )
            return False
        self.agg_commit_proofs += 1
        rs.commit_proof = agg
        if self.flightrec is not None:
            self.flightrec.record(
                "agg_commit_proof", height=agg.height(),
                signers=agg.num_signers(), peer=peer_id or "self",
            )
        self.logger.info(
            "commit proof at height %d: aggregate of %d/%d signers",
            rs.height, agg.num_signers(), agg.size(),
        )
        # adopt the committed block id (enter_commit's fetch logic)
        if rs.locked_block is not None and rs.locked_block.hashes_to(agg.block_id.hash):
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is None or not rs.proposal_block.hashes_to(agg.block_id.hash):
            if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                agg.block_id.parts_header
            ):
                rs.proposal_block = None
                from tendermint_tpu_torch.types import PartSet

                rs.proposal_block_parts = PartSet.from_header(agg.block_id.parts_header)
        rs.step = RoundStep.COMMIT
        rs.commit_round = agg.round_()
        rs.commit_time = time.time()
        self.new_step()
        self.try_finalize_commit(rs.height)
        return True

    def _committed_block_id(self):
        """The BlockID this height commits to: the commit proof's when
        one was adopted (aggregate catchup), else the +2/3 precommit
        majority of the commit round."""
        rs = self.rs
        if rs.commit_proof is not None:
            return rs.commit_proof.block_id
        pc = rs.votes.precommits(rs.commit_round) if rs.votes is not None else None
        return pc.two_thirds_majority() if pc is not None else None

    def try_finalize_commit(self, height: int) -> None:
        """consensus/state.go:1236-1256."""
        rs = self.rs
        if rs.height != height:
            raise RuntimeError("try_finalize_commit: height mismatch")
        block_id = self._committed_block_id()
        if block_id is None or not block_id.hash:
            return
        if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
            return  # haven't received the full block yet
        self.finalize_commit(height)

    def finalize_commit(self, height: int) -> None:
        """Save the block, write the WAL marker, apply via the execution
        pipeline, move to the next height (consensus/state.go:1258-1355).

        Stage 1 (validate + block save + #ENDHEIGHT) is always
        synchronous here; stage 2 (apply + snapshot hook + events) is
        deferred to the apply executor when the pipeline is enabled, and
        joined by the first H+1 step that needs the applied state."""
        rs = self.rs
        if rs.height != height or rs.step != RoundStep.COMMIT:
            return
        # a pending apply here means H-1's stage 2 is still in flight
        # while H fully committed — impossible via the vote path (every
        # H-vote joins first), but replay/test seams can call directly
        self._join_apply("finalize")
        block_id = self._committed_block_id()
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        if block_id is None or not block.hashes_to(block_id.hash):
            raise RuntimeError("cannot finalize: proposal block does not hash to commit hash")
        sm.validate_block(
            self.state, block, batch_verifier=self.verifier.commit_batch_verifier()
        )
        self.logger.info(
            "finalizing commit of block %d: hash=%s txs=%d",
            height, block.hash().hex()[:12], block.header.num_txs,
        )
        # gossip arrival mark: commit receipt — quorum AND the
        # full block are in hand; the fleet aggregator reads commit skew
        # off this instant across nodes
        self.trace.mark_arrival("commit")
        # trace: the commit-wait segment ends here; the finalize
        # sub-phases (save -> apply -> snapshot hook -> events, or
        # save -> submit when pipelined) partition the rest of the
        # height's wall time
        self.trace.mark("block_save")

        fail_point()

        if self.block_store.height() < block.header.height:
            if rs.commit_proof is not None:
                # catchup finalize: the verified aggregate IS the seen
                # commit (SC:h stores whatever quorum form was observed)
                seen_commit = rs.commit_proof
            else:
                seen_commit = rs.votes.precommits(rs.commit_round).make_commit()
            self.block_store.save_block(block, block_parts, seen_commit)
        # else: already saved (e.g. during replay); proceed to apply

        fail_point()

        if self.wal is not None:
            self.wal.write_end_height(height)
            if self.flightrec is not None:
                # the durability mark: everything before this instant
                # survives a power failure (docs/crash-recovery.md)
                self.flightrec.record("wal_endheight", height=height)

        fail_point()

        if self.txtrace is not None:
            # lifecycle mark: the block carrying a traced tx is now
            # chain history (stage 1 done — marker on disk); also
            # resets the first-K-per-height sampling window
            self.txtrace.commit(block.data.txs, height)

        state_copy = self.state.copy()
        event_cache = EventCache(self.evsw) if self.evsw is not None else _NullCache()

        if self._pipeline_enabled():
            # the committed block's evidence section is chain history the
            # moment the marker lands: never re-propose it (independent
            # of the apply; validated above in validate_block)
            if block.evidence.evidence:
                self.evidence_pool.mark_committed(block.evidence.evidence)
            # provisional state FIRST: the submit hands state_copy to the
            # executor, whose apply_block mutates it — copying after the
            # submit would race set_block_and_validators (a torn copy
            # double-rotates accum: same valset hash, wrong proposer)
            next_state = self._provisional_next_state(
                state_copy, block, block_parts
            )
            self._submit_deferred_apply(
                height, state_copy, event_cache, block, block_parts
            )
        else:
            self.pipeline_serial_commits += 1
            self.trace.mark("apply")
            sm.apply_block(
                state_copy,
                event_cache,
                self.proxy_app_conn,
                block,
                block_parts.header(),
                self.mempool,
                batch_verifier=self.verifier.commit_batch_verifier(),
            )

            fail_point()

            # the committed block's evidence section is now chain history:
            # never re-propose it, and adopt pieces other nodes detected
            # (validated above in validate_block)
            if block.evidence.evidence:
                self.evidence_pool.mark_committed(block.evidence.evidence)

            self._post_apply_tail(
                state_copy, block, event_cache, height, mark_trace=True
            )

            fail_point()
            next_state = state_copy

        now = time.monotonic()
        self.height_seconds_last = now - self._height_started
        self.height_seconds_max = max(
            self.height_seconds_max, self.height_seconds_last
        )
        self._height_started = now
        cpipeline.pipeline_hists()["height"].observe(self.height_seconds_last)
        # seal this height's trace on the SAME clock reading the gauge
        # used (segments must sum to height_seconds_last), then start
        # the next height's
        self.trace.finish(height, self.height_seconds_last, now=now)
        self.trace.begin(height + 1, now=now)

        self.update_to_state(next_state)
        self._state_provisional = self._pending_apply is not None
        self.done_height.set()
        self.done_height.clear()
        self.schedule_round_0(self.rs)

    # -- the pipelined execution plane -------------------------

    def _pipeline_enabled(self) -> bool:
        """Stage-2 deferral policy. Replay is serial by contract (the WAL
        is a single-thread total order), and the legacy FAIL_TEST_INDEX
        crash model counts fail_point() hits on ONE thread — arming it
        forces the serial path so the i-th hit stays deterministic
        (state/fail.py; the pipeline's own crash boundaries are the named
        pipeline_point() tier)."""
        return (
            self.pipeline_apply
            and not self.replay_mode
            and os.environ.get("FAIL_TEST_INDEX") is None
        )

    def _submit_deferred_apply(
        self, height: int, state_copy, event_cache, block, block_parts
    ) -> None:
        """Stage 2: apply + app Commit + snapshot hook + events, on the
        ordered executor. The block save and WAL marker already landed —
        a crash before the apply completes is the store==state+1 image
        the restart handshake replays (docs/execution-pipeline.md)."""
        if self._apply_executor is None:
            self._apply_executor = cpipeline.ApplyExecutor()
        parts_header = block_parts.header()
        batch_verifier = self.verifier.commit_batch_verifier()
        pending = cpipeline.DeferredApply(height)

        def run():
            from tendermint_tpu_torch.state.fail import pipeline_point

            pipeline_point("pre_apply")
            t0 = time.monotonic()
            sm.apply_block(
                state_copy,
                event_cache,
                self.proxy_app_conn,
                block,
                parts_header,
                self.mempool,
                batch_verifier=batch_verifier,
            )
            pipeline_point("post_apply")
            apply_s = time.monotonic() - t0
            # resolve the join NOW: the consensus thread only needs the
            # applied state. The snapshot hook + event flush below run as
            # the executor's tail — off the critical path entirely (the
            # next height's apply queues behind them on this worker, so
            # the app-quiesce guarantee still holds; the snapshot hook
            # observes the app exactly at H because the next DeliverTx
            # can only come from the next queued apply)
            pending._finish(value=(state_copy, apply_s))
            # apply(H) ran under consensus of H+1: attribute it there
            self.trace.note_overlap(height + 1, "overlap_apply_s", apply_s)
            t1 = time.monotonic()
            self._post_apply_tail(
                state_copy, block, event_cache, height, mark_trace=False
            )
            self.trace.note_overlap(
                height + 1, "overlap_hook_s", time.monotonic() - t1
            )
            return state_copy, apply_s

        self._pending_apply = self._apply_executor.submit(pending, run)
        self.pipeline_applies += 1

    def _post_apply_tail(self, state_copy, block, event_cache, height: int,
                         mark_trace: bool) -> None:
        """The post-apply work both finalize modes share: snapshot hook
        (an error of the hook is logged and consensus goes on, but a
        DeviceError stops consensus) then NewBlock/NewBlockHeader + the cached tx events, post-commit.
        Serial mode runs it inline with trace segment marks; pipelined
        mode runs it as the executor's tail (EventSwitch is
        lock-protected; subscribers already handle cross-thread fires
        from the reactors)."""
        if self.txtrace is not None:
            # lifecycle mark: the block's (serial or deferred) apply
            # just completed — both modes route through this tail
            self.txtrace.stamp_present(block.data.txs, "apply")
        if mark_trace:
            self.trace.mark("snapshot_hook")
        if self.post_apply_hook is not None and not self.replay_mode:
            # snapshot production rides here: state_copy is the post-H
            # state and the app just committed H
            try:
                self.post_apply_hook(state_copy, block)
            except gateway.DeviceError as exc:
                # a failed kernel is not a failed snapshot: stop consensus
                self.stop_on_device_error(exc)
            except Exception:  # noqa: BLE001
                self.logger.exception("post-apply hook failed at %d", height)
        if mark_trace:
            self.trace.mark("events")
        if self.evsw is not None:
            self.evsw.fire_event(tev.EVENT_NEW_BLOCK, tev.EventDataNewBlock(block))
            self.evsw.fire_event(
                tev.EVENT_NEW_BLOCK_HEADER, tev.EventDataNewBlockHeader(block.header)
            )
        event_cache.flush()
        if self.txtrace is not None:
            # lifecycle terminus: the txs' DeliverTx events just flushed
            # to subscribers — seal the traces (visible latency)
            self.txtrace.delivered(block.data.txs)

    def _provisional_next_state(self, state_copy, block, block_parts):
        """The H+1 state ASSUMING no EndBlock valset diffs (the common
        case): last-block pointers advanced, accum rotated, app_hash
        still H−1's (header H's claim — the applied hash arrives at the
        join). A real diff is reconciled in _join_apply before any H+1
        vote could have been verified against the provisional set."""
        from tendermint_tpu_torch.state.state import ABCIResponses

        prov = state_copy.copy()
        prov.set_block_and_validators(
            block.header, block_parts.header(), ABCIResponses.for_block(block)
        )
        return prov

    def _join_apply(self, reason: str) -> None:
        """Block until the deferred apply of rs.height-1 lands, then swap
        the applied state in. Called (consensus thread only) by every
        H+1 step that reads app_hash/the applied valset — propose,
        proposal verify, prevote validate, H+1 vote add, finalize. The
        wait is the pipeline_join_wait_seconds histogram; apply runtime
        minus the wait is the overlap the pipeline actually hid."""
        if self._apply_poisoned is not None:
            # a deferred apply failed earlier: consensus must stay
            # wedged (the serial design's semantics — advancing on a
            # stale app hash would fork from true execution)
            raise RuntimeError(
                "consensus halted: deferred apply failed"
            ) from self._apply_poisoned
        pending = self._pending_apply
        if pending is None:
            return
        t0 = time.monotonic()
        try:
            applied, apply_s = pending.result()
        except BaseException as exc:
            # a failed apply means consensus cannot advance past H-1:
            # surface it on the receive routine exactly where the serial
            # design would have raised, and POISON every later join so
            # the receive routine's catch-and-continue can't commit on
            # the stale provisional state
            self._pending_apply = None
            self._apply_poisoned = exc
            self.logger.error(
                "deferred apply of height %d failed (join at %s)",
                pending.height, reason,
            )
            raise
        wait_s = time.monotonic() - t0
        overlap_s = max(0.0, apply_s - wait_s)
        self._pending_apply = None
        self.pipeline_join_wait_last = wait_s
        self.pipeline_overlap_last = overlap_s
        hists = cpipeline.pipeline_hists()
        hists["join_wait"].observe(wait_s)
        hists["overlap"].observe(overlap_s)
        self.trace.note("pipeline_join_wait_s", wait_s)

        prov = self.state
        self.state = applied
        self._state_provisional = False
        if applied.validators.hash() != prov.validators.hash():
            # an EndBlock diff landed: the provisional set was wrong. No
            # H+1 vote or proposal was verified against it (every such
            # path joins first), so swapping the set and the empty vote
            # book is a complete reconciliation.
            self.pipeline_valset_reconciles += 1
            rs = self.rs
            rs.validators = applied.validators
            rs.last_validators = applied.last_validators
            fresh = HeightVoteSet(applied.chain_id, rs.height, applied.validators)
            fresh.set_round(rs.round_ + 1)
            rs.votes = fresh
            self.logger.warning(
                "pipelined apply of %d changed the validator set; "
                "reconciled rs for height %d at %s",
                pending.height, rs.height, reason,
            )

    # -- proposals ---------------------------------------------------------

    def default_set_proposal(self, proposal: Proposal) -> None:
        """consensus/state.go:1359-1392."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round_ != rs.round_:
            return
        if rs.step == RoundStep.COMMIT:
            return
        if proposal.pol_round != -1 and not (0 <= proposal.pol_round < proposal.round_):
            raise ValueError("invalid proposal POL round")
        # proposer selection + signature verify need the APPLIED set
        self._join_apply("set_proposal")
        proposer = rs.validators.get_proposer()
        sign_bytes = proposal.sign_bytes(self.state.chain_id)
        if proposal.signature is None or not self.verifier.verify_one(
            proposer.pub_key.raw, sign_bytes, proposal.signature.raw
        ):
            raise ValueError("invalid proposal signature")
        rs.proposal = proposal
        from tendermint_tpu_torch.types import PartSet

        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet.from_header(proposal.block_parts_header)
        self.trace.mark_arrival("proposal")
        self.logger.info("received proposal %r", proposal)

    def add_proposal_block_part(self, height: int, part, verify: bool) -> bool:
        """consensus/state.go:1394-1457. Returns True if added."""
        rs = self.rs
        if rs.height != height:
            return False
        if rs.proposal_block_parts is None:
            return False  # no proposal yet; possible DoS — drop
        added = rs.proposal_block_parts.add_part(part)
        if added:
            # first part held for this height (build or gossip): the
            # cross-node spread of this instant IS the proposer->peer
            # propagation lag (mark_arrival keeps the first only)
            self.trace.mark_arrival("first_block_part")
            # announce the part so peers stop re-sending it —
            # the reactor broadcasts a HasBlockPart off this event (the
            # part-set analogue of the EVENT_VOTE -> HasVote broadcast)
            self._fire(
                tev.EVENT_PROPOSAL_BLOCK_PART,
                tev.EventDataBlockPart(height, rs.round_, part.index),
            )
        if added and rs.proposal_block_parts.is_complete():
            block_bytes = rs.proposal_block_parts.get_data()
            rs.proposal_block = Block.from_bytes(block_bytes)
            if self.txtrace is not None:
                # lifecycle mark: the proposal carrying a traced tx
                # arrived whole (the non-proposer half of "proposal")
                self.txtrace.stamp_present(
                    rs.proposal_block.data.txs, "proposal"
                )
            self.logger.info("received complete proposal block %s", rs.proposal_block.hash().hex()[:12])
            self._fire(tev.EVENT_COMPLETE_PROPOSAL, rs.round_state_event())
            if rs.step <= RoundStep.PROPOSE and self.is_proposal_complete():
                self.enter_prevote(height, rs.round_)
            elif rs.step == RoundStep.COMMIT:
                self.try_finalize_commit(height)
        return added

    # -- votes -------------------------------------------------------------

    def try_add_vote(self, vote: Vote, peer_id: str) -> None:
        """consensus/state.go:1430-1457: conflicting votes are evidence,
        stale/unexpected votes are ignored."""
        try:
            self.add_vote(vote, peer_id)
        except ConflictingVotesError as e:
            if (
                self.priv_validator is not None
                and vote.validator_address == self.priv_validator.get_address()
            ):
                self.logger.error(
                    "found conflicting vote from ourselves! %d/%d/%d",
                    vote.height, vote.round_, vote.type_,
                )
                return
            # Reference punts here with a TODO (state.go:1443); we
            # validate + record the pair so byzantine drills and the
            # `evidence` RPC can assert double-signing was seen.
            self.logger.warning("found conflicting vote: %r vs %r", e.vote_a, e.vote_b)
            self._record_duplicate_vote_evidence(e.vote_a, e.vote_b)
        except UnexpectedStepError:
            pass  # vote for an old height/step — harmless
        except VoteError as e:
            fr = self.flightrec
            if fr is not None:
                fr.record("vote_reject", height=vote.height,
                          round=vote.round_, type=vote.type_,
                          err=f"{type(e).__name__}: {e}",
                          peer=peer_id or "self")
            self.logger.warning("bad vote from %s: %s", peer_id or "self", e)

    def _record_duplicate_vote_evidence(self, vote_a: Vote, vote_b: Vote) -> None:
        """Validate and pool a conflicting-vote pair (never raises — the
        vote path must survive malformed evidence)."""
        try:
            from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

            # a late precommit for the previous height conflicts inside
            # rs.last_commit (add_vote's height-1 branch) — its signer
            # lives in LAST height's validator set, which may no longer
            # contain it (exit-then-double-sign); looking it up in the
            # current set would silently drop provable evidence
            vals = self.rs.validators
            if vote_a.height == self.rs.height - 1 and self.rs.last_validators:
                vals = self.rs.last_validators
            _idx, val = vals.get_by_address(vote_a.validator_address)
            if val is None:
                return
            ev = DuplicateVoteEvidence.new(val.pub_key, vote_a, vote_b)
            if self.evidence_pool.add(
                ev, self.state.chain_id,
                batch_verifier=self.verifier.commit_batch_verifier(),
            ):
                self.logger.warning(
                    "recorded duplicate-vote evidence: val %s at %d/%d/%d",
                    vote_a.validator_address.hex()[:12], vote_a.height,
                    vote_a.round_, vote_a.type_,
                )
                self._fire(tev.EVENT_EVIDENCE, ev.to_json())
        except Exception:  # noqa: BLE001
            self.logger.exception("evidence recording failed")

    def add_vote(self, vote: Vote, peer_id: str) -> bool:
        """consensus/state.go:1459-1565."""
        rs = self.rs

        # precommit for the previous height (late commit vote)
        if vote.height + 1 == rs.height:
            if not (vote.type_ == VOTE_TYPE_PRECOMMIT and rs.step == RoundStep.NEW_HEIGHT):
                return False
            if rs.last_commit is None:
                return False
            added = self._split_add(rs.last_commit, vote, peer_id=peer_id)
            if added:
                self.logger.info("added to last_commit: %r", rs.last_commit)
                self._fire(tev.EVENT_VOTE, tev.EventDataVote(vote))
                if self.config.skip_timeout_commit and rs.last_commit.has_all():
                    # all votes in — skip the commit timeout (state.go:1477-1484)
                    self.enter_new_round(rs.height, 0)
            return added

        if vote.height != rs.height:
            self.logger.debug("vote ignored: wrong height %d vs %d", vote.height, rs.height)
            return False

        # a current-height vote verifies against rs.validators: join so
        # the set (and rs.votes) is the applied one — this is what makes
        # the provisional set crypto-invisible (no H+1 vote is ever
        # checked against it)
        self._join_apply("add_vote")
        added = self._split_add(rs.votes, vote, peer_id=peer_id,
                                height_set=True)
        if not added:
            return False
        self._fire(tev.EVENT_VOTE, tev.EventDataVote(vote))

        if vote.type_ == VOTE_TYPE_PREVOTE:
            self._handle_added_prevote(vote)
        elif vote.type_ == VOTE_TYPE_PRECOMMIT:
            self._handle_added_precommit(vote)
        return added

    def _split_add(self, vote_set, vote: Vote, peer_id: str = "",
                   height_set: bool = False) -> bool:
        """The split-add flow (docs/committee.md): synchronous
        structural checks produce a pending entry, its signature verdict
        comes from the micro-batch the receive routine dispatched over
        the drained run (VoteBatcher.prepare) — a singleton CPU verify on
        any miss — and commit applies it with add_vote's exact error
        taxonomy, so one bad signature rejects only its own vote. Replay
        and vote_batching=False never see a dispatched batch, making
        every lane a deterministic singleton by construction.

        A begin_add exact-duplicate from a PEER is the 2NxN
        vote-gossip redundancy — counted process-flat
        (consensus_vote_duplicates) and per sender
        (p2p_peer_vote_duplicates_total) so the queued gossip-dedup PR
        has a before number. Unwanted-round drops (catchup budget) and
        our own re-delivered votes (empty peer_id) are NOT gossip
        redundancy and stay uncounted."""
        from tendermint_tpu_torch.consensus.height_vote_set import UNWANTED_ROUND

        if height_set:
            pending = vote_set.begin_add(vote, peer_id)  # HeightVoteSet
        else:
            pending = vote_set.begin_add(vote)  # last_commit VoteSet
        if pending is UNWANTED_ROUND:
            return False  # untracked round dropped (add_vote's False)
        if pending is None:
            if peer_id:
                self._note_vote_duplicate(peer_id)
            return False  # exact duplicate (add_vote's False)
        added = pending.commit(self.vote_batcher.verdict(pending.item()))
        if added and peer_id:
            self.vote_accepted += 1
            self._stamp_vote_recv(vote)
        return added

    def _stamp_vote_recv(self, vote: Vote) -> None:
        """Record when a gossiped vote landed (the reactor's lazy-relay
        screen reads it). Bounded: entries only matter for one gossip
        tick, so on overflow everything older than a couple seconds is
        dropped in one sweep."""
        now = time.monotonic()
        self.vote_recv_mono[
            (vote.height, vote.round_, vote.type_, vote.validator_index)
        ] = now
        if len(self.vote_recv_mono) > 4096:
            cutoff = now - 2.0
            self.vote_recv_mono = {
                k: t for k, t in self.vote_recv_mono.items() if t >= cutoff
            }

    def _note_vote_duplicate(self, peer_id: str) -> None:
        """Count one already-seen gossiped vote: the flat gauge, the
        labeled per-peer counter, and a sampled flight-recorder event.
        Metric failures must never cost the vote path."""
        self.vote_duplicates += 1
        try:
            from tendermint_tpu_torch.p2p.telemetry import peer_metrics

            fams = peer_metrics(self.trace.metrics_registry)
            fams["vote_duplicates"].labels(peer=peer_id).inc()
        except Exception:  # noqa: BLE001
            pass
        fr = self.flightrec
        if fr is not None:
            fr.note_vote_dup(peer_id)

    def _handle_added_prevote(self, vote: Vote) -> None:
        """consensus/state.go:1500-1534."""
        rs = self.rs
        prevotes = rs.votes.prevotes(vote.round_)
        self.logger.debug("added prevote %r -> %r", vote, prevotes)

        # unlock on a newer polka (state.go:1507-1521)
        block_id = prevotes.two_thirds_majority()
        if block_id is not None and block_id.hash:
            # gossip arrival mark: +2/3 prevotes for a block
            self.trace.mark_arrival("prevote_quorum")
        if (
            rs.locked_block is not None
            and rs.locked_round < vote.round_ <= rs.round_
            and block_id is not None
            and not rs.locked_block.hashes_to(block_id.hash)
        ):
            self.logger.info("unlocking because of POL at round %d", vote.round_)
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            self._fire(tev.EVENT_UNLOCK, rs.round_state_event())

        if rs.round_ <= vote.round_ and prevotes.has_two_thirds_any():
            # round skip / advance (state.go:1523-1533)
            if prevotes.has_two_thirds_majority():
                self.enter_precommit(rs.height, vote.round_)
            else:
                self.enter_new_round(rs.height, vote.round_)  # if vote.round > rs.round
                self.enter_prevote_wait(rs.height, vote.round_)
        elif rs.proposal is not None and rs.proposal.pol_round >= 0 and rs.proposal.pol_round == vote.round_:
            if self.is_proposal_complete():
                self.enter_prevote(rs.height, rs.round_)

    def _handle_added_precommit(self, vote: Vote) -> None:
        """consensus/state.go:1535-1557."""
        rs = self.rs
        precommits = rs.votes.precommits(vote.round_)
        self.logger.debug("added precommit %r -> %r", vote, precommits)
        block_id = precommits.two_thirds_majority()
        if block_id is not None and block_id.hash:
            # gossip arrival mark: the commit-able quorum —
            # after a partition heals, the first height's observation
            # carries the whole outage (the scrape-visible quorum spike)
            self.trace.mark_arrival("precommit_quorum")
        if block_id is not None:
            # executed as defers in the reference: latest first
            self.enter_new_round(rs.height, vote.round_)
            self.enter_precommit(rs.height, vote.round_)
            if block_id.hash:
                self.enter_commit(rs.height, vote.round_)
                if self.config.skip_timeout_commit and precommits.has_all():
                    self.enter_new_round(rs.height, 0)
            else:
                self.enter_precommit_wait(rs.height, vote.round_)
        elif rs.round_ <= vote.round_ and precommits.has_two_thirds_any():
            self.enter_new_round(rs.height, vote.round_)
            self.enter_precommit(rs.height, vote.round_)
            self.enter_precommit_wait(rs.height, vote.round_)

    # -- signing -----------------------------------------------------------

    def sign_vote(self, type_: int, hash_: bytes, header) -> Vote:
        """consensus/state.go:1567-1581."""
        rs = self.rs
        addr = self.priv_validator.get_address()
        val_index, _ = rs.validators.get_by_address(addr)
        from tendermint_tpu_torch.types.block_id import PartSetHeader

        vote = Vote(
            validator_address=addr,
            validator_index=val_index,
            height=rs.height,
            round_=rs.round_,
            type_=type_,
            block_id=BlockID(hash_, header or PartSetHeader()),
        )
        return self.priv_validator.sign_vote(self.state.chain_id, vote)

    def sign_add_vote(self, type_: int, hash_: bytes, header) -> Vote | None:
        """Sign and inject into our own queue (consensus/state.go:1583-1599)."""
        rs = self.rs
        if self.priv_validator is None or not rs.validators.has_address(
            self.priv_validator.get_address()
        ):
            return None
        try:
            vote = self.sign_vote(type_, hash_, header)
        except Exception:
            if not self.replay_mode:
                self.logger.exception("error signing vote %d/%d", rs.height, rs.round_)
            return None
        self.send_internal_message(MsgInfo(msgs.VoteMessage(vote)))
        self.logger.info("signed and pushed vote %r", vote)
        return vote


class _NullCache:
    def fire_event(self, event, data):
        pass

    def flush(self):
        pass
