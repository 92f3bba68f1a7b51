"""Consensus-thread vote micro-batching (docs/committee.md).

At 100-400 validators LIVE consensus receives ~2N gossiped votes per
height; without batching each one pays its own signature verify on the
receive routine — ~800 serial Ed25519 calls per height at N=400, on the
exact thread whose latency bounds the chain. The VoteBatcher drains the
run of votes the receive routine just pulled off its input queue, groups
them by (height, round, type), and dispatches each group as ONE
``Verifier.verify_batch_async`` gateway call (B1 on the card from the
size gate, streamed devd chunks when a daemon serves) while the
routine gets on with handling the messages strictly in order.

Contract:

- The prepare-time screen is ADVISORY: ``VoteSet.begin_add`` remains the
  authoritative structural check at handling time (handling vote k-1 can
  change vote k's context — a quorum mid-run commits the height). A vote
  the screen skipped, or whose group stayed below the min-batch floor,
  simply verifies as a singleton at ``verdict`` time — identical result,
  CPU latency path.
- Per-lane verdicts preserve per-vote error attribution: one forged
  signature inside a batch rejects exactly that vote (commit_add raises
  for its lane only) and peer-errors only its sender.
- A batch that fails re-raises its error where each lane's verdict is
  read (the port's gateway _PendingBatch rule): no vote of it re-verifies
  as a singleton, and a device error stops consensus
  (consensus/state.py). On the devd route the gateway's breaker serves
  the lanes from the native CPU floor instead, as in the JAX package.
- Singleton fallback: below ``TENDERMINT_VOTE_BATCH_MIN`` (default 4)
  no batch is dispatched; WAL replay never reaches prepare at all
  (consensus/replay.py feeds messages one at a time outside the receive
  routine), so replay determinism is untouched by construction.

The pending-batch machinery is the gateway's prime plane, not a
copy: prepare dispatches each group through
``Verifier.prime_cache_async`` (whose _PendingBatch always drains the
transport and FIFO-bounds unconsumed lanes) and ``verdict`` pops lanes
via ``Verifier.pop_primed`` — this module only adds the grouping policy
and the counters/histogram.

Observability: ``consensus_vote_batches`` / ``consensus_vote_singletons``
flat gauges on the canonical map plus the
``consensus_vote_verify_batch_seconds`` histogram (dispatch -> per-lane
verdicts, one observe per micro-batch) on GET /metrics.
"""

from __future__ import annotations

import logging
import threading

from tendermint_tpu_torch.libs import telemetry
from tendermint_tpu_torch.libs.envknob import env_number
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE

logger = logging.getLogger("consensus.vote_batcher")

Item = tuple[bytes, bytes, bytes]  # (pubkey, sign_bytes, signature)

_hist_cache: dict = {}
_hist_mtx = threading.Lock()


def vote_batch_hists() -> dict:
    """Materialize (create-or-get) the vote-plane latency histogram on
    the default registry — called from node telemetry wiring so the
    scrape family set is stable from the first height (the
    pipeline_hists convention)."""
    with _hist_mtx:
        if not _hist_cache:
            _hist_cache["batch"] = telemetry.default_registry().histogram(
                "consensus_vote_verify_batch_seconds",
                "wall seconds from vote micro-batch dispatch to per-lane "
                "verdicts (one observe per batched gateway call the "
                "consensus receive routine drained)",
            )
        return dict(_hist_cache)


class VoteBatcher:
    """The consensus thread's micro-batch front for vote signatures.

    ``verifier_fn`` is a zero-arg getter for the gateway Verifier (the
    consensus state's verifier is test-swappable after construction, so
    the batcher must never pin an instance)."""

    def __init__(self, verifier_fn, min_batch: int | None = None):
        self._verifier_fn = verifier_fn
        if min_batch is None:
            min_batch = int(
                env_number("TENDERMINT_VOTE_BATCH_MIN", 4, cast=int)
            )
        self.min_batch = max(2, min_batch)
        # flat counters for the canonical metrics map (node/telemetry.py)
        self.batches = 0          # micro-batches dispatched
        self.batched_sigs = 0     # signature lanes those batches carried
        self.singletons = 0       # verdicts that fell to the one-sig path
        self._hist = vote_batch_hists()["batch"]

    # -- dispatch (receive routine, on a drained run) ----------------------

    def prepare(self, votes: list, rs, chain_id: str) -> None:
        """Advisory verify-ahead over a drained run of gossiped votes.
        Groups the structurally-plausible lanes by (height, round, type)
        and dispatches one async gateway batch per group at or above the
        min-batch floor. Never a correctness dependency: every screen
        here is re-run authoritatively by begin_add at handling time."""
        groups: dict[tuple, list[Item]] = {}
        seen: set[Item] = set()
        sb_cache: dict[tuple, bytes] = {}
        for v in votes:
            if v.signature is None:
                continue
            vs = self._target_vote_set(v, rs)
            if vs is None:
                continue
            # validator lookup FIRST: it bounds-checks the index, which
            # VoteSet.get_by_index below does not — an adversarial index
            # must fall through to begin_add's error taxonomy, not raise
            addr, val = vs.val_set.get_by_index(v.validator_index)
            if val is None or addr != v.validator_address:
                continue
            if vs.get_by_index(v.validator_index) is not None:
                continue  # duplicate gossip: begin_add screens before verify
            sbk = (v.height, v.round_, v.type_, v.block_id.key())
            sb = sb_cache.get(sbk)
            if sb is None:
                sb = sb_cache[sbk] = v.sign_bytes(chain_id)
            item = (val.pub_key.raw, sb, v.signature.raw)
            if item in seen:
                continue
            seen.add(item)
            groups.setdefault((v.height, v.round_, v.type_), []).append(item)
        verifier = self._verifier_fn()
        for items in groups.values():
            if len(items) < self.min_batch:
                continue  # singleton fallback below the floor
            # the gateway prime plane owns the in-flight machinery: the
            # _PendingBatch always drains the transport, FIFO-bounds
            # never-consumed lanes (votes screened out at handling
            # time), and re-raises a failed resolve where a lane is read
            verifier.prime_cache_async(items, on_done=self._hist.observe)
            self.batches += 1
            self.batched_sigs += len(items)

    def _target_vote_set(self, v, rs):
        """The VoteSet this vote would land in, per add_vote's routing:
        current-height prevote/precommit sets, or the previous height's
        last_commit for commit-time stragglers (the catchup-gossip flood
        a big committee produces right after every commit)."""
        if v.height == rs.height and rs.votes is not None:
            return (
                rs.votes.prevotes(v.round_)
                if v.type_ == VOTE_TYPE_PREVOTE
                else rs.votes.precommits(v.round_)
                if v.type_ == VOTE_TYPE_PRECOMMIT
                else None
            )
        lc = rs.last_commit
        if (
            lc is not None
            and v.height + 1 == rs.height
            and v.type_ == VOTE_TYPE_PRECOMMIT
            and v.round_ == lc.round_
        ):
            return lc
        return None

    # -- verdicts (handling time) ------------------------------------------

    def verdict(self, item: Item) -> bool:
        """The signature verdict for one pending vote: its primed
        micro-batch lane when the prepare pass covered it (single-use —
        blocks for the batch on first need), else a singleton verify."""
        verifier = self._verifier_fn()
        ok = verifier.pop_primed(item)
        if ok is not None:
            return ok
        self.singletons += 1
        return verifier.verify_one(*item)
