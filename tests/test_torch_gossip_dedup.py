"""The port's has-vote-aware gossip dedup (consensus/reactor.py's
gossip_dedup knob, docs/localnet.md) on the cases of
tests/test_gossip_dedup.py.

The 2NxN redundancy mechanism: every validator's vote reaches every node
~2N times because the pick/send loops only learn what a peer holds from
votes we sent it or full VoteSetBits exchanges. With
`consensus.gossip_dedup` on (the default), the STATE channel feeds the
HasVote announcements into the mirror and the part-set gossip gains the
same screen (HasBlockPartMessage). The two live-net cases run the port's
reactors over pipe switches (the JAX package's run its node-level
ChaosNet, which the port gets with the node, A.7e-2); the last case holds
the mirrors and the relay hold against the JAX package's."""

from __future__ import annotations

import pytest

from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus.reactor import (
    PEER_STATE_KEY,
    STATE_CHANNEL,
    ConsensusReactor,
    PeerState,
    _enc,
)
from tendermint_tpu_torch.libs.bitarray import BitArray
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE
from tests.test_torch_consensus import host_device  # noqa: F401 — autouse fixture


class _VoteSet:
    """Minimal vote_set: holds the given indices at (height, round, type)."""

    def __init__(self, height, round_, type_, indices, size=4):
        self.height, self.round_, self.type_ = height, round_, type_
        self._indices = list(indices)
        self._size = size

    def size(self):
        return self._size

    def bit_array(self):
        return BitArray.from_indices(self._size, self._indices)

    def get_by_index(self, index):
        assert index in self._indices
        return ("vote", index)


def test_has_vote_announcement_suppresses_pick():
    """The core dedup claim: a HasVote announcement alone (no vote
    round-trip) must stop the picker from pushing that vote to the
    announcing peer."""
    ps = PeerState(peer=None)
    ps.prs.height, ps.prs.round_ = 5, 0
    ps.ensure_vote_bit_arrays(5, 4)
    vs = _VoteSet(5, 0, VOTE_TYPE_PREVOTE, [1, 2])

    assert ps.apply_has_vote(msgs.HasVoteMessage(5, 0, VOTE_TYPE_PREVOTE, 1))
    # index 1 is now known-held: only index 2 remains pickable
    for _ in range(8):
        vote = ps.pick_vote_to_send(vs)
        assert vote == ("vote", 2)

    assert ps.apply_has_vote(msgs.HasVoteMessage(5, 0, VOTE_TYPE_PREVOTE, 2))
    assert ps.pick_vote_to_send(vs) is None


def test_has_vote_mid_pick_race_is_benign():
    """A HasVote landing BETWEEN pick and send is the unavoidable race
    (the peer's announcement and our push cross on the wire). The send
    still goes out — one harmless duplicate — but the bit the HasVote
    set must survive the send's own marking, even a FAILED send: a
    failed send leaves the bit as the HasVote left it (held), so the
    picker doesn't re-push a vote the peer itself told us it has."""

    class _Peer:
        def __init__(self, ok):
            self.ok = ok

        def send(self, ch, raw):
            return self.ok

    class _Vote:
        height, round_, type_, validator_index = 5, 0, VOTE_TYPE_PREVOTE, 1

        def to_json(self):
            return {"height": self.height}

    ps = PeerState(peer=None)
    ps.prs.height, ps.prs.round_ = 5, 0
    ps.ensure_vote_bit_arrays(5, 4)
    vs = _VoteSet(5, 0, VOTE_TYPE_PREVOTE, [1])

    picked = ps.pick_vote_to_send(vs)
    assert picked == ("vote", 1)
    # the race: the peer announces the same vote before our send lands
    assert ps.apply_has_vote(msgs.HasVoteMessage(5, 0, VOTE_TYPE_PREVOTE, 1))
    # failed send: the gossip without dedup would retry the vote forever
    # (bit only ever set on successful send) — the announcement must win
    assert not ConsensusReactor._send_vote(None, _Peer(ok=False), ps, _Vote())
    assert ps.pick_vote_to_send(vs) is None, (
        "a vote the peer announced must stay unpickable after a failed send"
    )
    # and a successful send re-marking the same bit is idempotent
    assert ConsensusReactor._send_vote(None, _Peer(ok=True), ps, _Vote())
    assert ps.pick_vote_to_send(vs) is None


def test_last_commit_has_vote_lands_only_with_dedup():
    """A node that just committed H keeps broadcasting HasVotes for its
    H-precommits while peers' mirrors already show it at H+1. The
    strict gate (without dedup) dropped ALL of them — so everyone kept
    re-pushing commit votes the node already held. With
    allow_last_commit the announcement routes into the last_commit
    tracking array."""
    ps = PeerState(peer=None)
    ps.prs.height, ps.prs.round_ = 6, 0
    ps.prs.last_commit_round = 0
    ps.ensure_vote_bit_arrays(5, 4)  # height+1 branch -> last_commit array
    announce = msgs.HasVoteMessage(5, 0, VOTE_TYPE_PRECOMMIT, 2)

    assert not ps.apply_has_vote(announce)  # strict gate: dropped
    assert ps.apply_has_vote(announce, allow_last_commit=True)

    # the last-commit picker now skips the announced vote
    last = _VoteSet(5, 0, VOTE_TYPE_PRECOMMIT, [2, 3])
    assert ps.pick_vote_to_send(last) == ("vote", 3)


def test_laggard_catchup_branch_unaffected_by_dedup():
    """The stored-commit catchup path (peer >= 2 heights behind) must
    keep working under dedup: HasVotes from the laggard for its OWN
    height route into the catchup-commit array (so we skip what it
    has), and announcements for coordinates no array tracks are
    DROPPED, never mis-filed into a same-index bit of another round."""
    ps = PeerState(peer=None)
    ps.prs.height, ps.prs.round_ = 5, 2  # laggard raced past commit round 0
    ps.ensure_vote_bit_arrays(5, 4)

    # an announcement for the untracked commit round is dropped...
    stray = msgs.HasVoteMessage(5, 0, VOTE_TYPE_PRECOMMIT, 1)
    assert not ps.apply_has_vote(stray, allow_last_commit=True)
    # ...and did not leak into the round-2 precommit array
    assert ps.prs.precommits.is_empty()

    # the catchup branch then ensures the commit-round array; the same
    # announcement now lands there and the commit picker skips it
    ps.ensure_catchup_commit_round(5, 0, 4)
    assert ps.apply_has_vote(stray, allow_last_commit=True)
    commit_votes = _VoteSet(5, 0, VOTE_TYPE_PRECOMMIT, [1, 3])
    assert ps.pick_vote_to_send(commit_votes) == ("vote", 3)


# -- the reactor's STATE-channel wiring ---------------------------------------


class _Validators:
    def __init__(self, n):
        self._n = n

    def size(self):
        return self._n


class _RoundState:
    def __init__(self, height, n=4):
        self.height = height
        self.validators = _Validators(n)
        self.last_commit = _Validators(n)  # only size() is consulted


class _ConState:
    def __init__(self, height=5, gossip_dedup=True):
        from types import SimpleNamespace

        self.config = SimpleNamespace(gossip_dedup=gossip_dedup)
        self._rs = _RoundState(height)
        self.vote_recv_mono = {}

    def get_round_state(self):
        return self._rs


class _StubPeer:
    def __init__(self):
        self._kv = {}

    def id(self):
        return "stub-peer-0000"

    def get(self, k):
        return self._kv.get(k)

    def set(self, k, v):
        self._kv[k] = v

    def send(self, ch, raw):
        return True

    def try_send(self, ch, raw):
        return True


def _reactor_with_peer(gossip_dedup: bool):
    r = ConsensusReactor(_ConState(height=5, gossip_dedup=gossip_dedup))
    r._started = True  # receive() guards on is_running()
    peer = _StubPeer()
    ps = PeerState(peer)
    ps.prs.height, ps.prs.round_ = 5, 0
    peer.set(PEER_STATE_KEY, ps)
    return r, peer, ps


def test_state_channel_has_vote_ensures_arrays_when_dedup_on():
    """The first-window drop: at a fresh height the mirror has NO bit
    arrays yet, so every early HasVote used to vanish into the
    set_has_vote no-op. With dedup on, receive() ensures the arrays
    (exactly like the VOTE channel does) before applying."""
    r, peer, ps = _reactor_with_peer(gossip_dedup=True)
    assert ps.prs.prevotes is None  # fresh mirror, nothing ensured
    raw = _enc(msgs.HasVoteMessage(5, 0, VOTE_TYPE_PREVOTE, 2))
    r.receive(STATE_CHANNEL, peer, raw)
    assert r.has_votes_applied == 1
    assert ps.pick_vote_to_send(_VoteSet(5, 0, VOTE_TYPE_PREVOTE, [2])) is None


def test_state_channel_has_vote_dropped_when_dedup_off():
    """gossip_dedup=false restores the gossip without dedup exactly —
    the A/B baseline the bench compares against."""
    r, peer, ps = _reactor_with_peer(gossip_dedup=False)
    raw = _enc(msgs.HasVoteMessage(5, 0, VOTE_TYPE_PREVOTE, 2))
    r.receive(STATE_CHANNEL, peer, raw)
    assert r.has_votes_applied == 0
    assert ps.prs.prevotes is None  # no arrays ensured, announcement lost


def test_has_block_part_announcement_marks_mirror():
    """HasBlockPartMessage on the STATE channel marks the peer's
    part-set mirror so gossip_data stops pushing a part the peer
    already assembled — applied regardless of our own knob (free
    information, only ever reduces redundant sends)."""
    r, peer, ps = _reactor_with_peer(gossip_dedup=False)
    ps.set_has_proposal(
        type(
            "P",
            (),
            {
                "height": 5,
                "round_": 0,
                "block_parts_header": type(
                    "H", (), {"total": 4, "hash": b"x"}
                )(),
                "pol_round": -1,
            },
        )()
    )
    assert not ps.prs.proposal_block_parts.get_index(3)
    r.receive(STATE_CHANNEL, peer, _enc(msgs.HasBlockPartMessage(5, 0, 3)))
    assert r.part_announces_applied == 1
    assert ps.prs.proposal_block_parts.get_index(3)


def test_broadcast_has_part_gated_by_knob():
    """Local part adds only announce when the knob is on (the off arm
    of the A/B must not emit the dedup messages at all)."""
    from tendermint_tpu_torch.types.events import EventDataBlockPart

    sent = []

    class _Switch:
        def broadcast(self, ch, raw):
            sent.append((ch, raw))

    data = EventDataBlockPart(height=5, round_=0, index=1)

    r_off = ConsensusReactor(_ConState(gossip_dedup=False))
    r_off.switch = _Switch()
    r_off._broadcast_has_part(data)
    assert not sent and r_off.part_announces_sent == 0

    r_on = ConsensusReactor(_ConState(gossip_dedup=True))
    r_on.switch = _Switch()
    r_on._broadcast_has_part(data)
    assert len(sent) == 1 and sent[0][0] == STATE_CHANNEL
    assert r_on.part_announces_sent == 1
    msg = msgs.msg_from_json(__import__("json").loads(sent[0][1].decode()))
    assert isinstance(msg, msgs.HasBlockPartMessage)
    assert (msg.height, msg.round_, msg.index) == (5, 0, 1)


def test_relay_screen_holds_fresh_votes_only():
    """The lazy-relay screen: a vote we received under VOTE_RELAY_DELAY
    ago is held (its origin is fanning it out and HasVotes are in
    flight); after the hold, or for unstamped votes (our own,
    store-backed catchup commits), relay is immediate. Off-knob nets
    never hold."""
    import time as _time

    from tendermint_tpu_torch.consensus.reactor import VOTE_RELAY_DELAY

    class _V:
        height, round_, type_, validator_index = 5, 0, VOTE_TYPE_PREVOTE, 1

    r = ConsensusReactor(_ConState(gossip_dedup=True))
    assert r._relay_ready(_V())  # unstamped: our own vote

    key = (5, 0, VOTE_TYPE_PREVOTE, 1)
    r.con_s.vote_recv_mono[key] = _time.monotonic()
    assert not r._relay_ready(_V())  # just received: held
    r.con_s.vote_recv_mono[key] = _time.monotonic() - VOTE_RELAY_DELAY - 0.01
    assert r._relay_ready(_V())  # hold expired: genuinely needed

    r_off = ConsensusReactor(_ConState(gossip_dedup=False))
    r_off.con_s.vote_recv_mono[key] = _time.monotonic()
    assert r_off._relay_ready(_V())  # gossip without dedup: no hold


def test_adaptive_relay_delay_clamp_and_fallback():
    """The lazy-relay hold tracks 2x the smoothed
    peer RTT, clamped to [0.5x, 4x] of the constant; no samples keeps
    the constant exactly."""
    from tendermint_tpu_torch.consensus.reactor import (
        VOTE_RELAY_DELAY,
        VOTE_RELAY_DELAY_MAX,
        VOTE_RELAY_DELAY_MIN,
        adaptive_relay_delay,
    )

    assert VOTE_RELAY_DELAY_MIN == pytest.approx(0.5 * VOTE_RELAY_DELAY)
    assert VOTE_RELAY_DELAY_MAX == pytest.approx(4.0 * VOTE_RELAY_DELAY)
    # no samples: the constant, byte-for-byte
    assert adaptive_relay_delay(None) == VOTE_RELAY_DELAY
    # fast LAN: clamps at the floor, never disables the hold
    assert adaptive_relay_delay(0.0005) == VOTE_RELAY_DELAY_MIN
    assert adaptive_relay_delay(0.0) == VOTE_RELAY_DELAY_MIN
    # mid-range: tracks 2x RTT
    assert adaptive_relay_delay(0.08) == pytest.approx(0.16)
    # slow WAN / garbage sample: clamps at the ceiling
    assert adaptive_relay_delay(1.5) == VOTE_RELAY_DELAY_MAX


def test_reactor_relay_delay_reads_rtt_ewma():
    """The reactor's hold: constant with no switch, no registry, or no
    samples; RTT-adaptive once the switch's registry carries ping
    samples (fed by PeerConnMetrics.pong_received)."""
    from tendermint_tpu_torch.consensus.reactor import VOTE_RELAY_DELAY
    from tendermint_tpu_torch.libs import telemetry
    from tendermint_tpu_torch.p2p.telemetry import peer_metrics

    r = ConsensusReactor(_ConState(gossip_dedup=True))
    assert r._relay_delay() == VOTE_RELAY_DELAY  # no switch at all

    class _Switch:
        metrics_registry = None

    r.switch = _Switch()
    assert r._relay_delay() == VOTE_RELAY_DELAY  # switch, no registry

    reg = telemetry.Registry()  # fresh: no cross-test samples
    r.switch.metrics_registry = reg
    assert r._relay_delay() == VOTE_RELAY_DELAY  # registry, no samples

    peer_metrics(reg)["ping_rtt_ewma"].observe(0.08)
    assert r._relay_delay() == pytest.approx(0.16)
    # EWMA moves with new samples, and the clamp still rules
    for _ in range(64):
        peer_metrics(reg)["ping_rtt_ewma"].observe(5.0)
    assert r._relay_delay() == pytest.approx(4.0 * VOTE_RELAY_DELAY)


def test_rtt_ewma_smoothing():
    from tendermint_tpu_torch.p2p.telemetry import RttEwma

    e = RttEwma()
    assert e.value() is None
    e.observe(0.1)
    assert e.value() == pytest.approx(0.1)  # first sample seeds exactly
    e.observe(0.2)
    assert e.value() == pytest.approx(0.1 + 0.2 * (0.2 - 0.1))


def test_vote_recv_stamp_is_bounded():
    """The stamp map self-prunes on overflow — entries only matter for
    one gossip tick, so unbounded growth would be a leak, not memory."""
    import time as _time

    from tendermint_tpu_torch.consensus.state import ConsensusState

    class _S:
        vote_recv_mono: dict = {}

    stamp = ConsensusState._stamp_vote_recv
    s = _S()

    class _V:
        def __init__(self, h):
            self.height, self.round_ = h, 0
            self.type_, self.validator_index = VOTE_TYPE_PREVOTE, h % 100

    for h in range(4096):
        stamp(s, _V(h))
    assert len(s.vote_recv_mono) == 4096
    # age everything out, then one more stamp triggers the sweep
    for k in list(s.vote_recv_mono):
        s.vote_recv_mono[k] = _time.monotonic() - 10.0
    stamp(s, _V(5000))
    assert len(s.vote_recv_mono) == 1


# -- duplicate-ratio direction ------------------------------------------------


def test_announcements_reduce_redundant_sends_across_peer_fan_out():
    """The ratio direction, deterministically: one vote, three peers.
    Without announcements every peer gets a push (3 sends, 2 of which
    the receiving side would count as duplicates once the vote has
    propagated); with HasVotes applied from two peers, only the silent
    one is picked for — redundant sends drop 3 -> 1. This is the causal
    core of the duplicate-ratio drop the n=10 process A/B in
    benches/bench_localnet.py asserts wall-clock."""
    vs = _VoteSet(5, 0, VOTE_TYPE_PREVOTE, [1])

    def fresh_peer():
        ps = PeerState(peer=None)
        ps.prs.height, ps.prs.round_ = 5, 0
        ps.ensure_vote_bit_arrays(5, 4)
        return ps

    peers = [fresh_peer() for _ in range(3)]
    assert sum(ps.pick_vote_to_send(vs) is not None for ps in peers) == 3

    announce = msgs.HasVoteMessage(5, 0, VOTE_TYPE_PREVOTE, 1)
    assert peers[0].apply_has_vote(announce)
    assert peers[1].apply_has_vote(announce)
    picked = [ps.pick_vote_to_send(vs) is not None for ps in peers]
    assert picked == [False, False, True]


def _live_net(dedup: bool, throttle_s: float = 0.0):
    """A 4-validator port net over in-process pipe switches (the harness of
    tests/test_torch_reactors.py) with the gossip_dedup knob set on every
    node; `throttle_s` paces commits (timeout_commit, no skip), as the JAX
    package's ChaosNet(height_throttle_s=) does."""
    from tendermint_tpu_torch.config import test_config as _test_config
    from tendermint_tpu_torch.mempool.reactor import MempoolReactor
    from tendermint_tpu_torch.p2p import make_connected_switches
    from tests.test_torch_reactors import make_genesis, make_node, node_info

    doc, pvs = make_genesis(4)
    nodes = [make_node(doc, pv) for pv in pvs]
    for n in nodes:
        n.cs.config.gossip_dedup = dedup
        if throttle_s:
            n.cs.config.timeout_commit = throttle_s
            n.cs.config.skip_timeout_commit = False

    def init(i, sw):
        con_r = ConsensusReactor(nodes[i].cs, fast_sync=False)
        con_r.set_event_switch(nodes[i].evsw)
        sw.add_reactor("CONSENSUS", con_r)
        sw.add_reactor("MEMPOOL", MempoolReactor(_test_config().mempool, nodes[i].mempool))
        sw.set_node_info(node_info(sw, f"node{i}"))
        return sw

    return nodes, make_connected_switches(4, init)


@pytest.mark.slow
def test_duplicate_ratio_counters_move_on_live_net():
    """The duplicate and dedup counters all move in their right directions
    on a live 4-node net with dedup on: votes are accepted, the 2NxN
    redundancy registers as duplicates (never as accepts), the ratio is
    finite, and the dedup plumbing engages (announcements applied, part
    screens sent and applied). The JAX package's copy runs the node-level
    ChaosNet over TCP (tests/netchaos_common.py, A.7e-2 in the port); this
    one the reactors over pipe switches."""
    from tests.test_torch_reactors import stop_net, wait_until

    nodes, switches = _live_net(True)
    try:
        assert wait_until(lambda: all(n.store.height() >= 8 for n in nodes), timeout=150), \
            [n.store.height() for n in nodes]
        reactors = [sw.reactor("CONSENSUS") for sw in switches]
        dups = sum(n.cs.vote_duplicates for n in nodes)
        acc = sum(n.cs.vote_accepted for n in nodes)
        applied = sum(r.has_votes_applied for r in reactors)
        part_sent = sum(r.part_announces_sent for r in reactors)
        part_applied = sum(r.part_announces_applied for r in reactors)
    finally:
        stop_net(nodes, switches)
    assert acc >= 4 * 2 * 5 * 4
    assert dups > 0
    ratio = dups / acc
    assert 0 < ratio < 10, ratio
    assert applied > 0
    assert part_sent > 0
    assert part_applied > 0


@pytest.mark.slow
def test_dedup_reduces_duplicate_ratio_on_live_net():
    """The directional claim on a live 4-node net: dedup on (HasVote
    exploitation + lazy-relay hold) yields a strictly lower fleet
    duplicate-vote ratio than off, at a paced commit cadence (the hold
    needs a cadence where announcements can land)."""
    from tests.test_torch_reactors import stop_net, wait_until

    def ratio(dedup: bool) -> float:
        nodes, switches = _live_net(dedup, throttle_s=0.25)
        try:
            assert wait_until(lambda: all(n.store.height() >= 10 for n in nodes), timeout=150), \
                [n.store.height() for n in nodes]
            dups = sum(n.cs.vote_duplicates for n in nodes)
            acc = sum(n.cs.vote_accepted for n in nodes)
        finally:
            stop_net(nodes, switches)
        assert acc > 0
        return dups / acc

    on = ratio(True)
    off = ratio(False)
    assert on < off, f"dedup did not reduce duplicates: on={on:.3f} off={off:.3f}"


# -- held against the JAX package ----------------------------------------------


def test_mirror_and_relay_screen_equal_jax():
    """The same HasVote, HasBlockPart and VoteSetBits messages, through each
    package's ConsensusReactor.receive on a fresh peer mirror, leave equal
    mirrors (every tracking array's bits) and equal counters, with dedup on
    and off; and both packages' adaptive_relay_delay agree over a sweep of
    RTTs."""
    import importlib
    import types as _types

    def run(root: str, dedup: bool):
        rmod = importlib.import_module(f"{root}.consensus.reactor")
        mmod = importlib.import_module(f"{root}.consensus.messages")
        bmod = importlib.import_module(f"{root}.libs.bitarray")
        bid = importlib.import_module(f"{root}.types.block_id")
        con = _ConState(height=5, gossip_dedup=dedup)
        con._rs.votes = None  # no vote set of our own: a VoteSetBits replaces the mirror's bits
        r = rmod.ConsensusReactor(con)
        r._started = True
        peer = _StubPeer()
        ps = rmod.PeerState(peer)
        ps.prs.height, ps.prs.round_ = 5, 0
        peer.set(rmod.PEER_STATE_KEY, ps)
        ps.set_has_proposal(_types.SimpleNamespace(
            height=5, round_=0, pol_round=-1,
            block_parts_header=_types.SimpleNamespace(total=4, hash=b"x")))
        block = bid.BlockID(b"\x01" * 20, bid.PartSetHeader(4, b"\x02" * 20))
        msgs_in = [
            mmod.HasVoteMessage(5, 0, VOTE_TYPE_PREVOTE, 2),
            mmod.HasVoteMessage(4, 0, VOTE_TYPE_PRECOMMIT, 1),
            mmod.HasVoteMessage(5, 0, VOTE_TYPE_PRECOMMIT, 3),
            mmod.HasBlockPartMessage(5, 0, 3),
            mmod.HasBlockPartMessage(5, 0, 0),
        ]
        for m in msgs_in:
            r.receive(rmod.STATE_CHANNEL, peer, rmod._enc(m))
        bits = mmod.VoteSetBitsMessage(5, 0, VOTE_TYPE_PREVOTE, block, bmod.BitArray.from_indices(4, [0, 1]))
        r.receive(rmod.VOTE_SET_BITS_CHANNEL, peer, rmod._enc(bits))
        prs = ps.get_round_state()
        arrays = {k: (getattr(prs, k).to_json() if getattr(prs, k) is not None else None)
                  for k in ("prevotes", "precommits", "last_commit", "proposal_block_parts")}
        delays = [rmod.adaptive_relay_delay(x) for x in (None, 0.0, 0.001, 0.03, 0.05, 0.1, 0.5)]
        return arrays, r.has_votes_applied, r.part_announces_applied, delays

    for dedup in (True, False):
        assert run("tendermint_tpu_torch", dedup) == run("tendermint_tpu", dedup)
