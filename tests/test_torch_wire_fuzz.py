"""The port's attacker-facing JSON decode surface on the cases of
tests/test_wire_fuzz.py; the last case holds each outcome against the
JAX package's on the same seeded inputs.

Seeded structural fuzz of the attacker-facing JSON decode surface:
msg_from_json (consensus wire), Block/Vote/Commit from_json. Contract
under test: ANY input either decodes or raises ValueError — never any
other exception type (a KeyError/TypeError/AttributeError escaping a
decode path would crash a reactor thread instead of disconnecting the
peer). The reference gets this from go-wire's typed byte decoding; our
equivalent is codec/jsonval + per-type from_json validation.

Deterministic (seeded) so failures reproduce; prints the failing value.
"""

from __future__ import annotations

import random

import pytest

from tendermint_tpu_torch.consensus.messages import msg_from_json, msg_to_json

SEED = 20260730


def _rand_scalar(rng):
    return rng.choice([
        None, True, False, 0, 1, -1, 5, 257, 1 << 40, 1 << 70, -(1 << 70),
        0.5, float("nan"), "", "x", "5", "ff", "zz", "ab" * 20, "ab" * 200,
        [], {}, [1, 2], b"".hex(),
    ])


def _rand_json(rng, depth=0):
    if depth >= 3 or rng.random() < 0.5:
        return _rand_scalar(rng)
    if rng.random() < 0.5:
        return [_rand_json(rng, depth + 1) for _ in range(rng.randrange(3))]
    return {
        rng.choice([
            "type", "data", "height", "round", "step", "hash", "parts",
            "block_id", "signature", "validator_index", "bits", "elems",
            "total", "proof", "index", "bytes", "votes", "pub_key",
        ]): _rand_json(rng, depth + 1)
        for _ in range(rng.randrange(4))
    }


MSG_TYPES = [
    "new_round_step", "commit_step", "proposal", "proposal_pol",
    "block_part", "vote", "has_vote", "vote_set_maj23", "vote_set_bits",
    "heartbeat",
]


def test_random_structures_decode_or_valueerror():
    rng = random.Random(SEED)
    for i in range(2000):
        obj = _rand_json(rng)
        try:
            msg_from_json(obj)
        except ValueError:
            pass
        except Exception as exc:  # noqa: BLE001 — the contract violation
            pytest.fail(f"case {i}: {type(exc).__name__}: {exc!r} on {obj!r}")


def test_random_bodies_per_message_type():
    rng = random.Random(SEED + 1)
    for i in range(2000):
        obj = {"type": rng.choice(MSG_TYPES), "data": _rand_json(rng)}
        try:
            msg_from_json(obj)
        except ValueError:
            pass
        except Exception as exc:  # noqa: BLE001
            pytest.fail(f"case {i}: {type(exc).__name__}: {exc!r} on {obj!r}")


def _valid_messages():
    """Round-trippable real messages to corrupt field-by-field."""
    msgs = [
        {"type": "new_round_step",
         "data": {"height": 5, "round": 0, "step": 1,
                  "seconds_since_start_time": 0, "last_commit_round": -1}},
        {"type": "has_vote",
         "data": {"height": 2, "round": 1, "type": 1, "index": 3}},
        {"type": "proposal_pol",
         "data": {"height": 1, "proposal_pol_round": 0,
                  "proposal_pol": {"bits": 4, "elems": "f"}}},
    ]
    return msgs


def test_single_field_corruptions_of_valid_messages():
    rng = random.Random(SEED + 2)
    for base in _valid_messages():
        decoded = msg_from_json(base)
        assert msg_from_json(msg_to_json(decoded)) is not None  # round trip
        for _ in range(300):
            obj = {"type": base["type"], "data": dict(base["data"])}
            key = rng.choice(list(obj["data"].keys()))
            obj["data"][key] = _rand_json(rng)
            try:
                msg_from_json(obj)
            except ValueError:
                pass
            except Exception as exc:  # noqa: BLE001
                pytest.fail(
                    f"{type(exc).__name__}: {exc!r} corrupting "
                    f"{base['type']}.{key} with {obj['data'][key]!r}"
                )


class _FuzzSwitch:
    """Records stop_peer_for_error instead of tearing anything down."""

    def __init__(self):
        self.stopped = []

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append(reason)


class _FuzzPeer:
    node_info = None
    stream = None

    def id(self):
        return "fuzz-peer"

    def try_send(self, ch, data):
        return True

    def get(self, key):
        return None


def test_reactor_receive_paths_never_leak_exceptions():
    """Drive every reactor's receive() with random wire bytes: the ONLY
    acceptable outcomes are silent handling or stop_peer_for_error —
    an exception here would kill the p2p recv routine for that peer (the
    DoS class the bounded-decode contract exists to prevent)."""
    import json as _json

    rng = random.Random(SEED + 4)
    peer = _FuzzPeer()

    def payloads():
        for _ in range(400):
            kind = rng.random()
            if kind < 0.2:
                yield bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
            elif kind < 0.4:
                yield _json.dumps(_rand_json(rng)).encode()
            else:
                yield _json.dumps({
                    "type": rng.choice([
                        "tx", "pex_request", "pex_addrs", "block_request",
                        "block_response", "status_request", "status_response",
                        "no_block_response", 7, None,
                    ]),
                    rng.choice(["tx", "height", "block", "addrs"]):
                        _rand_json(rng),
                }).encode()

    # mempool reactor
    from tendermint_tpu_torch.abci.apps.counter import CounterApp
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.config import test_config as _cfg
    from tendermint_tpu_torch.mempool import Mempool
    from tendermint_tpu_torch.mempool.reactor import MempoolReactor
    from tendermint_tpu_torch.proxy.app_conn import AppConnMempool

    mp = Mempool(_cfg().mempool, AppConnMempool(LocalClient(CounterApp())))
    mr = MempoolReactor(_cfg().mempool, mp)
    mr.switch = _FuzzSwitch()
    for data in payloads():
        mr.receive(0x30, peer, data)

    # the PEX reactor's leg waits for p2p/pex.py and p2p/addrbook.py,
    # which the port does not hold yet

    # blockchain reactor (no pool started; receive must still be safe
    # for request/status shapes — block_response needs the pool, so only
    # decode-failing payloads exercise that branch here, which is the
    # point)
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.libs.db import MemDB
    from tendermint_tpu_torch.state.state import State
    from tests.test_torch_reactors import make_genesis

    doc, _pvs = make_genesis(1)
    st = State.get_state(MemDB(), doc)
    bc = BlockchainReactor(st, None, BlockStore(MemDB()), fast_sync=False)
    bc.switch = _FuzzSwitch()
    for data in payloads():
        bc.receive(0x40, peer, data)


def test_block_and_vote_from_json_fuzz():
    from tendermint_tpu_torch.p2p.node_info import NodeInfo
    from tendermint_tpu_torch.types.block import Block, Commit
    from tendermint_tpu_torch.types.vote import Vote

    rng = random.Random(SEED + 3)
    for i in range(1500):
        obj = _rand_json(rng)
        for cls in (Block, Commit, Vote, NodeInfo):
            try:
                cls.from_json(obj)
            except ValueError:
                pass
            except Exception as exc:  # noqa: BLE001
                pytest.fail(
                    f"case {i}: {cls.__name__}.from_json -> "
                    f"{type(exc).__name__}: {exc!r} on {obj!r}"
                )


def test_node_info_handshake_roundtrip_and_corruptions():
    from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
    from tendermint_tpu_torch.p2p.node_info import NodeInfo, default_version

    info = NodeInfo(
        pub_key=gen_priv_key_ed25519(b"\x44" * 32).pub_key(),
        moniker="fuzz", network="net", version=default_version("t"),
        listen_addr="1.2.3.4:46656", channels=b"\x20\x30\x40",
        other=["a=b"],
    )
    decoded = NodeInfo.from_json(info.to_json())
    assert decoded.pub_key.raw == info.pub_key.raw
    assert decoded.channels == info.channels
    rng = random.Random(SEED + 5)
    base = info.to_json()
    for _ in range(600):
        obj = dict(base)
        obj[rng.choice(list(obj.keys()))] = _rand_json(rng)
        try:
            NodeInfo.from_json(obj)
        except ValueError:
            pass
        except Exception as exc:  # noqa: BLE001
            pytest.fail(f"{type(exc).__name__}: {exc!r} on {obj!r}")


def test_decode_outcomes_equal_jax():
    """The same seeded structures and per-type bodies decode in both
    packages to the same outcome: a ValueError in both, or messages whose
    JSON forms are equal."""
    from tendermint_tpu.consensus.messages import msg_from_json as jmsg_from_json
    from tendermint_tpu.consensus.messages import msg_to_json as jmsg_to_json

    def outcome(dec, enc, obj):
        try:
            return enc(dec(obj))
        except ValueError:
            return "ValueError"

    rng = random.Random(SEED + 9)
    for i in range(1500):
        obj = _rand_json(rng) if i % 2 else {"type": rng.choice(MSG_TYPES), "data": _rand_json(rng)}
        mine = outcome(msg_from_json, msg_to_json, obj)
        assert mine == outcome(jmsg_from_json, jmsg_to_json, obj), (i, obj)
    for base in _valid_messages():
        assert outcome(msg_from_json, msg_to_json, base) == outcome(jmsg_from_json, jmsg_to_json, base) != "ValueError"
