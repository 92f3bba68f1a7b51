"""The port's host types of the execution path (types/priv_validator,
types/proposal, types/heartbeat, types/genesis, types/events,
types/block_meta, types/services, and ValidatorSet's membership changes)
against the JAX package's, on the same inputs.

The cases of tests/test_types.py that the port lacked (TestPrivValidator,
TestGenesis, TestValidatorSet::test_add_update_remove,
TestSignBytesFormat::test_proposal_sign_bytes_layout) run through each
package from seeded keys, and what they observe is equal: signatures,
sign bytes, the files written, the errors raised.
"""

from __future__ import annotations

import importlib
import json
import types

import pytest


def _pkg(root: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    pv = mod("types.priv_validator")
    genesis = mod("types.genesis")
    events = mod("types.events")
    return types.SimpleNamespace(
        root=root,
        PrivValidatorFS=pv.PrivValidatorFS,
        DoubleSignError=pv.DoubleSignError,
        STEP_PREVOTE=pv.STEP_PREVOTE,
        Proposal=mod("types.proposal").Proposal,
        Heartbeat=mod("types.heartbeat").Heartbeat,
        GenesisDoc=genesis.GenesisDoc,
        GenesisValidator=genesis.GenesisValidator,
        Vote=mod("types.vote").Vote,
        VOTE_TYPE_PREVOTE=mod("types.vote").VOTE_TYPE_PREVOTE,
        VOTE_TYPE_PRECOMMIT=mod("types.vote").VOTE_TYPE_PRECOMMIT,
        BlockID=mod("types.block_id").BlockID,
        PartSetHeader=mod("types.block_id").PartSetHeader,
        Validator=mod("types.validator").Validator,
        ValidatorSet=mod("types.validator_set").ValidatorSet,
        BlockMeta=mod("types.block_meta").BlockMeta,
        Block=mod("types.block").Block,
        empty_commit=mod("types.block").empty_commit,
        MockMempool=mod("types.services").MockMempool,
        events=events,
        EventSwitch=mod("libs.events").EventSwitch,
        EventCache=mod("libs.events").EventCache,
        gen_priv_key_ed25519=mod("crypto.keys").gen_priv_key_ed25519,
        types_pkg=mod("types"),
    )


PORT = _pkg("tendermint_tpu_torch")
JAX = _pkg("tendermint_tpu")


def both(body, tmp_path=None):
    """Run `body(pkg, dir)` through the port and the JAX package, each in
    a directory of its own; what each observes must be equal. Returns the
    port's observation."""
    def run(p):
        if tmp_path is None:
            return body(p, None)
        d = tmp_path / p.root
        d.mkdir()
        return body(p, d)

    got = run(PORT)
    assert got == run(JAX)
    return got


def _block_id(p):
    return p.BlockID(b"\xaa" * 20, p.PartSetHeader(2, b"\xbb" * 20))


def _pv(p, path, seed=b"pv-seed"):
    return p.PrivValidatorFS(p.gen_priv_key_ed25519(seed), str(path) if path else None)


def _raises(p, fn):
    with pytest.raises(p.DoubleSignError) as e:
        fn()
    return str(e.value)


class TestPrivValidator:
    def test_sign_and_persist(self, tmp_path):
        def body(p, d):
            path = d / "priv_validator.json"
            pv = _pv(p, path)
            pv.save()
            pv = p.PrivValidatorFS.load_or_generate(str(path))
            vote = p.Vote(pv.get_address(), 0, 5, 0, p.VOTE_TYPE_PREVOTE, _block_id(p))
            signed = pv.sign_vote("c", vote)
            ok = pv.get_pub_key().verify_bytes(vote.sign_bytes("c"), signed.signature)
            # reload: the last-sign state survives
            pv2 = p.PrivValidatorFS.load(str(path))
            return (ok, pv2.last_height, pv2.last_step == p.STEP_PREVOTE,
                    pv2.get_address() == pv.get_address(), signed.signature.raw, path.read_bytes())

        got = both(body, tmp_path)
        assert got[:4] == (True, 5, True, True)

    def test_double_sign_prevention(self, tmp_path):
        def body(p, d):
            pv = _pv(p, d / "pv.json")
            addr, bid = pv.get_address(), _block_id(p)
            pv.sign_vote("c", p.Vote(addr, 0, 5, 1, p.VOTE_TYPE_PREVOTE, bid))
            errs = [
                # a conflicting payload at the same HRS
                _raises(p, lambda: pv.sign_vote("c", p.Vote(addr, 0, 5, 1, p.VOTE_TYPE_PREVOTE, p.BlockID()))),
                _raises(p, lambda: pv.sign_vote("c", p.Vote(addr, 0, 4, 0, p.VOTE_TYPE_PREVOTE, bid))),
                _raises(p, lambda: pv.sign_vote("c", p.Vote(addr, 0, 5, 0, p.VOTE_TYPE_PREVOTE, bid))),
            ]
            # a step regression: precommit, then prevote in the same round
            pv.sign_vote("c", p.Vote(addr, 0, 5, 1, p.VOTE_TYPE_PRECOMMIT, bid))
            errs.append(_raises(p, lambda: pv.sign_vote("c", p.Vote(addr, 0, 5, 1, p.VOTE_TYPE_PREVOTE, bid))))
            return errs, (d / "pv.json").read_bytes()

        errs, _ = both(body, tmp_path)
        assert errs == ["step regression (conflicting payload)", "height regression",
                        "round regression", "step regression"]

    def test_same_payload_replay_returns_same_sig(self, tmp_path):
        def body(p, d):
            pv = _pv(p, d / "pv.json")
            v = p.Vote(pv.get_address(), 0, 5, 1, p.VOTE_TYPE_PREVOTE, _block_id(p))
            return pv.sign_vote("c", v).signature.raw, pv.sign_vote("c", v).signature.raw

        s1, s2 = both(body, tmp_path)
        assert s1 == s2

    def test_proposal_signing(self, tmp_path):
        def body(p, d):
            pv = _pv(p, d / "pv.json")
            prop = p.Proposal(3, 0, p.PartSetHeader(2, b"\xee" * 20))
            signed = pv.sign_proposal("c", prop)
            ok = pv.get_pub_key().verify_bytes(prop.sign_bytes("c"), signed.signature)
            # a vote at the same height and round is a later step: allowed
            pv.sign_vote("c", p.Vote(pv.get_address(), 0, 3, 0, p.VOTE_TYPE_PREVOTE, _block_id(p)))
            # another proposal at the same height and round is a step regression
            err = _raises(p, lambda: pv.sign_proposal("c", p.Proposal(3, 0, p.PartSetHeader(9, b"\xdd" * 20))))
            back = p.Proposal.from_bytes(signed.to_bytes())
            return ok, err, signed.to_bytes(), back.to_json(), p.Proposal.from_json(signed.to_json()).to_bytes()

        ok, err, wire, _, again = both(body, tmp_path)
        assert ok and err == "step regression" and again == wire

    def test_heartbeat_no_hrs_tracking(self, tmp_path):
        def body(p, d):
            pv = _pv(p, d / "pv.json")
            hb = p.Heartbeat(pv.get_address(), 0, 100, 0, 1)
            signed = pv.sign_heartbeat("c", hb)
            ok = pv.get_pub_key().verify_bytes(hb.sign_bytes("c"), signed.signature)
            return ok, pv.last_height, signed.to_json(), p.Heartbeat.from_json(signed.to_json()).to_json()

        ok, last_height, js, again = both(body, tmp_path)
        assert ok and last_height == 0 and js == again


class TestGenesis:
    def test_roundtrip_and_validation(self, tmp_path):
        def body(p, d):
            privs = [_pv(p, None, f"g-{i}".encode()) for i in range(3)]
            doc = p.GenesisDoc(
                genesis_time_ns=1_500_000_000 * 10**9, chain_id="test-chain",
                validators=[p.GenesisValidator(pv.get_pub_key(), 10, f"v{i}") for i, pv in enumerate(privs)],
                upgrade_height=5, upgrade_format="aggregate",
            )
            doc.validate_and_complete()
            path = d / "genesis.json"
            doc.save_as(str(path))
            doc2 = p.GenesisDoc.from_file(str(path))
            return (doc2.chain_id, doc2.validator_hash() == doc.validator_hash(), doc2.validator_hash(),
                    doc2.consensus_params.block_gossip.block_part_size_bytes, doc2.schedule_string(),
                    [doc2.commit_format_at(h) for h in (1, 4, 5, 9)], doc2.aggregate_commits(),
                    path.read_bytes())

        got = both(body, tmp_path)
        assert got[:2] == ("test-chain", True) and got[3] == 65536
        assert got[4:7] == ("full>aggregate@5", ["full", "full", "aggregate", "aggregate"], True)

    def test_invalid_docs(self):
        def body(p, _d):
            pub = _pv(p, None, b"z").get_pub_key()
            docs = [
                p.GenesisDoc(0, "", []),
                p.GenesisDoc(0, "c", []),
                p.GenesisDoc(0, "c", [p.GenesisValidator(pub, 0)]),
                p.GenesisDoc(0, "c", [p.GenesisValidator(pub, 1)], commit_format="bls"),
                p.GenesisDoc(0, "c", [p.GenesisValidator(pub, 1)], upgrade_height=1, upgrade_format="aggregate"),
                p.GenesisDoc(0, "c", [p.GenesisValidator(pub, 1)], upgrade_height=3, upgrade_format="full"),
                p.GenesisDoc(0, "c", [p.GenesisValidator(pub, 1)], upgrade_format="aggregate"),
            ]
            errs = []
            for doc in docs:
                with pytest.raises(ValueError) as e:
                    doc.validate_and_complete()
                errs.append(str(e.value))
            return errs

        assert len(set(both(body))) == 7


def test_validator_set_add_update_remove():
    def body(p, _d):
        privs = [_pv(p, None, f"val-{i}".encode()) for i in range(3)]
        vs = p.ValidatorSet([p.Validator.new(pv.get_pub_key(), 10) for pv in privs])
        new_pub = _pv(p, None, b"new-val").get_pub_key()
        new_val = p.Validator.new(new_pub, 5)
        out = [vs.add(new_val), vs.add(new_val), vs.size(), vs.has_address(new_val.address), vs.hash()]
        out.append(vs.update(p.Validator.new(new_pub, 15)))
        out.append(vs.get_by_address(new_val.address)[1].voting_power)
        cp = vs.copy()
        removed, ok = vs.remove(new_val.address)
        out += [ok, removed.voting_power, vs.size(), vs.get_by_address(new_val.address)[1],
                vs.remove(new_val.address), vs.update(new_val), vs.total_voting_power(),
                cp.size(), cp.total_voting_power(), cp.get_proposer().address, vs.get_proposer().address]
        return out

    got = both(body)
    assert got[:4] == [True, False, 4, True] and got[5:7] == [True, 15]
    assert got[7:14] == [True, 15, 3, None, (None, False), False, 30]


def test_proposal_sign_bytes_layout():
    def body(p, _d):
        prop = p.Proposal(10, 2, p.PartSetHeader(3, b"\xab" * 20), -1, p.BlockID())
        sb = prop.sign_bytes("chain")
        return sb, json.loads(sb)

    sb, obj = both(body)
    assert obj["proposal"]["pol_round"] == -1 and obj["proposal"]["round"] == 2
    assert "proposal" in obj and "chain_id" in obj


def test_events_block_meta_and_mock_mempool():
    """The event taxonomy's keys and payload JSON, a BlockMeta's JSON
    round trip, and the no-op mempool, equal in both packages."""

    def body(p, _d):
        sw = p.EventSwitch()
        got = []
        tx = b"watched=1"
        key = p.events.event_string_tx_from_data(p.events.EventDataTx(1, tx, b"", "", 0))
        sw.add_listener_for_event("t", key, lambda d: got.append(d.to_json()))
        cache = p.EventCache(sw)
        p.events.fire_event_tx(cache, p.events.EventDataTx(3, tx, b"\x01", "ok", 0))
        before = list(got)
        cache.flush()
        block, parts = p.Block.make_block(1, "c", [tx], p.empty_commit(), p.BlockID(), b"", b"", 4096,
                                          time_ns=10**9)
        meta = p.BlockMeta.from_block(block, parts)
        back = p.BlockMeta.from_json(meta.to_json())
        mm = p.MockMempool()
        mm.lock()
        mm.update(1, [tx])
        mm.unlock()
        names = sorted(n for n in vars(p.events) if n.startswith("EVENT_"))
        return (key, before, got, meta.to_json(), back.block_id == meta.block_id, mm.size(), mm.reap(-1),
                [getattr(p.events, n) for n in names])

    got = both(body)
    assert got[1] == [] and len(got[2]) == 1 and got[4] and got[5:7] == (0, [])
    # the types package exports the JAX package's names, but for the vote
    # type check that comes with consensus
    assert set(JAX.types_pkg.__all__) - set(PORT.types_pkg.__all__) == {"is_vote_type_valid"}
    assert set(PORT.types_pkg.__all__) <= set(JAX.types_pkg.__all__)
