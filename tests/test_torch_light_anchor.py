"""The port's persisted light-client trust anchor (node/light_anchor.py),
on the cases of tests/test_light_anchor.py.

A statesync restore walks light-client trust to the restored height but
kept the result only in memory: a wipe-and-restore restart re-anchored
at the operator's configured pin and re-trusted the whole range this
home had already verified. The anchor file closes that window. These
tests cover the round-trip, every strict-load rejection, and the node
wiring (`_make_restorer` resumes from the anchor; an operator pin ABOVE
the anchor still wins)."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.node.light_anchor import anchor_path, load_anchor, save_anchor
from tendermint_tpu_torch.rpc.light import LightClient
from tendermint_tpu_torch.types.block import Header
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tests.test_torch_consensus import host_device  # noqa: F401 — autouse: CPU gateway defaults

CHAIN = "anchor-test-chain"


def _vset(n=2, tag="a"):
    return ValidatorSet(
        [
            Validator.new(
                gen_priv_key_ed25519(f"{CHAIN}-{tag}-{i}".encode()).pub_key(),
                10,
            )
            for i in range(n)
        ]
    )


def _header(height: int, vset: ValidatorSet, chain=CHAIN) -> Header:
    return Header(
        chain_id=chain,
        height=height,
        time_ns=height * 1000,
        num_txs=0,
        last_block_id=BlockID(),
        last_commit_hash=b"\x02" * 20,
        data_hash=b"\x03" * 20,
        validators_hash=vset.hash(),
        app_hash=b"",
    )


def _lc(height: int, vset: ValidatorSet, header: Header | None):
    lc = LightClient(None, CHAIN, vset, trusted_height=height)
    lc._trusted_header = header
    return lc


def test_round_trip_with_header(tmp_path):
    vset = _vset()
    header = _header(7, vset)
    assert save_anchor(str(tmp_path), _lc(7, vset, header))

    got = load_anchor(str(tmp_path), CHAIN)
    assert got is not None
    height, vs, hdr = got
    assert height == 7
    assert vs.hash() == vset.hash()
    assert hdr is not None and hdr.hash() == header.hash()


def test_round_trip_without_header(tmp_path):
    """A restore that never crossed a validator-set change has no
    trusted header yet — the anchor still carries height + set."""
    vset = _vset()
    assert save_anchor(str(tmp_path), _lc(5, vset, None))
    got = load_anchor(str(tmp_path), CHAIN)
    assert got == (5, got[1], None)
    assert got[1].hash() == vset.hash()


def test_save_refuses_unanchored_state(tmp_path):
    vset = _vset()
    assert not save_anchor("", _lc(5, vset, None))  # no home
    assert not save_anchor(str(tmp_path), None)  # no light client
    assert not save_anchor(str(tmp_path), _lc(0, vset, None))  # nothing walked
    assert not os.path.exists(anchor_path(str(tmp_path)))


def test_load_absent_or_corrupt_is_none(tmp_path):
    root = str(tmp_path)
    assert load_anchor(root, CHAIN) is None  # absent
    os.makedirs(os.path.dirname(anchor_path(root)), exist_ok=True)
    with open(anchor_path(root), "w") as f:
        f.write('{"chain_id": "anchor-test-chain", "height":')  # torn write
    assert load_anchor(root, CHAIN) is None


def test_load_rejects_wrong_chain(tmp_path):
    vset = _vset()
    assert save_anchor(str(tmp_path), _lc(7, vset, _header(7, vset)))
    assert load_anchor(str(tmp_path), "some-other-chain") is None


def _mutate(root, **changes):
    with open(anchor_path(root)) as f:
        doc = json.load(f)
    doc.update(changes)
    with open(anchor_path(root), "w") as f:
        json.dump(doc, f)


def test_load_rejects_inconsistent_fields(tmp_path):
    root = str(tmp_path)
    vset = _vset()
    save_anchor(root, _lc(7, vset, _header(7, vset)))
    base = json.load(open(anchor_path(root)))

    # non-positive / non-int heights
    for bad in (0, -3, True, "7", None):
        _mutate(root, height=bad)
        assert load_anchor(root, CHAIN) is None, bad

    # header height disagrees with the anchor height
    _mutate(root, height=base["height"] + 1, header=base["header"])
    assert load_anchor(root, CHAIN) is None

    # header signed by a DIFFERENT set than the persisted one: the
    # file's parts disagree — corrupt, not trustworthy
    other = _vset(tag="b")
    _mutate(root, height=7, header=_header(7, other).to_json())
    assert load_anchor(root, CHAIN) is None

    # garbage validators shape
    _mutate(root, header=base["header"], validators={"nope": 1})
    assert load_anchor(root, CHAIN) is None


# -- node wiring --------------------------------------------------------------


def _stub_node(root: str):
    from tendermint_tpu_torch.blockchain.store import BlockStore

    return SimpleNamespace(
        config=SimpleNamespace(base=SimpleNamespace(root_dir=root)),
        verifier=SimpleNamespace(commit_batch_verifier=lambda: None),
        block_store=BlockStore(MemDB()),
        hasher=None,
    )


def _restorer_for(root: str, vset: ValidatorSet, trust_height: int):
    from tendermint_tpu_torch.node.node import Node

    genesis_doc = SimpleNamespace(
        chain_id=CHAIN,
        validators=[
            SimpleNamespace(pub_key=v.pub_key, power=v.voting_power)
            for _, v in ((vset.get_by_index(i)) for i in range(vset.size()))
        ],
    )
    sc = SimpleNamespace(trust_height=trust_height, rpc_servers="127.0.0.1:1")
    return Node._make_restorer(
        _stub_node(root), sc, object(), genesis_doc, MemDB()
    )


def test_make_restorer_resumes_from_anchor(tmp_path):
    """The restart half of the story: a home whose prior restore
    persisted an anchor at 42 boots its next light client AT 42 with
    the anchored set and header — not at the configured pin below it."""
    genesis_vset = _vset()
    anchored_vset = _vset(tag="later")
    header = _header(42, anchored_vset)
    assert save_anchor(str(tmp_path), _lc(42, anchored_vset, header))

    restorer = _restorer_for(str(tmp_path), genesis_vset, trust_height=3)
    lc = restorer.light_client
    assert lc.height == 42
    assert lc.validators.hash() == anchored_vset.hash()
    assert lc.trusted_header() is not None
    assert lc.trusted_header().hash() == header.hash()


def test_make_restorer_operator_pin_above_anchor_wins(tmp_path):
    """An operator who pins trust ABOVE the anchor means it: the deeper
    (staler) anchor must not drag trust back down."""
    genesis_vset = _vset()
    anchored_vset = _vset(tag="later")
    assert save_anchor(str(tmp_path), _lc(10, anchored_vset, None))

    restorer = _restorer_for(str(tmp_path), genesis_vset, trust_height=50)
    lc = restorer.light_client
    assert lc.height == 50
    assert lc.validators.hash() == genesis_vset.hash()
    assert lc.trusted_header() is None


def test_make_restorer_without_anchor_uses_configured_trust(tmp_path):
    genesis_vset = _vset()
    restorer = _restorer_for(str(tmp_path), genesis_vset, trust_height=3)
    lc = restorer.light_client
    assert lc.height == 3
    assert lc.validators.hash() == genesis_vset.hash()


def test_statesync_complete_persists_anchor(tmp_path):
    """_on_statesync_complete writes the anchor from the restorer's
    walked light client before handing the tail to fast sync."""
    from tendermint_tpu_torch.node.node import Node

    vset = _vset()
    lc = _lc(13, vset, _header(13, vset))
    calls = []
    stub = SimpleNamespace(
        config=SimpleNamespace(base=SimpleNamespace(root_dir=str(tmp_path))),
        statesync_reactor=SimpleNamespace(
            restorer=SimpleNamespace(light_client=lc)
        ),
        blockchain_reactor=SimpleNamespace(
            start_after_statesync=lambda s: calls.append(s)
        ),
    )
    restored = SimpleNamespace(last_block_height=13)
    Node._on_statesync_complete(stub, restored)
    assert calls == [restored]
    assert stub.state is restored
    got = load_anchor(str(tmp_path), CHAIN)
    assert got is not None and got[0] == 13

    # the fallback path (restore failed -> None) must not touch the disk
    os.remove(anchor_path(str(tmp_path)))
    Node._on_statesync_complete(stub, None)
    assert calls[-1] is None
    assert not os.path.exists(anchor_path(str(tmp_path)))


# -- beside the JAX package ---------------------------------------------------


def _both():
    """(root, light_anchor, LightClient, Header, BlockID, Validator,
    ValidatorSet, gen_priv_key_ed25519, Node) of each package."""
    import importlib

    out = []
    for root in ("tendermint_tpu", "tendermint_tpu_torch"):
        m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        out.append((root, m("node.light_anchor"), m("rpc.light").LightClient, m("types.block").Header,
                    m("types.block_id").BlockID, m("types.validator").Validator,
                    m("types.validator_set").ValidatorSet, m("crypto.keys").gen_priv_key_ed25519,
                    m("node.node").Node))
    return out


def _anchor_doc(pkg, height, with_header, tag="a"):
    _root, _la, LC, Hdr, BID, Val, VSet, gen, _node = pkg
    vset = VSet([_validator(Val, gen, f"{CHAIN}-{tag}-{i}") for i in range(3)])
    header = Hdr(chain_id=CHAIN, height=height, time_ns=height * 1000, num_txs=0, last_block_id=BID(),
                 last_commit_hash=b"\x02" * 20, data_hash=b"\x03" * 20, validators_hash=vset.hash(),
                 app_hash=b"")
    lc = LC(None, CHAIN, vset, trusted_height=height)
    lc._trusted_header = header if with_header else None
    return lc, vset, header


def _validator(Val, gen, seed: str):
    return Val.new(gen(seed.encode()).pub_key(), 10)


def _loaded(got):
    if got is None:
        return None
    height, vset, header = got
    return height, vset.to_json(), header.to_json() if header is not None else None


def test_save_and_strict_load_equal_to_jax(tmp_path):
    """Each package saves the same trust state as byte-equal anchor files,
    and both packages' load_anchor take the same decision, and the same
    (height, validators, header), on the good file and on each damaged
    one."""
    files = {}
    for pkg in _both():
        for with_header in (True, False):
            home = str(tmp_path / f"{pkg[0]}-{with_header}")
            lc, _vset, _hdr = _anchor_doc(pkg, 7, with_header)
            assert pkg[1].save_anchor(home, lc)
            with open(pkg[1].anchor_path(home), "rb") as f:
                files[(pkg[0], with_header)] = f.read()
    for with_header in (True, False):
        assert files[("tendermint_tpu_torch", with_header)] == files[("tendermint_tpu", with_header)]

    base = json.loads(files[("tendermint_tpu", True)])
    other_header = _anchor_doc(_both()[0], 7, True, tag="b")[2].to_json()
    variants = [dict(base)]
    variants += [{**base, "height": bad} for bad in (0, -3, True, "7", None, 8)]
    variants += [{**base, "chain_id": "other"}, {**base, "header": other_header},
                 {**base, "validators": {"nope": 1}}, {**base, "header": None},
                 {k: v for k, v in base.items() if k != "validators"}]
    packages = _both()
    for i, doc in enumerate(variants):
        home = str(tmp_path / f"v{i}")
        os.makedirs(os.path.join(home, "data"))
        with open(packages[0][1].anchor_path(home), "w") as f:
            json.dump(doc, f)
        got = [_loaded(p[1].load_anchor(home, CHAIN)) for p in packages]
        assert got[1] == got[0], (i, doc)
    assert _loaded(packages[1][1].load_anchor(str(tmp_path / "v0"), CHAIN)) is not None


def test_make_restorer_equal_to_jax(tmp_path):
    """Both packages' nodes, over one home holding a (JAX-written) anchor at
    42, boot their restore light client at the same height, validators and
    header for an operator pin below the anchor and above it."""
    from tendermint_tpu_torch.blockchain.store import BlockStore

    packages = _both()
    lc, _vset, _hdr = _anchor_doc(packages[0], 42, True, tag="later")
    assert packages[0][1].save_anchor(str(tmp_path), lc)
    for pin in (3, 50):
        seen = []
        for root, _la, _LC, _H, _B, Val, VSet, gen, Node in packages:
            genesis_vset = VSet([_validator(Val, gen, f"{CHAIN}-a-{i}") for i in range(3)])
            genesis_doc = SimpleNamespace(chain_id=CHAIN, validators=[
                SimpleNamespace(pub_key=v.pub_key, power=v.voting_power)
                for _, v in (genesis_vset.get_by_index(i) for i in range(genesis_vset.size()))])
            stub = SimpleNamespace(config=SimpleNamespace(base=SimpleNamespace(root_dir=str(tmp_path))),
                                   verifier=SimpleNamespace(commit_batch_verifier=lambda: None),
                                   block_store=BlockStore(MemDB()), hasher=None)
            sc = SimpleNamespace(trust_height=pin, rpc_servers="127.0.0.1:1")
            got = Node._make_restorer(stub, sc, object(), genesis_doc, MemDB()).light_client
            header = got.trusted_header()
            seen.append((got.height, got.validators.to_json(), header.to_json() if header is not None else None))
        assert seen[1] == seen[0], pin
        assert seen[0][0] == (42 if pin == 3 else 50)
