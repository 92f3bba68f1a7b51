"""The port's secp256k1 keys against the JAX package's, on the same
numpy-seeded secrets and messages: signatures byte for byte, verdicts
both ways, the DER and low-s refusals, the JSON and tagged-byte forms,
and mixed ed25519/secp256k1 batches and commits through the port's
gateway (tests/test_crypto.py:351-418 rerun through the port)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.crypto import secp256k1 as jsecp
from tendermint_tpu_torch.crypto import keys as tkeys
from tendermint_tpu_torch.crypto import secp256k1 as tsecp
from tendermint_tpu_torch.ops.gateway import Verifier

RNG_SEED = 20261016


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain verify kernel is bound by torch's per-op overhead, which
    intra-op threads only add to at these widths."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _secrets_and_messages(n=6):
    rng = np.random.default_rng(RNG_SEED)
    secrets = [tsecp.secret_from_seed(rng.bytes(32)) for _ in range(n)]
    msgs = [rng.bytes(int(rng.integers(0, 200))) for _ in range(n)]
    return secrets, msgs


def test_keys_and_signatures_equal_jax_byte_for_byte():
    secrets, msgs = _secrets_and_messages()
    for secret, msg in zip(secrets, msgs):
        assert tsecp.public_key(secret) == jsecp.public_key_py(secret)
        sig = tsecp.sign(secret, msg)
        assert sig == jsecp.sign_py(secret, msg)
        r, s = tsecp.decode_der(sig)
        assert s <= tsecp._N // 2 and (r, s) == jsecp.decode_der(sig)
    assert tsecp.secret_from_seed(b"seed") == jsecp.secret_from_seed(b"seed")
    assert 1 <= int.from_bytes(tsecp.gen_secret(), "big") < tsecp._N


def test_cross_verification_both_directions():
    secrets, msgs = _secrets_and_messages()
    for secret, msg in zip(secrets, msgs):
        pub = tsecp.public_key(secret)
        assert tsecp.verify(pub, msg, jsecp.sign(secret, msg))  # JAX's signer, any backend
        assert jsecp.verify(pub, msg, tsecp.sign(secret, msg))
        assert jsecp.verify_py(pub, msg, tsecp.sign(secret, msg))


def _refusal_cases():
    secrets, msgs = _secrets_and_messages(3)
    pub = tsecp.public_key(secrets[0])
    msg = msgs[0]
    sig = tsecp.sign(secrets[0], msg)
    r, s = tsecp.decode_der(sig)
    flipped = bytearray(sig)
    flipped[-1] ^= 1
    bad_prefix = bytes([0x04]) + pub[1:]
    return {
        "valid": (pub, msg, sig),
        "high_s": (pub, msg, tsecp.encode_der(r, tsecp._N - s)),
        "tampered_sig": (pub, msg, bytes(flipped)),
        "tampered_msg": (pub, msg + b"!", sig),
        "wrong_key": (tsecp.public_key(secrets[1]), msg, sig),
        "r_zero": (pub, msg, tsecp.encode_der(0, s)),
        "s_zero": (pub, msg, tsecp.encode_der(r, 0)),
        "r_is_n": (pub, msg, tsecp.encode_der(tsecp._N, s)),
        "key_prefix": (bad_prefix, msg, sig),
        "key_x_is_5": (b"\x02" + (5).to_bytes(32, "big"), msg, sig),
        "key_x_ge_p": (b"\x02" + tsecp._P.to_bytes(32, "big"), msg, sig),
        "short_key": (pub[:32], msg, sig),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_refusals_equal_jax(case):
    pub, msg, sig = _refusal_cases()[case]
    got = tsecp.verify(pub, msg, sig)
    assert got == jsecp.verify_py(pub, msg, sig)
    assert got == (case == "valid")
    assert tkeys.verify_any(pub, msg, sig) == jkeys.verify_any(pub, msg, sig)


def _der_cases():
    good = tsecp.encode_der(0x7F, 0x80)  # the second integer needs a pad byte
    return {
        "minimal": good,
        "empty": b"",
        "not_a_sequence": b"\x31" + good[1:],
        "long_form_length": b"\x30\x81" + good[1:],
        "length_too_long": b"\x30" + bytes([good[1] + 1]) + good[2:],
        "trailing_byte": good[:1] + bytes([good[1] + 1]) + good[2:] + b"\x00",
        "negative_r": bytes.fromhex("3008020181020200ff"),
        "padded_r": bytes.fromhex("300902020001020200ff"),
        "zero_length_int": bytes.fromhex("30070200020300ff01"),
        "second_not_int": bytes.fromhex("3008020101030300ff01"),
        "int_overruns": bytes.fromhex("3008020101020400ff01"),
        "short": bytes.fromhex("3006020101020101"),
    }


@pytest.mark.parametrize("case", sorted(_der_cases()))
def test_der_decoding_equals_jax(case):
    der = _der_cases()[case]

    def outcome(mod):
        try:
            return mod.decode_der(der)
        except ValueError as exc:
            return f"ValueError: {exc}"

    got = outcome(tsecp)
    assert got == outcome(jsecp)
    assert isinstance(got, tuple) == (case in ("minimal", "short"))
    for r, s in ((1, 1), (0x80, 0xFF), (tsecp._N - 1, tsecp._N // 2), (0, 0)):
        assert tsecp.encode_der(r, s) == jsecp.encode_der(r, s)
        assert tsecp.decode_der(tsecp.encode_der(r, s)) == (r, s)


def test_json_and_byte_forms_round_trip_across():
    for seed in (b"json", b"other"):
        jpriv = jkeys.gen_priv_key_secp256k1(seed)
        tpriv = tkeys.priv_key_from_json(jpriv.to_json())
        assert tpriv == tkeys.gen_priv_key_secp256k1(seed)
        assert tpriv.to_json() == jpriv.to_json()
        tpub, jpub = tpriv.pub_key(), jpriv.pub_key()
        assert tpub.to_json() == jpub.to_json() and tpub.bytes_() == jpub.bytes_()
        assert tpub.address() == jpub.address()
        assert tkeys.pub_key_from_json(jpub.to_json()) == tpub
        assert tkeys.pub_key_from_bytes(jpub.bytes_()) == tpub
        sig = tpriv.sign(b"x")
        assert sig.raw == jsecp.sign_py(jpriv.raw, b"x")
        # the JAX signer may take OpenSSL's random nonce: other bytes, same verdict
        jsig = tkeys.signature_from_json(jpriv.sign(b"x").to_json())
        assert isinstance(jsig, tkeys.SignatureSecp256k1) and tpub.verify_bytes(b"x", jsig)
        assert tpub.verify_bytes(b"x", sig) and not tpub.verify_bytes(b"y", sig)
        assert not tpub.verify_bytes(b"x", tkeys.SignatureEd25519(b"\x00" * 64))
    jed = jkeys.gen_priv_key_ed25519(b"ed")
    ted_ = tkeys.priv_key_from_json(jed.to_json())
    assert ted_ == tkeys.gen_priv_key_ed25519(b"ed")
    assert ted_.pub_key().address() == jed.pub_key().address()
    assert ted_.sign(b"m").raw == jed.sign(b"m").raw
    assert tkeys.pub_key_from_bytes(jed.pub_key().bytes_()).raw == jed.pub_key().raw
    for bad in (b"", b"\x03" + b"\x00" * 32, b"\x01" + b"\x00" * 31):
        with pytest.raises(ValueError):
            tkeys.pub_key_from_bytes(bad)
        with pytest.raises(ValueError):
            jkeys.pub_key_from_bytes(bad)
    with pytest.raises(ValueError, match="unknown"):
        tkeys.signature_from_json([3, "00"])


def mixed_batch():
    """tests/test_crypto.py::test_gateway_mixed_batch's items and verdicts:
    6 ed25519 lanes (one tampered) and 3 secp256k1 lanes (one signed over
    another message), interleaved."""
    eds = [jkeys.gen_priv_key_ed25519(b"me%d" % i) for i in range(6)]
    secs = [jkeys.gen_priv_key_secp256k1(b"ms%d" % i) for i in range(3)]
    items, want = [], []
    for i, k in enumerate(eds):
        msg = b"edmsg%d" % i
        sig = k.sign(msg).raw
        if i == 2:
            sig = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
        items.append((k.pub_key().raw, msg, sig))
        want.append(i != 2)
    for i, k in enumerate(secs):
        if i == 1:
            items.append((k.pub_key().raw, b"smsg1", k.sign(b"tampered").raw))
        else:
            items.append((k.pub_key().raw, b"smsg%d" % i, k.sign(b"smsg%d" % i).raw))
        want.append(i != 1)
    order = [0, 6, 1, 7, 2, 8, 3, 4, 5]
    return [items[i] for i in order], [want[i] for i in order]


def test_gateway_mixed_batch_equal_to_jax():
    from tendermint_tpu.ops.gateway import Verifier as JaxVerifier

    mixed, expect = mixed_batch()
    v = Verifier(min_tpu_batch=1, device="cpu")
    assert v.verify_batch(mixed) == expect
    assert JaxVerifier(use_tpu=False).verify_batch(mixed) == expect
    st = v.stats()
    assert st["tpu_batches"] == 1 and st["tpu_sigs"] == 6 and st["cpu_sigs"] == 3


def test_secp_validator_in_commit_equal_to_jax():
    """A mixed ed25519/secp256k1 validator set: the same votes into the
    JAX and the port VoteSet give byte-equal commits, which both verify,
    the port's through its gateway with the secp256k1 lane on the CPU."""
    from tendermint_tpu.ops.gateway import Verifier as JaxVerifier
    from tendermint_tpu.types import BlockID as JBlockID
    from tendermint_tpu.types import ValidatorSet as JValidatorSet
    from tendermint_tpu.types import Validator as JValidator
    from tendermint_tpu.types import Vote as JVote
    from tendermint_tpu.types.block_id import PartSetHeader as JPSH
    from tendermint_tpu.types.vote import VOTE_TYPE_PRECOMMIT
    from tendermint_tpu.types.vote_set import VoteSet as JVoteSet
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet
    from tendermint_tpu_torch.types.vote import Vote
    from tendermint_tpu_torch.types.vote_set import VoteSet

    jprivs = [jkeys.gen_priv_key_ed25519(b"mixed%d" % i) for i in range(3)] + [
        jkeys.gen_priv_key_secp256k1(b"mixed3")
    ]
    tprivs = [tkeys.priv_key_from_json(p.to_json()) for p in jprivs]
    jvs = JValidatorSet([JValidator.new(p.pub_key(), 1) for p in jprivs])
    tvs = ValidatorSet([Validator.new(p.pub_key(), 1) for p in tprivs])
    assert tvs.hash() == jvs.hash() and tvs.to_json() == jvs.to_json()
    by_addr = {p.pub_key().address(): p for p in tprivs}
    jbid = JBlockID(b"\x42" * 20, JPSH(1, b"\x43" * 20))
    tbid = BlockID.from_json(jbid.to_json())
    jset = JVoteSet("test-chain", 5, 0, VOTE_TYPE_PRECOMMIT, jvs)
    tset = VoteSet("test-chain", 5, 0, VOTE_TYPE_PRECOMMIT, tvs)
    for i, val in enumerate(tvs.validators):
        vote = Vote(val.address, i, 5, 0, VOTE_TYPE_PRECOMMIT, tbid)
        signed = vote.with_signature(by_addr[val.address].sign(vote.sign_bytes("test-chain")))
        assert tset.add_vote(signed) is True
        assert jset.add_vote(JVote.from_bytes(signed.to_bytes())) is True
    tcommit, jcommit = tset.make_commit(), jset.make_commit()
    assert tcommit.to_bytes() == jcommit.to_bytes() and tcommit.hash() == jcommit.hash()
    jvs.verify_commit("test-chain", jbid, 5, jcommit,
                      batch_verifier=JaxVerifier(use_tpu=False).commit_batch_verifier())
    v = Verifier(min_tpu_batch=1, device="cpu")
    tvs.verify_commit("test-chain", tbid, 5, tcommit, batch_verifier=v.commit_batch_verifier())
    assert v.stats()["cpu_sigs"] == 1 and v.stats()["tpu_sigs"] == 3
