"""The module-level names of the JAX package that no caller reaches, in the
port: `types.vote.is_vote_type_valid` (and its export from `types`),
`types.block_id.ZERO_PSH` / `ZERO_BLOCK_ID`, `codec.binary.encode_uvarint`
/ `decode_bytes` with the fixed-width and uvarint `Encoder` / `Decoder`
methods, `codec.canonical.sign_bytes`, `crypto.hashing.sha512`, and the
`codec`, `crypto` and `merkle` package re-exports. Each name gives the
JAX package's result on the same seeded inputs, encodings decode across
the packages, and the refusals match."""

from __future__ import annotations

import hashlib
import importlib

import numpy as np
import pytest

SEED = 21
EDGES = [0, 1, 2**7 - 1, 2**7, 2**8 - 1, 2**8, 2**16 - 1, 2**16, 2**32 - 1, 2**32, 2**64 - 1]
WIDTHS = {"u16": 2**16 - 1, "u32": 2**32 - 1, "u64": 2**64 - 1}


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _both(fn):
    """fn(root) for the port and the JAX package."""
    return fn("tendermint_tpu_torch"), fn("tendermint_tpu")


def _outcome(call):
    """A call's value, or its exception's type name and message."""
    try:
        return ("ok", call())
    except Exception as exc:  # noqa: BLE001 — the refusal is the result
        return ("raised", type(exc).__name__, str(exc))


def _rng_ints(rng, n: int, bits: int) -> list[int]:
    return [int.from_bytes(rng.bytes(8), "big") >> (64 - bits) for _ in range(n)]


def case_encode_uvarint(root: str):
    b = _mod(root, "codec.binary")
    rng = np.random.default_rng(SEED)
    values = EDGES + _rng_ints(rng, 64, 64) + [2**200, -1, 2**(8 * 256)]
    return [_outcome(lambda v=v: b.encode_uvarint(v)) for v in values]


def case_decode_bytes(root: str):
    b = _mod(root, "codec.binary")
    rng = np.random.default_rng(SEED + 1)
    out = []
    for n in (0, 1, 127, 128, 300):
        payload = rng.bytes(n)
        prefix = rng.bytes(int(rng.integers(0, 5)))
        buf = prefix + b.encode_bytes(payload) + b"tail"
        out.append(_outcome(lambda buf=buf, off=len(prefix): b.decode_bytes(buf, off)))
        out.append(_outcome(lambda buf=buf, off=len(prefix): b.decode_bytes(buf[:-5], off)))  # truncated
    out.append(_outcome(lambda: b.decode_bytes(b"\x81\x01")))  # negative length
    return out


def case_fixed_width_and_uvarint_round_trip(root: str):
    b = _mod(root, "codec.binary")
    e = b.Encoder()
    values = {w: [v for v in EDGES if v <= top] for w, top in WIDTHS.items()}
    for w, vs in values.items():
        for v in vs:
            getattr(e, f"write_{w}")(v)
    for v in EDGES:
        e.write_uvarint(v)
    buf = e.buf()
    d = b.Decoder(buf)
    back = {w: [getattr(d, f"read_{w}")() for _ in vs] for w, vs in values.items()}
    back["uvarint"] = [d.read_uvarint() for _ in EDGES]
    over = [_outcome(lambda w=w, top=top: getattr(b.Encoder(), f"write_{w}")(top + 1).buf())
            for w, top in WIDTHS.items()]
    refusals = [_outcome(lambda raw=raw: b.Decoder(raw).read_uvarint())
                for raw in (b"\x02\x00\x01", b"\x03\x01", b"")]
    return buf, back, d.done(), over, refusals


def case_sign_bytes(root: str):
    c = _mod(root, "codec.canonical")
    bid = _mod(root, "types.block_id")
    vote_mod = _mod(root, "types.vote")
    prop_mod = _mod(root, "types.proposal")
    rng = np.random.default_rng(SEED + 2)
    block_id = bid.BlockID(rng.bytes(20), bid.PartSetHeader(3, rng.bytes(20)))
    out = []
    for t in (vote_mod.VOTE_TYPE_PREVOTE, vote_mod.VOTE_TYPE_PRECOMMIT):
        vote = vote_mod.Vote(validator_address=rng.bytes(20), validator_index=7, height=12, round_=1,
                             type_=t, block_id=block_id)
        sb = c.sign_bytes("names-chain", "vote", vote.canonical())
        assert sb == vote.sign_bytes("names-chain")
        out.append(sb)
    prop = prop_mod.Proposal(height=12, round_=2, block_parts_header=bid.PartSetHeader(5, rng.bytes(20)),
                             pol_round=1, pol_block_id=block_id)
    sb = c.sign_bytes("names-chain", "proposal", prop.canonical())
    assert sb == prop.sign_bytes("names-chain")
    out.append(sb)
    out.append(c.sign_bytes("", "heartbeat", {"height": 0, "bytes": b"\x00\xff"}))
    out.append(_outcome(lambda: c.sign_bytes("x", "vote", {"float": 1.5})))
    return out


def case_sha512(root: str):
    h = _mod(root, "crypto.hashing")
    rng = np.random.default_rng(SEED + 3)
    msgs = [b"", b"abc"] + [rng.bytes(n) for n in (1, 111, 112, 127, 128, 129, 1000)]
    got = [h.sha512(m) for m in msgs]
    assert got == [hashlib.sha512(m).digest() for m in msgs]
    return got


def case_is_vote_type_valid(root: str):
    vote_mod = _mod(root, "types.vote")
    types_pkg = _mod(root, "types")
    assert types_pkg.is_vote_type_valid is vote_mod.is_vote_type_valid
    return [t for t in range(256) if vote_mod.is_vote_type_valid(t)]


def case_zero_block_ids(root: str):
    bid = _mod(root, "types.block_id")
    b = _mod(root, "codec.binary")
    out = []
    for zero in (bid.ZERO_PSH, bid.ZERO_BLOCK_ID):
        e = b.Encoder()
        zero.encode(e)
        out.append((e.buf(), zero.to_json(), zero.is_zero(), zero.canonical()))
    out.append(bid.ZERO_BLOCK_ID.key())
    assert bid.ZERO_BLOCK_ID == bid.BlockID() and bid.ZERO_PSH == bid.PartSetHeader()
    return out


def case_package_reexports(root: str):
    codec, crypto, merkle = (_mod(root, n) for n in ("codec", "crypto", "merkle"))
    rng = np.random.default_rng(SEED + 4)
    items = [rng.bytes(int(n)) for n in rng.integers(0, 200, size=9)]
    e = codec.Encoder().write_uvarint(300).write_bytes(b"xy")
    root_hash, proofs = merkle.simple_proofs_from_byteslices(items)
    priv = crypto.PrivKeyEd25519(bytes(range(32)))
    sig = priv.sign(b"names")
    return {
        "codec": (e.buf(), codec.Decoder(e.buf()).read_uvarint(), codec.decode_bytes(codec.encode_bytes(b"q")),
                  codec.encode_string("é"), codec.encode_varint(-5), codec.encode_uvarint(5),
                  codec.canonical_dumps({"b": b"\x01", "a": [1]})),
        "crypto": ([crypto.sha256(i) for i in items], [crypto.ripemd160(i) for i in items],
                   priv.pub_key().raw, sig.raw, crypto.PubKeyEd25519(priv.pub_key().raw).verify_bytes(b"names", sig),
                   isinstance(sig, crypto.SignatureEd25519), len(crypto.gen_priv_key_ed25519().pub_key().raw)),
        "merkle": (merkle.simple_hash_from_byteslices(items),
                   merkle.simple_hash_from_hashes([merkle.leaf_hash(i) for i in items]),
                   merkle.simple_hash_from_map({"k": b"v", "a": b"b"}), merkle.inner_hash(b"l", b"r"),
                   root_hash, [p.aunts for p in proofs],
                   [p.verify(i, len(items), it, root_hash) for i, (p, it) in enumerate(zip(proofs, items))],
                   isinstance(proofs[0], merkle.SimpleProof),
                   merkle.simple_proofs_from_hashes([merkle.leaf_hash(i) for i in items])[0]),
    }


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_name_equals_the_jax_packages(name):
    port, jax = _both(CASES[name])
    assert port == jax


def test_uvarint_and_fixed_width_decode_across_packages():
    """Bytes one package's Encoder writes, the other's Decoder reads back."""
    values = list(EDGES)
    for w_root, r_root in (("tendermint_tpu_torch", "tendermint_tpu"), ("tendermint_tpu", "tendermint_tpu_torch")):
        wb, rb = _mod(w_root, "codec.binary"), _mod(r_root, "codec.binary")
        e = wb.Encoder()
        for v in values:
            e.write_uvarint(v).write_u64(v)
        d = rb.Decoder(e.buf())
        assert [(d.read_uvarint(), d.read_u64()) for _ in values] == [(v, v) for v in values]
        assert d.done()


@pytest.mark.parametrize("pkg", ["codec", "crypto", "merkle"])
def test_package_exports_cover_the_jax_packages(pkg):
    """dir() of the port's package holds every name the JAX package's
    __init__ exports, and its __all__ lists the same names."""
    port, jax = _mod("tendermint_tpu_torch", pkg), _mod("tendermint_tpu", pkg)
    assert set(jax.__all__) <= set(dir(port))
    assert sorted(port.__all__) == sorted(jax.__all__)
