"""Ed25519 half-aggregation — the aggregated-signature design point of
"Performance of EdDSA and BLS Signatures in Committee-Based Consensus"
(arXiv 2302.00418) without leaving the chain's existing key type.

n Ed25519 signatures (R_i, s_i) over (A_i, m_i) collapse into
(R_1..R_n, s_agg): the R points must travel (they bind each signer's
nonce), but the n scalars fold into ONE via a Fiat-Shamir random linear
combination — HALF the signature bytes, verified in a single multi-term
equation:

    s_agg = sum_i z_i * s_i  (mod L)
    accept iff  [s_agg]B == sum_i [z_i]R_i + [z_i * h_i]A_i

with h_i = SHA512(R_i || A_i || m_i) mod L (the standard Ed25519
challenge — verifying lanes exactly as RFC 8032 would) and coefficients
z_i = SHA512(DOM || T || LE64(i)) mod L bound to the FULL transcript
T = SHA512(DOM, all R_i, A_i, SHA512(m_i)). Because every z_i depends on
every lane, no subset of signers can cancel another's forged lane: a
single invalid (R_i, s_i) makes the aggregate fail with overwhelming
probability (the standard random-linear-combination soundness argument).

Aggregation itself is untrusted bookkeeping — pure scalar arithmetic, no
secret keys — so any relay can shrink a commit it gossips; verification
is the sole authority.

Prototype caveats (docs/committee.md): pure-python group math off
crypto/ed25519 (verification touches only public data, so variable-time
is acceptable; DO NOT sign here), and no effort to reject mixed-key
lanes beyond shape checks — the caller (types/agg_commit.py) filters to
ed25519 lanes.
"""

from __future__ import annotations

import hashlib

from tendermint_tpu_torch.crypto.ed25519 import (
    B,
    IDENT,
    L,
    P,
    point_add,
    point_decompress,
    point_equal,
    scalar_mult,
)

_DOM = b"tendermint-tpu/ed25519-halfagg/v1"


def _challenge(big_r: bytes, pub: bytes, msg: bytes) -> int:
    """The per-lane RFC 8032 challenge h_i = H(R || A || M) mod L."""
    return int.from_bytes(
        hashlib.sha512(big_r + pub + msg).digest(), "little"
    ) % L


def _coefficients(pubs: list[bytes], msgs: list[bytes],
                  rs: list[bytes]) -> list[int]:
    """Fiat-Shamir lane coefficients over the full transcript. z_i != 0
    by construction (0 would let lane i escape the equation)."""
    t = hashlib.sha512(_DOM)
    for big_r, pub, msg in zip(rs, pubs, msgs):
        t.update(big_r)
        t.update(pub)
        t.update(hashlib.sha512(msg).digest())
    transcript = t.digest()
    out = []
    for i in range(len(rs)):
        z = int.from_bytes(
            hashlib.sha512(
                _DOM + transcript + i.to_bytes(8, "little")
            ).digest(),
            "little",
        ) % L
        out.append(z or 1)
    return out


def aggregate(items: list[tuple[bytes, bytes, bytes]]) -> tuple[list[bytes], bytes]:
    """Collapse [(pub32, msg, sig64)] into (R list, 32-byte s_agg).
    Raises ValueError on malformed lane shapes (aggregation never proves
    anything — a lane carrying an INVALID signature aggregates fine and
    fails at verify_aggregate)."""
    if not items:
        raise ValueError("nothing to aggregate")
    pubs, msgs, rs, ss = [], [], [], []
    for pub, msg, sig in items:
        if len(pub) != 32 or len(sig) != 64:
            raise ValueError("half-aggregation needs 32B ed25519 keys / 64B sigs")
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            raise ValueError("non-canonical signature scalar")
        pubs.append(bytes(pub))
        msgs.append(bytes(msg))
        rs.append(bytes(sig[:32]))
        ss.append(s)
    zs = _coefficients(pubs, msgs, rs)
    s_agg = sum(z * s for z, s in zip(zs, ss)) % L
    return rs, int.to_bytes(s_agg, 32, "little")


def verify_aggregate(pubs: list[bytes], msgs: list[bytes], rs: list[bytes],
                     s_agg: bytes) -> bool:
    """True iff (rs, s_agg) is a valid half-aggregate of one Ed25519
    signature per (pub, msg) lane. Any tampered lane — R, key, message,
    or the folded scalar — fails the whole equation."""
    if not pubs or not (len(pubs) == len(msgs) == len(rs)):
        return False
    if len(s_agg) != 32:
        return False
    s = int.from_bytes(s_agg, "little")
    if s >= L:
        return False
    zs = _coefficients(pubs, msgs, rs)
    acc = IDENT
    for z, big_r, pub, msg in zip(zs, rs, pubs, msgs):
        r_pt = point_decompress(big_r)
        a_pt = point_decompress(pub)
        if r_pt is None or a_pt is None:
            return False
        h = _challenge(big_r, pub, msg)
        acc = point_add(acc, scalar_mult(z, r_pt))
        acc = point_add(acc, scalar_mult(z * h % L, a_pt))
    return point_equal(scalar_mult(s, B), acc)


# -- device-plane decomposition (ops/gateway.Verifier.verify_aggregate) ----
#
# The equation above is n+1 scalar multiplications — the ~4.5 ms/lane
# host cost the gateway batches away. Each lane decomposes into ONE
# dual-scalar-mul term [a]P + [b]Q (ops/ed25519.dsm_batch computes all
# lanes in one device dispatch):
#
#     lane i < n:  [z_i]R_i + [(z_i * h_i) mod L]A_i
#     lane n:      [s_agg]B + [0]IDENT            (the left-hand side)
#
# The host keeps only the cheap parts: SHA-512 transcripts, point
# decompression (cached per validator in ops/ed25519), and the final
# n-term point sum + equality.

_B_AFFINE = (B[0] * pow(B[2], P - 2, P) % P, B[1] * pow(B[2], P - 2, P) % P)
_IDENT_AFFINE = (0, 1)


def aggregate_terms(pubs: list[bytes], msgs: list[bytes], rs: list[bytes],
                    s_agg: bytes):
    """Decompose the half-aggregate check into n+1 dual-scalar-mul terms
    [(a, P_affine, b, Q_affine)] for ops/ed25519.dsm_batch; None when
    the aggregate is structurally invalid (same refusals as
    verify_aggregate's early returns)."""
    if not pubs or not (len(pubs) == len(msgs) == len(rs)):
        return None
    if len(s_agg) != 32:
        return None
    s = int.from_bytes(s_agg, "little")
    if s >= L:
        return None
    zs = _coefficients(pubs, msgs, rs)
    terms = []
    for z, big_r, pub, msg in zip(zs, rs, pubs, msgs):
        r_pt = point_decompress(big_r)
        a_pt = point_decompress(pub)
        if r_pt is None or a_pt is None:
            return None
        r_aff = (r_pt[0] * pow(r_pt[2], P - 2, P) % P,
                 r_pt[1] * pow(r_pt[2], P - 2, P) % P)
        a_aff = (a_pt[0] * pow(a_pt[2], P - 2, P) % P,
                 a_pt[1] * pow(a_pt[2], P - 2, P) % P)
        h = _challenge(big_r, pub, msg)
        terms.append((z, r_aff, z * h % L, a_aff))
    terms.append((s, _B_AFFINE, 0, _IDENT_AFFINE))
    return terms


def finish_from_points(points: list[tuple[int, int]]) -> bool:
    """Complete the aggregate check from dsm_batch's per-lane affine
    results (terms order from aggregate_terms): True iff the sum of
    lanes 0..n-1 equals lane n ([s_agg]B)."""
    if len(points) < 2:
        return False
    acc = IDENT
    for x, y in points[:-1]:
        acc = point_add(acc, (x, y, 1, x * y % P))
    lx, ly = points[-1]
    return point_equal(acc, (lx, ly, 1, lx * ly % P))
