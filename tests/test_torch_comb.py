"""The port's comb verify path (`ops.ed25519_comb`, registry name `comb`)
against the JAX package's (`tendermint_tpu/ops/ed25519_comb.py`), on the
CPU.

Every case of tests/test_ops_comb.py runs here through both packages on
the same items (made from a numpy seed) and the same call sequence: the
verdicts, the lane routing (which lanes ride comb and which the ladder),
`pool.stats` and `pool.capacity` must be equal. Beyond those: `b_table()`,
the table build (`build_tables_plain` against JAX's `_build_jit`, byte for
byte, a small-order key among them), the verify (`verify_comb_plain` on a
pool loaded from JAX's built pool against JAX's `_verify_jit`), a batch
resolved after a later batch evicted and rebuilt one of its slots, the
wrappers' argument checks, and a kernel failure that raises instead of
falling back. Every comparison is exact equality.

The `cuda` cases hold both comb kernels against their plain versions on
the card and repeat the eviction case there; on a machine with a card and
no JAX they run alone:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_comb.py -m cuda`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519_comb as tcomb
from tendermint_tpu_torch.ops import ed25519_f32p as tf32p


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the plain versions are bound by torch's per-op overhead, which
    # intra-op threads only add to
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jcomb():
    from tendermint_tpu.ops import ed25519_comb

    return ed25519_comb


@pytest.fixture(autouse=True)
def _fresh_pools(monkeypatch):
    # tests/test_ops_comb.py's fixture: tables on first sight, fresh pools
    monkeypatch.setenv("TENDERMINT_TPU_COMB_MIN_SIGHT", "1")
    tcomb.reset_default_pool()
    _reset_jax_pool()
    yield
    tcomb.reset_default_pool()
    _reset_jax_pool()


def _reset_jax_pool():
    import sys

    mod = sys.modules.get("tendermint_tpu.ops.ed25519_comb")
    if mod is not None:
        mod.reset_default_pool()


@pytest.fixture
def routes(monkeypatch, jcomb):
    """Per package, each call's lane routing: ("comb", lane indices) per
    comb dispatch and ("ladder", lane count) per ladder dispatch."""
    seen = {"jax": [], "port": []}

    def spy(module, name, tag, record):
        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            seen[tag].append(record(*args))
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(jcomb, "_dispatch_comb", "jax", lambda items, kidx, *rest: ("comb", list(kidx)))
    spy(tcomb, "_dispatch_comb", "port", lambda items, kidx, *rest: ("comb", list(kidx)))
    spy(jcomb.base, "verify_batch_async", "jax", lambda items, *rest: ("ladder", len(items)))
    spy(tcomb.f32p, "verify_batch_async", "port", lambda items, *rest: ("ladder", len(items)))
    return seen


def _keypair(rng):
    sk = rng.bytes(32)
    return sk, ted.public_key(sk)


def _signed(rng, sk, pk, n=1, msg_len=40):
    out = []
    for _ in range(n):
        m = rng.bytes(msg_len)
        out.append((pk, m, ted.sign(sk, m)))
    return out


def _both(jcomb, items) -> list[bool]:
    """Both packages' comb verdicts on the same items, which must agree."""
    got = [bool(b) for b in tcomb.verify_batch(items, "cpu")]
    assert got == [bool(b) for b in jcomb.verify_batch(items)]
    return got


def _same_pools(jcomb):
    jp, tp = jcomb.default_pool(), tcomb.default_pool("cpu")
    assert tp.stats == jp.stats
    assert tp.capacity == jp.capacity
    assert dict(tp._lru) == dict(jp._lru)
    return tp


# -- tests/test_ops_comb.py TestVerifyParity ----------------------------------


def test_rfc8032_vectors(jcomb):
    vecs = [
        ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60", b""),
        ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb", bytes([0x72])),
        ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7", bytes([0xAF, 0x82])),
    ]
    items = []
    for sk_hex, msg in vecs:
        sk = bytes.fromhex(sk_hex)
        items.append((ted.public_key(sk), msg, ted.sign(sk, msg)))
    assert _both(jcomb, items) == [True, True, True]
    _same_pools(jcomb)


def _mixed_items():
    rng = np.random.default_rng(11)
    pairs = [_keypair(rng) for _ in range(4)]
    items = []
    for i in range(24):
        sk, pk = pairs[i % 4]
        m = rng.bytes(32 + i)
        sig = ted.sign(sk, m)
        if i % 6 == 1:  # tamper sig
            b = bytearray(sig)
            b[10] ^= 0x40
            sig = bytes(b)
        elif i % 6 == 2:  # tamper msg
            m = m[:-1] + bytes([m[-1] ^ 1])
        elif i % 6 == 3:  # wrong pubkey
            pk = pairs[(i + 1) % 4][1]
        elif i % 6 == 4:  # non-canonical s (s + L)
            s_int = int.from_bytes(sig[32:], "little") + ted.L
            sig = sig[:32] + s_int.to_bytes(32, "little")
        items.append((pk, m, sig))
    items.append((b"\x00" * 31, b"m", b"\x00" * 64))  # bad pub length
    items.append((pairs[0][1], b"m", b"\x00" * 63))  # bad sig length
    return items


def test_parity_with_cpu_reference_mixed_batch(jcomb, routes):
    """Valid, tampered sig/msg/pub, non-canonical s and bad-length rows:
    lane for lane crypto.ed25519.verify, the JAX kernel's verdicts and its
    routing (the two bad-length lanes on the ladder)."""
    items = _mixed_items()
    assert _both(jcomb, items) == [ted.verify(*it) for it in items]
    assert routes["port"] == routes["jax"] == [("comb", list(range(24))), ("ladder", 2)]
    _same_pools(jcomb)


def test_empty_and_single(jcomb):
    rng = np.random.default_rng(3)
    sk, pk = _keypair(rng)
    assert _both(jcomb, []) == []
    (it,) = _signed(rng, sk, pk)
    assert _both(jcomb, [it]) == [True]


def test_agrees_with_the_ladder(jcomb):
    from tendermint_tpu_torch.ops import ed25519_f32 as tf32

    rng = np.random.default_rng(7)
    pairs = [_keypair(rng) for _ in range(3)]
    items = []
    for i in range(12):
        sk, pk = pairs[i % 3]
        m = rng.bytes(20)
        sig = ted.sign(sk, m)
        if i % 4 == 3:
            sig = sig[:63] + bytes([sig[63] ^ 2])
        items.append((pk, m, sig))
    got = _both(jcomb, items)
    assert got == list(tf32.verify_batch(items, "cpu")) == list(tf32p.verify_batch(items, "cpu"))
    assert got == [i % 4 != 3 for i in range(12)]


# -- tests/test_ops_comb.py TestPool --------------------------------------------


def test_slot_reuse_across_batches(jcomb, routes):
    rng = np.random.default_rng(5)
    sk, pk = _keypair(rng)
    assert _both(jcomb, _signed(rng, sk, pk, 3)) == [True] * 3
    assert _same_pools(jcomb).stats["build_keys"] == 1
    assert _both(jcomb, _signed(rng, sk, pk, 3)) == [True] * 3
    assert _same_pools(jcomb).stats["build_keys"] == 1  # no rebuild on reuse
    assert routes["port"] == routes["jax"] == [("comb", [0, 1, 2])] * 2


def test_growth_and_eviction(jcomb):
    tcomb.set_default_pool(tcomb.CombPool(capacity=2, max_capacity=4, device="cpu"))
    jcomb.set_default_pool(jcomb.CombPool(capacity=2, max_capacity=4))
    rng = np.random.default_rng(9)
    pairs = [_keypair(rng) for _ in range(5)]
    pool = _same_pools(jcomb)
    assert pool.capacity == 2  # starts small
    for sk, pk in pairs[:3]:
        assert _both(jcomb, _signed(rng, sk, pk)) == [True]
    pool = _same_pools(jcomb)
    assert pool.capacity == pool.cap == 4  # grew (slot 0 reserved)
    assert pool.stats["grows"] == 1
    # 2 more distinct keys -> evictions, results still correct
    for sk, pk in pairs[3:]:
        assert _both(jcomb, _signed(rng, sk, pk)) == [True]
    assert _same_pools(jcomb).stats["evictions"] >= 1
    # the evicted first key still verifies correctly after re-lease
    sk, pk = pairs[0]
    assert _both(jcomb, _signed(rng, sk, pk)) == [True]
    assert _same_pools(jcomb).stats == {"builds": 6, "build_keys": 6, "evictions": 3, "grows": 1}


def test_second_sight_policy(jcomb, routes, monkeypatch):
    """A key's table is built only on its second batch appearance: first
    sight rides the ladder, the second builds, later ones reuse it."""
    monkeypatch.setenv("TENDERMINT_TPU_COMB_MIN_SIGHT", "2")
    tcomb.reset_default_pool()
    jcomb.reset_default_pool()
    rng = np.random.default_rng(21)
    sk, pk = _keypair(rng)
    assert _both(jcomb, _signed(rng, sk, pk)) == [True]
    assert _same_pools(jcomb).stats["build_keys"] == 0  # first sight: ladder
    assert _both(jcomb, _signed(rng, sk, pk)) == [True]
    assert _same_pools(jcomb).stats["build_keys"] == 1  # second sight: built
    assert _both(jcomb, _signed(rng, sk, pk)) == [True]
    assert _same_pools(jcomb).stats["build_keys"] == 1  # reused thereafter
    assert routes["port"] == routes["jax"] == [("ladder", 1), ("comb", [0]), ("comb", [0])]


def test_pool_exhausted_falls_back_to_ladder(jcomb, routes, monkeypatch):
    monkeypatch.setenv("TENDERMINT_TPU_COMB_CAP", "2")
    tcomb.reset_default_pool()
    jcomb.reset_default_pool()
    rng = np.random.default_rng(13)
    pairs = [_keypair(rng) for _ in range(3)]
    items = []
    for sk, pk in pairs:  # 3 distinct keys > 1 usable slot (cap=2)
        items.extend(_signed(rng, sk, pk))
    assert _both(jcomb, items) == [True, True, True]  # must not raise
    assert routes["port"] == routes["jax"] == [("comb", [0, 1, 2]), ("ladder", 3)]
    # the aborted lease was rolled back: a follow-up batch with one of
    # those keys must not ride a never-built slot table
    for sk, pk in pairs:
        assert _both(jcomb, _signed(rng, sk, pk)) == [True]
    _same_pools(jcomb)


def test_eviction_never_steals_from_current_batch(jcomb, monkeypatch):
    monkeypatch.setenv("TENDERMINT_TPU_COMB_CAP", "4")
    tcomb.reset_default_pool()
    jcomb.reset_default_pool()
    rng = np.random.default_rng(17)
    pairs = [_keypair(rng) for _ in range(4)]
    items = []
    for sk, pk in pairs[:3]:
        items.extend(_signed(rng, sk, pk, 2))
    assert all(_both(jcomb, items))
    items2 = []
    for sk, pk in pairs[1:]:  # keys 1,2 pinned + new key 3
        items2.extend(_signed(rng, sk, pk, 2))
    assert all(_both(jcomb, items2))
    assert _same_pools(jcomb).stats["evictions"] == 1


# -- tests/test_ops_comb.py TestBTable, and the table's bytes -------------------


def test_b_table_equal_to_jax(jcomb):
    assert np.array_equal(tcomb.b_table(), jcomb.b_table())
    assert tcomb.b_table().dtype == jcomb.b_table().dtype


def test_b_table_first_window_matches_reference():
    tab = tcomb.b_table()
    # entry [0][1] is 1*B: niels rows of the base point
    assert np.array_equal(tab[0, 1], tcomb._niels_rows_np(ted.B[0], ted.B[1]))
    # entry [p][0] is the identity in niels form
    ident = np.zeros(96, dtype=np.float32)
    ident[0] = 1.0
    ident[32] = 1.0
    assert np.array_equal(tab[5, 0], ident)


def test_b_table_window_weights():
    tab = tcomb.b_table()
    acc = ted.B  # entry [1][1] must be 16*B
    for _ in range(4):
        acc = ted.point_double(acc)
    x, y = tcomb.base._affine(acc)
    assert np.array_equal(tab[1, 1], tcomb._niels_rows_np(x, y))


def _neg_keys(pubs):
    """(32, n) f32 canonical limbs of Q = -A for each key, as CombPool.ensure
    forms them."""
    qx = np.zeros((32, len(pubs)), dtype=np.float32)
    qy = np.zeros((32, len(pubs)), dtype=np.float32)
    for j, pub in enumerate(pubs):
        pt = ted.point_decompress(pub)
        x, y = tcomb.base._affine(pt)
        qx[:, j] = np.frombuffer(tcomb._neg_x_bytes(x.to_bytes(32, "little")), dtype=np.uint8)
        qy[:, j] = np.frombuffer(y.to_bytes(32, "little"), dtype=np.uint8)
    return qx, qy


def test_build_tables_plain_equal_to_jax_build(jcomb):
    """Four keys, the last the small-order identity (y = 1), whose
    multiples are all the identity: every row byte for byte JAX's."""
    pubs = [ted.public_key(bytes([i + 1]) * 32) for i in range(3)] + [(1).to_bytes(32, "little")]
    qx, qy = _neg_keys(pubs)
    want = np.asarray(jcomb._build_jit(qx, qy))
    got = tcomb.build_tables_plain(torch.from_numpy(qx), torch.from_numpy(qy)).numpy()
    assert got.shape == want.shape == (4, 1024, 96)
    assert np.array_equal(got, want)
    assert np.array_equal(got[3, :, :32], np.tile(want[3, 0, :32], (1024, 1)))  # all identity


def test_verify_comb_plain_on_the_jax_pool(jcomb):
    """A pool built by the JAX package, loaded into the port's
    (`load_rows`): the port's plain version gives JAX's `_verify_jit`
    verdicts lane for lane on the same marshalled lanes and slots, and the
    wrapper on uint8 rows gives the same."""
    import jax.numpy as jnp

    items = _mixed_items()
    jpool = jcomb.CombPool()  # tests/test_ops_comb.py's pool and bucket shapes: its compiles
    keys = [it[0] for it in items]
    ax, ay, ry, rs, s8, h8, valid = jcomb.base.prepare_batch8(items, 32)
    vidx = [i for i in range(len(items)) if valid[i]]
    slots = np.zeros(32, dtype=np.int32)
    leased, pool_arr = jpool.ensure([keys[i] for i in vidx], ax.T[vidx].astype(np.uint8),
                                    ay.T[vidx].astype(np.uint8))
    slots[vidx] = leased
    want = np.asarray(jcomb._verify_jit(pool_arr, jpool.table_b(), jnp.asarray(slots), jnp.asarray(ry),
                                        jnp.asarray(rs), jnp.asarray(s8), jnp.asarray(h8)))
    rows = np.asarray(pool_arr, dtype=np.float32)
    pool = tcomb.CombPool(capacity=2, device="cpu")
    pool.load_rows(rows, jpool._lru)
    assert pool.capacity == 256 and dict(pool._lru) == dict(jpool._lru)
    assert np.array_equal(pool._pool.numpy(), rows.astype(np.uint8))
    got = tcomb.verify_comb_plain(pool._pool, torch.from_numpy(tcomb.b_table()), torch.from_numpy(slots),
                                  torch.from_numpy(ry), torch.from_numpy(rs), torch.from_numpy(s8),
                                  torch.from_numpy(h8))
    assert np.array_equal(got.numpy(), want)
    u8 = [torch.from_numpy(np.ascontiguousarray(a.astype(np.uint8))) for a in (ry, s8, h8)]
    lanes = tcomb.comb_lanes(pool._pool, pool.table_b(), torch.from_numpy(slots), u8[0],
                             torch.from_numpy(rs), u8[1], u8[2])
    assert np.array_equal(lanes.numpy(), want.astype(np.int32))
    assert list(want[: len(items)] & valid[: len(items)]) == [ted.verify(*it) for it in items]


def test_stats_equal_over_one_call_sequence(jcomb, routes, monkeypatch):
    """Second sight, growth, eviction and PoolExhausted in one sequence on
    a 4-slot pool: the routing, verdicts and stats agree after each call."""
    monkeypatch.setenv("TENDERMINT_TPU_COMB_MIN_SIGHT", "2")
    tcomb.set_default_pool(tcomb.CombPool(capacity=2, max_capacity=4, device="cpu"))
    jcomb.set_default_pool(jcomb.CombPool(capacity=2, max_capacity=4))
    rng = np.random.default_rng(31)
    pairs = [_keypair(rng) for _ in range(5)]

    def batch(keys, per=1):
        return [it for k in keys for it in _signed(rng, *pairs[k], per)]

    for keys in ([0, 1], [0, 1], [2], [2, 3], [0, 1, 2, 3], [4, 0], [4]):
        assert all(_both(jcomb, batch(keys)))
        _same_pools(jcomb)
    assert routes["port"] == routes["jax"]
    assert ("ladder", 4) in routes["port"]  # four keys > three slots: exhausted
    assert tcomb.default_pool("cpu").stats["grows"] == 1


def test_a_batch_resolved_after_its_slot_was_rebuilt():
    """Batch k is dispatched, batch k + 1 evicts batch k's slot and builds
    another key into it, then batch k resolves: its verdicts are those of
    its own key's table (on the CPU the plain version ran at dispatch; on
    the card stream order keeps the launch ahead of the rebuild)."""
    _eviction_then_resolve("cpu")


@pytest.mark.cuda
def test_a_batch_resolved_after_its_slot_was_rebuilt_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _eviction_then_resolve("cuda")


def _eviction_then_resolve(device):
    pool = tcomb.CombPool(capacity=2, max_capacity=2, device=device)  # one usable slot
    tcomb.set_default_pool(pool)
    rng = np.random.default_rng(41)
    (sk_a, pk_a), (sk_b, pk_b) = _keypair(rng), _keypair(rng)
    first = _signed(rng, sk_a, pk_a, 40)
    first[5] = (first[5][0], first[5][1] + b"!", first[5][2])
    second = _signed(rng, sk_b, pk_b, 40)
    before = tcomb.launches
    resolve_first = tcomb.verify_batch_async(first, device)
    resolve_second = tcomb.verify_batch_async(second, device)
    assert dict(pool._lru) == {pk_b: 1} and pool.stats["evictions"] == 1
    assert list(resolve_first()) == [i != 5 for i in range(40)]
    assert list(resolve_second()) == [True] * 40
    assert tcomb.launches == before + (2 if device == "cuda" else 0)


# -- the wrappers ---------------------------------------------------------------


def test_wrappers_check_arguments():
    pool = torch.zeros((2 * 1024, 96), dtype=torch.uint8)
    btab = torch.from_numpy(tcomb.b_table().reshape(1024, 96).astype(np.uint8))
    rows = torch.zeros((32, 3), dtype=torch.uint8)
    slots, rsign = torch.ones(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="pool must be"):
        tcomb.comb_lanes(pool[:1000], btab, slots, rows, rsign, rows, rows)
    with pytest.raises(ValueError, match="B table"):
        tcomb.comb_lanes(pool, btab.float(), slots, rows, rsign, rows, rows)
    with pytest.raises(ValueError, match="slots must be contiguous int32"):
        tcomb.comb_lanes(pool, btab, slots.long(), rows, rsign, rows, rows)
    with pytest.raises(ValueError, match="byte rows"):
        tcomb.comb_lanes(pool, btab, slots, rows.t().contiguous().t(), rsign, rows[:, :2], rows)
    with pytest.raises(ValueError, match=r"slots must lie in \[0, 2\)"):
        tcomb.comb_lanes(pool, btab, slots * 2, rows, rsign, rows, rows)
    with pytest.raises(ValueError, match=r"slots must lie in \[1, 2\)"):
        tcomb.build_lanes(pool, rows, rows, slots * 0)
    assert tcomb.comb_lanes(pool, btab, slots[:0], rows[:, :0], rsign[:0], rows[:, :0],
                            rows[:, :0]).shape == (0,)


def test_a_failing_table_build_raises_instead_of_the_ladder(monkeypatch):
    """No fallback hides the kernel: a build that fails raises out of
    verify_batch; only PoolExhausted reroutes lanes to the ladder."""

    def broken(*args):
        raise RuntimeError("ed25519_comb_tables kernel launch failed: cudaError 700")

    monkeypatch.setattr(tcomb, "build_lanes", broken)
    rng = np.random.default_rng(51)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tcomb.verify_batch(_signed(rng, *_keypair(rng), 2), "cpu")


@pytest.mark.cuda
def test_comb_kernels_match_plain_on_the_card():
    """Both kernels on the card: 40 keys' tables byte for byte the plain
    version's (slot 0 untouched), and verdicts at a ragged 300 lanes equal
    to verify_comb_plain's, B1's and crypto.ed25519.verify."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(61)
    pairs = [_keypair(rng) for _ in range(40)]
    items = [it for i in range(300) for it in _signed(rng, *pairs[i % 40])]
    items[17] = (items[17][0], items[17][1], items[17][2][:63] + b"\x01")
    pool = tcomb.CombPool(capacity=64, device="cuda")
    planes, rs, valid = tf32p.host_planes(items, len(items))
    vidx = np.flatnonzero(valid)
    slots = np.zeros(len(items), dtype=np.int32)
    before = (tcomb.launches, tcomb.table_launches)
    slots[vidx], _ = pool.ensure([items[i][0] for i in vidx], planes[0].T[vidx], planes[1].T[vidx])
    ok = pool.launch(slots, planes, rs)()
    assert (tcomb.launches, tcomb.table_launches) == (before[0] + 1, before[1] + 1)
    qx, qy = _neg_keys([pk for _, pk in pairs])
    leased = [pool._lru[pk] for _, pk in pairs]
    want = tcomb.build_tables_plain(torch.from_numpy(qx).cuda(), torch.from_numpy(qy).cuda())
    rows = pool._pool.view(-1, 1024, 96)
    assert torch.equal(rows[leased], want.to(torch.uint8))
    assert not rows[0].any()
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (slots, planes[2], rs, planes[3], planes[4])]
    plain = tcomb.verify_comb_plain(pool._pool, pool.table_b(), args[0], args[1].float(), args[2],
                                    args[3].int(), args[4].int())
    assert np.array_equal(ok, plain.to(torch.int32).cpu().numpy())
    b1args, _, _ = tf32p.marshal_device_args(items, "cuda")
    assert np.array_equal(ok, tf32p.verify_lanes(*b1args).cpu().numpy())
    assert list(tf32p.materialize_verdicts(ok, valid, len(items))) == [ted.verify(*it) for it in items]
