"""The port's Merkle trees against the JAX package's on the same leaves:

- ops/merkle.py: the dense schedule and the inner-node preimage equal
  JAX's (`_dense_schedule`, `_inner_preimage_words`); the plain version of
  K3 gives JAX's `tree_nodes_from_leaf_digests` node buffer and
  `tree_hash_from_leaf_digests` proofs slot for slot at the leaf counts of
  tests/test_ops.py `TestMerkleKernel`; the part and tx leaf hashes, and
  the chained K1 -> K3 paths (`part_set_nodes`, `tx_root`), equal JAX's.
- merkle/simple.py: FlatTree, SharedProof and the proofs' JSON validation
  mirror tests/test_merkle_flat.py, each held against the JAX package's
  `merkle.simple` as well as against the port's recursive oracle.

The `cuda` case holds K3 against its plain version on the card; the JAX
package is imported inside the tests that compare with it, so
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_merkle.py -m cuda`
runs on a machine with a card and no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.merkle.simple import (
    FlatTree,
    SharedProof,
    SimpleProof,
    flat_tree_from_leaf_digests,
    inner_hash,
    kv_hash,
    leaf_hash,
    recursive_proofs_from_hashes,
    simple_hash_from_byteslices,
    simple_hash_from_hashes,
    simple_hash_from_map,
    simple_proofs_from_byteslices,
    simple_proofs_from_hashes,
)
from tendermint_tpu_torch.ops import merkle as tm

KERNEL_COUNTS = [1, 2, 3, 5, 7, 16, 33, 100]  # tests/test_ops.py TestMerkleKernel
# tests/test_merkle_flat.py's PARITY_COUNTS, thinned: the small shapes
# with each odd/even boundary, powers of two and their neighbours, primes
PARITY_COUNTS = list(range(1, 18)) + [31, 32, 33, 63, 64, 65, 97, 127, 128, 129, 257, 300]


def _digests(n: int) -> list[bytes]:
    return [leaf_hash(b"leaf-%d" % i) for i in range(n)]


@pytest.fixture(scope="module")
def js():
    from tendermint_tpu.merkle import simple

    return simple


@pytest.fixture(scope="module")
def jm():
    from tendermint_tpu.ops import merkle

    return merkle


# -- ops/merkle.py -----------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 7, 100, 336])
def test_dense_schedule_matches_jax(jm, n):
    for got, want in zip(tm._dense_schedule(n), jm._dense_schedule(n)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_inner_preimage_words_match_jax(jm):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    left = rng.integers(0, 1 << 32, size=(9, 5), dtype=np.uint64).astype(np.uint32)
    right = rng.integers(0, 1 << 32, size=(9, 5), dtype=np.uint64).astype(np.uint32)
    left[0], right[1] = 0xFFFFFFFF, 0
    want = np.asarray(jm._inner_preimage_words(jnp.asarray(left), jnp.asarray(right)))
    got = tm._inner_preimage_words(torch.from_numpy(left.astype(np.int64)),
                                   torch.from_numpy(right.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", KERNEL_COUNTS)
def test_tree_nodes_and_proofs_match_jax(js, jm, n):
    digests = [leaf_hash(b"item-%d" % i) for i in range(n)]
    assert tm.tree_nodes_from_leaf_digests(digests, "cpu") == jm.tree_nodes_from_leaf_digests(digests)
    root, aunts = tm.tree_hash_from_leaf_digests(digests, "cpu")
    jroot, jaunts = jm.tree_hash_from_leaf_digests(digests)
    assert root == jroot and aunts == jaunts
    root_ref, proofs_ref = js.simple_proofs_from_hashes(digests)
    assert root == root_ref and aunts == [p.aunts for p in proofs_ref]
    assert tm.merkle_root_from_leaf_digests(digests, "cpu") == jm.merkle_root_from_leaf_digests(digests)


def test_empty_and_single_leaf_trees(js):
    assert tm.tree_nodes_from_leaf_digests([], "cpu") == []
    assert tm.tree_hash_from_leaf_digests([], "cpu") == (b"", [])
    assert tm.merkle_root_from_leaf_digests([], "cpu") == b""
    d = [leaf_hash(b"only")]
    assert tm.tree_hash_from_leaf_digests(d, "cpu") == (d[0], [[]])
    assert tm.part_set_nodes([], "cpu") == ([], [])
    assert tm.tx_root([], "cpu") == b""
    assert tm.tx_root([b"one"], "cpu") == leaf_hash(b"one") == js.simple_hash_from_byteslices([b"one"])
    only = tm.part_set_nodes([b"chunk"], "cpu")
    assert only == ([ripemd160(b"chunk")], [ripemd160(b"chunk")])


def test_leaf_hashes_match_jax(js, jm):
    chunks = [bytes([i]) * (100 + i) for i in range(20)]  # TestMerkleKernel.test_part_leaves
    assert tm.part_leaf_hashes(chunks, "cpu") == jm.part_leaf_hashes(chunks)
    items = [b"tx-%d" % i for i in range(9)]
    assert tm.leaf_hashes(items, "cpu") == jm.leaf_hashes(items)
    assert tm.leaf_hashes(items, "cpu") == [js.leaf_hash(i) for i in items]


@pytest.mark.parametrize("n", [1, 2, 11, 33])
def test_chained_paths_match_jax(jm, n):
    rng = np.random.default_rng(n)
    chunks = [rng.bytes(int(rng.integers(1, 300))) for _ in range(n)]
    digests, nodes = tm.part_set_nodes(chunks, "cpu")
    jdigests = jm.part_leaf_hashes(chunks)
    assert digests == jdigests
    assert nodes == jm.tree_nodes_from_leaf_digests(jdigests)
    assert tm.tx_root(chunks, "cpu") == jm.merkle_root_from_leaf_digests(jm.leaf_hashes(chunks))


def test_tree_lanes_refuses_a_wrong_buffer():
    with pytest.raises(ValueError, match="nodes must be int32"):
        tm.tree_lanes(torch.zeros((5, 5), dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="nodes must be int32"):
        tm.tree_lanes(torch.zeros((2, 5), dtype=torch.int32), 1)


# -- merkle/simple.py --------------------------------------------------------


@pytest.mark.parametrize("n", PARITY_COUNTS)
def test_flat_roots_and_proofs_match_recursive_and_jax(js, n):
    ds = _digests(n)
    root_ref, proofs_ref = recursive_proofs_from_hashes(ds)
    root_flat, proofs_flat = simple_proofs_from_hashes(ds)
    jroot, jproofs = js.simple_proofs_from_hashes(ds)
    assert root_flat == root_ref == jroot == simple_hash_from_hashes(ds)
    assert len(proofs_flat) == n
    for i in range(n):
        assert proofs_flat[i].aunts == proofs_ref[i].aunts == jproofs[i].aunts, (n, i)
        assert proofs_flat[i].verify(i, n, ds[i], root_ref)
    assert FlatTree.from_leaf_digests(ds).nodes == js.FlatTree.from_leaf_digests(ds).nodes


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 33, 100])
def test_from_nodes_rehydration(n):
    ds = _digests(n)
    built = flat_tree_from_leaf_digests(ds)
    tree = FlatTree.from_nodes(n, ds + built.internal_nodes())
    root_ref, proofs_ref = recursive_proofs_from_hashes(ds)
    assert tree.root() == root_ref
    for i in range(n):
        assert tree.aunts_for(i) == proofs_ref[i].aunts


def test_from_nodes_validates_count():
    with pytest.raises(ValueError, match="needs 7 nodes"):
        FlatTree.from_nodes(4, _digests(4))


def test_aunts_for_refuses_an_index_out_of_range():
    tree = FlatTree.from_leaf_digests(_digests(3))
    with pytest.raises(IndexError):
        tree.aunts_for(3)


def test_empty():
    root, proofs = simple_proofs_from_hashes([])
    assert root == b"" and proofs == []
    assert simple_hash_from_hashes([]) == b""
    assert flat_tree_from_leaf_digests([]).root() == b""


@pytest.mark.parametrize("n", [2, 3, 7, 16])
def test_non_digest_leaf_widths_match_recursive_and_jax(js, n):
    """Leaves of other widths hash with their real varint prefixes."""
    leaves = [b"x" * (8 + i) for i in range(n)]

    def recursive(hs):
        if len(hs) == 1:
            return hs[0]
        mid = (len(hs) + 1) // 2
        return inner_hash(recursive(hs[:mid]), recursive(hs[mid:]))

    assert simple_hash_from_hashes(leaves) == recursive(leaves) == js.simple_hash_from_hashes(leaves)


def test_shared_proof_is_a_simple_proof(js):
    ds = _digests(7)
    root, proofs = simple_proofs_from_hashes(ds)
    _, proofs_ref = recursive_proofs_from_hashes(ds)
    p = proofs[3]
    assert isinstance(p, SharedProof) and isinstance(p, SimpleProof)
    assert p == proofs_ref[3] and proofs_ref[3] == p
    assert p != proofs_ref[2]
    rt = SimpleProof.from_json(p.to_json())
    assert rt == p and rt.verify(3, 7, ds[3], root)
    assert p.to_json() == js.simple_proofs_from_hashes(ds)[1][3].to_json()


def test_aunts_materialize_lazily_and_once():
    p = flat_tree_from_leaf_digests(_digests(9)).proofs()[4]
    assert p._aunts is None
    first = p.aunts
    assert p.aunts is first


@pytest.mark.parametrize("index,total", [(-1, 3), (3, 3), (0, 0)])
def test_verify_refuses_out_of_range(index, total):
    ds = _digests(3)
    root, proofs = simple_proofs_from_hashes(ds)
    assert not proofs[0].verify(index, total, ds[0], root)


def test_map_byteslices_and_kv_hashes_match_jax(js):
    kvs = {"b": b"2", "a": b"1", "Height": b"\x01\x05", "Data": b""}
    assert simple_hash_from_map(kvs) == js.simple_hash_from_map(kvs)
    assert kv_hash("key", b"value") == js.kv_hash("key", b"value")
    items = [b"tx-%d" % i for i in range(13)]
    assert simple_hash_from_byteslices(items) == js.simple_hash_from_byteslices(items)
    root, proofs = simple_proofs_from_byteslices(items)
    jroot, jproofs = js.simple_proofs_from_byteslices(items)
    assert root == jroot and [p.aunts for p in proofs] == [p.aunts for p in jproofs]


def test_proof_json_roundtrip():
    _, proofs = simple_proofs_from_hashes(_digests(5))
    for p in proofs:
        assert SimpleProof.from_json(p.to_json()).aunts == p.aunts


@pytest.mark.parametrize("width", [0, 2, 38, 42, 64, 128])
def test_wrong_width_aunt_rejected_as_jax(js, width):
    obj = {"aunts": ["ab" * 20, "c" * width]}
    with pytest.raises(ValueError, match="bad merkle proof aunts"):
        SimpleProof.from_json(obj)
    with pytest.raises(ValueError, match="bad merkle proof aunts"):
        js.SimpleProof.from_json(obj)


def test_exact_width_accepted():
    p = SimpleProof.from_json({"aunts": ["AB" * 20, "cd" * 20]})
    assert [len(a) for a in p.aunts] == [20, 20]


@pytest.mark.parametrize("obj", [{"aunts": ["ab" * 20] * 65}, {"aunts": [42]}, {"aunts": "ab" * 20}, []])
def test_depth_and_type_rejected(obj):
    with pytest.raises(ValueError):
        SimpleProof.from_json(obj)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 5, 7, 16, 33, 100, 336, 1024, 1536, 1537, 4000, 10_000])
def test_tree_kernel_matches_plain_on_the_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    digests = _digests(n)
    before = tm.launches
    on_card = tm.tree_nodes_from_leaf_digests(digests, "cuda")
    assert tm.launches == before + 1
    assert on_card == tm.tree_nodes_from_leaf_digests(digests, "cpu")
    assert on_card == FlatTree.from_leaf_digests(digests).nodes
