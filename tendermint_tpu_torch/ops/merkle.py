"""Simple-Merkle trees on the card: the wrapper of the hand-written CUDA
tree kernel K3 (`csrc/merkle_tree.cu`) and its plain PyTorch version, and
the batched leaf hashes of the part-set and tx-tree paths
(types/part_set.go:95-122 NewPartSetFromData, types/tx.go:33-46 Txs.Hash).

1. The host computes the tree's shape only: the left-heavy (n+1)//2
   split, from the shape oracle merkle.simple._flat_shape (the one the
   host FlatTree builds from, so their postorder slot order cannot drift),
   as a dense schedule of (left, right, out) node-slot triples a round
   (`_dense_schedule`, cached per exact leaf count, with each round's
   width; padding entries combine slot 0 with itself into a scratch row).
2. The card holds the node buffer, 20-byte digests as uint32[2n, 5]
   (leaves in rows 0..n-1, internal nodes in FlatTree's postorder, root
   at 2n-2, the scratch row last), and K3 fills every internal node in one
   launch, a round at a time. The plain version `_run_tree` runs the same
   schedule a round at a time with `_inner_preimage_words`.

`part_set_nodes` and `tx_root` chain K1 (ops/hashing.py) into K3 on the
card: the leaf digests are written straight into the node buffer's first
rows, and only the nodes (a part set's proofs need them all) or only the
root come back.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tendermint_tpu_torch.codec.binary import encode_bytes
from tendermint_tpu_torch.merkle.simple import FlatTree, _flat_shape
from tendermint_tpu_torch.ops import hashing, kernels, resolve_device

launches = 0  # K3 launches, by the wrapper
MAX_THREADS = 1024  # K3's block
PAIR_NODES = 32  # nodes a pair of K3's warps takes in one sweep (64 threads)

# -- host: tree schedule -----------------------------------------------------


@lru_cache(maxsize=64)
def _dense_schedule(n: int):
    """Dense schedule arrays for one exact leaf count n >= 2 (leaves cannot
    be padded: the tree over the first n leaves of a padded set is another
    tree). left/right/out: int32[n_rounds, max_width]; entries beyond a
    round's width combine slot 0 with itself into the scratch slot.
    Returns (left, right, out, scratch_slot, buffer_rows, real_slots,
    n_rounds); real_slots = 2n-1 (root last), buffer_rows adds the scratch
    row."""
    _, _, levels = _flat_shape(n)
    n_rounds = len(levels)
    max_width = max(len(level) for level in levels)
    real_slots = 2 * n - 1
    scratch = real_slots
    left = np.zeros((n_rounds, max_width), dtype=np.int32)
    right = np.zeros((n_rounds, max_width), dtype=np.int32)
    out = np.full((n_rounds, max_width), scratch, dtype=np.int32)
    for r, level in enumerate(levels):
        for k, (o, ls, rs) in enumerate(level):
            left[r, k] = ls
            right[r, k] = rs
            out[r, k] = o
    return left, right, out, scratch, real_slots + 1, real_slots, n_rounds


@lru_cache(maxsize=64)
def _device_schedule(n: int, device: str):
    """The schedule of n leaves on `device`, kept there: (left, right,
    out, widths) int32 tensors, widths[r] the real nodes of round r."""
    left, right, out, _, _, _, _ = _dense_schedule(n)
    widths = np.array([len(level) for level in _flat_shape(n)[2]], dtype=np.int32)
    flat = np.concatenate([left.ravel(), right.ravel(), out.ravel(), widths])
    buf = torch.from_numpy(flat).to(device)
    k = left.size
    shape = left.shape
    return (buf[:k].view(shape), buf[k : 2 * k].view(shape), buf[2 * k : 3 * k].view(shape),
            buf[3 * k :])


# -- plain version -------------------------------------------------------------


def _inner_preimage_words(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Digest words int64 (B, 5) -> one padded block int64 (B, 16):
    0x01 0x14 | left | 0x01 0x14 | right, 0x80 at byte 44, the bit length
    352 at bytes 56-57 (merkle.simple.inner_hash, MD-padded)."""
    m = 0xFFFFFFFF
    b = left.shape[0]
    x = torch.zeros((b, 16), dtype=torch.int64, device=left.device)
    x[:, 0] = 0x1401 | ((left[:, 0] << 16) & m)
    x[:, 1:5] = (left[:, :4] >> 16) | ((left[:, 1:] << 16) & m)
    x[:, 5] = (left[:, 4] >> 16) | 0x14010000
    x[:, 6:11] = right
    x[:, 11] = 0x80
    x[:, 14] = 352
    return x


def _run_tree(nodes: torch.Tensor, left, right, out, n_rounds: int) -> torch.Tensor:
    """Plain version of K3 (JAX: ops/merkle.py:126 _run_tree): nodes int64
    (rows, 5) with the leaves filled; each round hashes its whole dense
    row (padding into the scratch slot). Returns the filled buffer."""
    init = torch.tensor(hashing.INIT_RIPEMD, dtype=torch.int64, device=nodes.device)
    nodes = nodes.clone()
    for r in range(n_rounds):
        pre = _inner_preimage_words(nodes[left[r]], nodes[right[r]])
        nodes[out[r]] = hashing.ripemd160_block(init.expand(pre.shape[0], -1), pre)
    return nodes


def block_threads(stride: int) -> int:
    """K3's block for a widest round of `stride` nodes: a pair of warps
    a 32 nodes, at most MAX_THREADS; a round wider than the block's sweep
    spreads over a grid of such blocks."""
    return min(MAX_THREADS, 2 * PAIR_NODES * -(-stride // PAIR_NODES))


def tree_lanes(nodes: torch.Tensor, n: int) -> torch.Tensor:
    """Fill every internal node of the int32 node buffer (2n rows of 5
    digest words, leaves in rows 0..n-1) in place, n >= 2. A CUDA tensor
    launches K3 once without synchronising; a CPU tensor runs `_run_tree`."""
    if n < 2 or nodes.shape != (2 * n, 5) or nodes.dtype != torch.int32:
        raise ValueError(f"nodes must be int32 ({2 * n}, 5) for {n} >= 2 leaves")
    dev = nodes.device
    if dev.type == "cpu":
        left, right, out, _, _, _, n_rounds = _dense_schedule(n)
        as_t = lambda a: torch.from_numpy(a).long()  # noqa: E731
        filled = _run_tree(nodes.long() & 0xFFFFFFFF, as_t(left), as_t(right), as_t(out), n_rounds)
        nodes.copy_(filled.to(torch.int32))
        return nodes
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not nodes.is_contiguous():
        raise ValueError("nodes must be contiguous")
    left, right, out, widths = _device_schedule(n, str(dev))
    threads = block_threads(left.shape[1])
    lib = kernels.load("merkle_tree")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tm_merkle_tree(nodes.data_ptr(), left.data_ptr(), right.data_ptr(), out.data_ptr(),
                                widths.data_ptr(), left.shape[0], left.shape[1], threads, stream)
    if rc != 0:
        raise RuntimeError(f"merkle_tree kernel launch failed: cudaError {rc}")
    kernels.count_launch(__name__)
    return nodes


# -- public API ------------------------------------------------------------------


def _digest_rows(digests: list[bytes], device) -> torch.Tensor:
    """20-byte digests -> a node buffer (2n rows, leaves filled) on device."""
    n = len(digests)
    rows = np.zeros((2 * n, 5), dtype=np.uint32)
    rows[:n] = np.frombuffer(b"".join(digests), dtype="<u4").reshape(n, 5)
    return torch.from_numpy(rows.view(np.int32)).to(device)


def tree_nodes_from_leaf_digests(digests: list[bytes], device=None) -> list[bytes]:
    """All 2n-1 tree node hashes from 20-byte leaf digests: leaves 0..n-1,
    internal nodes in postorder, root last (FlatTree's slot order). Every
    compression runs on the device; the host only reshapes the buffer."""
    n = len(digests)
    if n <= 1:
        return list(digests)
    nodes = tree_lanes(_digest_rows(digests, resolve_device(device)), n)
    return hashing.digests_to_bytes_le(nodes[: 2 * n - 1])


def tree_hash_from_leaf_digests(
    digests: list[bytes], device=None
) -> tuple[bytes, list[list[bytes]]]:
    """Root and per-leaf aunt lists (bottom-up) from 20-byte leaf digests,
    as merkle.simple.simple_proofs_from_hashes gives them."""
    n = len(digests)
    if n == 0:
        return b"", []
    if n == 1:
        return digests[0], [[]]
    tree = FlatTree.from_nodes(n, tree_nodes_from_leaf_digests(digests, device))
    return tree.root(), [tree.aunts_for(i) for i in range(n)]


def merkle_root_from_leaf_digests(digests: list[bytes], device=None) -> bytes:
    if not digests:
        return b""
    return tree_nodes_from_leaf_digests(digests, device)[-1]


def part_leaf_hashes(chunks: list[bytes], device=None) -> list[bytes]:
    """Batched Part.Hash: raw RIPEMD-160 of each chunk (types/part_set.go:32-41)."""
    return hashing.ripemd160_batch(chunks, device)


def leaf_hashes(items: list[bytes], device=None) -> list[bytes]:
    """Batched merkle.simple.leaf_hash: RIPEMD-160 of each length-prefixed
    item (tx leaves)."""
    return hashing.ripemd160_batch([encode_bytes(it) for it in items], device)


def _leaves_into_nodes(msgs: list[bytes], device) -> torch.Tensor:
    """K1 over msgs, writing their digests into rows 0..n-1 of a fresh
    node buffer (2n rows) on device."""
    n = len(msgs)
    words, first, nblocks = hashing.to_device(*hashing.pack_ragged(msgs, True), device)
    nodes = torch.zeros((2 * n, 5), dtype=torch.int32, device=device)
    hashing.ripemd160_lanes(words, first, nblocks, out=nodes[:n])
    return nodes


def part_set_nodes(chunks: list[bytes], device=None) -> tuple[list[bytes], list[bytes]]:
    """(leaf digests, all 2n-1 nodes) of a part set: K1 over the raw chunks
    into the node buffer, then K3 on it, one copy back."""
    n = len(chunks)
    if n == 0:
        return [], []
    nodes = _leaves_into_nodes(chunks, resolve_device(device))
    if n > 1:
        tree_lanes(nodes, n)
    out = hashing.digests_to_bytes_le(nodes[: max(2 * n - 1, 1)])
    return out[:n], out


def tx_root(txs: list[bytes], device=None) -> bytes:
    """Txs.Hash: K1 over the length-prefixed txs into the node buffer, K3,
    and only the root back."""
    n = len(txs)
    if n == 0:
        return b""
    nodes = _leaves_into_nodes([encode_bytes(t) for t in txs], resolve_device(device))
    if n == 1:
        return hashing.digests_to_bytes_le(nodes[:1])[0]
    return hashing.digests_to_bytes_le(tree_lanes(nodes, n)[2 * n - 2 : 2 * n - 1])[0]
