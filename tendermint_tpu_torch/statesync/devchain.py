"""Deterministic single-validator chain builder.

Builds a REAL chain — blocks made by Block.make_block, commits signed by
the validator's privkey, every block stored via BlockStore.save_block and
applied through state.execution.apply_block against a live ABCI app — at
direct-call speed, with none of the consensus round-trip latency. Used by
the statesync tests and benches (a 1k-block signedkv home builds in
seconds) and usable for seeding dev networks.

The resulting home is byte-indistinguishable from one a consensus node
committed: fast-sync serves and verifies it, snapshots taken from it
restore against its light headers.
"""

from __future__ import annotations

from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.state.execution import apply_block
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.types import (
    GenesisDoc,
    GenesisValidator,
    PrivValidatorFS,
    Vote,
)
from tendermint_tpu_torch.types.block import Block, Commit, empty_commit
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.services import MockMempool
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT


class DevChain:
    """One validator, one app, one block store, one state — drive it
    forward a block at a time with `commit_block(txs)`."""

    def __init__(
        self,
        app,
        chain_id: str = "devchain",
        seed: bytes | None = None,
        block_store_db=None,
        state_db=None,
        hasher=None,
        verifier=None,
    ):
        self.app = app
        self.pv = PrivValidatorFS(
            gen_priv_key_ed25519(seed or b"devchain-validator"), None
        )
        self.genesis_doc = GenesisDoc(
            genesis_time_ns=1_700_000_000_000_000_000,
            chain_id=chain_id,
            validators=[GenesisValidator(self.pv.get_pub_key(), 10, "dev")],
        )
        self.block_store_db = block_store_db if block_store_db is not None else MemDB()
        self.state_db = state_db if state_db is not None else MemDB()
        self.block_store = BlockStore(self.block_store_db)
        self.state = State.get_state(self.state_db, self.genesis_doc)
        self.hasher = hasher
        self.verifier = verifier
        self._last_seen_commit: Commit | None = None
        # state-tree-backed apps batch commit hashing through
        # the same gateway the part plane uses, when one is wired
        app_tree = getattr(app, "tree", None)
        if hasher is not None and app_tree is not None:
            app_tree.hasher = hasher

        from tendermint_tpu_torch.abci.client import LocalClient
        from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus
        import threading

        self._proxy = AppConnConsensus(LocalClient(app, threading.RLock()))

        # mirror the real node's genesis handshake: a fresh chain seeds
        # the app's InitChain with the genesis validator set (the
        # persistent kvstore's registry starts in sync with consensus —
        # the delta-snapshot aux cross-check depends on that)
        if (
            self.state.last_block_height == 0
            and app.info().last_block_height == 0
        ):
            from tendermint_tpu_torch.abci.types import ABCIValidator

            app.init_chain([
                ABCIValidator(v.pub_key.to_json(), v.power)
                for v in self.genesis_doc.validators
            ])

    # -- block production --------------------------------------------------

    def _sign_commit(self, block: Block, parts_header) -> Commit:
        block_id = BlockID(block.hash(), parts_header)
        vote = Vote(
            validator_address=self.pv.get_address(),
            validator_index=0,
            height=block.header.height,
            round_=0,
            type_=VOTE_TYPE_PRECOMMIT,
            block_id=block_id,
        )
        return Commit(block_id, [self.pv.sign_vote(self.state.chain_id, vote)])

    def commit_block(self, txs: list[bytes] | None = None,
                     evidence=None) -> Block:
        """Make, store, and apply the next block; returns it. `evidence`
        embeds an EvidenceData section — the devchain is how
        unit tests mint committed blocks that carry evidence."""
        height = self.state.last_block_height + 1
        last_commit = (
            empty_commit() if height == 1 else self._last_seen_commit
        )
        block, parts = Block.make_block(
            height=height,
            chain_id=self.state.chain_id,
            txs=list(txs or []),
            commit=last_commit,
            prev_block_id=self.state.last_block_id,
            val_hash=self.state.validators.hash(),
            app_hash=self.state.app_hash,
            part_size=self.state.params().block_gossip.block_part_size_bytes,
            time_ns=self.state.last_block_time_ns + 1_000_000_000,
            part_hasher=self.hasher.part_leaf_hashes if self.hasher else None,
            evidence=evidence,
        )
        seen_commit = self._sign_commit(block, parts.header())
        self.block_store.save_block(block, parts, seen_commit)
        apply_block(
            self.state,
            None,
            self._proxy,
            block,
            parts.header(),
            MockMempool(),
            batch_verifier=(
                self.verifier.commit_batch_verifier() if self.verifier else None
            ),
        )
        self._last_seen_commit = seen_commit
        return block

    def build(self, n_blocks: int, tx_fn=None) -> None:
        """Commit `n_blocks` blocks; `tx_fn(height) -> list[bytes]`
        supplies each block's txs."""
        for _ in range(n_blocks):
            h = self.state.last_block_height + 1
            self.commit_block(tx_fn(h) if tx_fn else None)

    # -- RPC-shaped serving (what a light client needs) --------------------

    def rpc_stub(self) -> "DevChainRPC":
        return DevChainRPC(self)


class DevChainRPC:
    """The commit/validators/status subset of the RPC surface, served
    straight off the DevChain's stores — a LightClient-compatible client
    for tests and benches (rpc/light.py only needs .commit/.validators)."""

    def __init__(self, chain: DevChain):
        self.chain = chain

    def commit(self, height):
        height = int(height)
        store = self.chain.block_store
        meta = store.load_block_meta(height)
        if meta is None:
            return {"header": None, "commit": None}
        if height == store.height():
            cmt = store.load_seen_commit(height)
            canonical = False
        else:
            cmt = store.load_block_commit(height)
            canonical = True
        return {
            "header": meta.header.to_json(),
            "commit": cmt.to_json() if cmt else None,
            "canonical_commit": canonical,
        }

    def validators(self, height=0):
        vs = self.chain.state.load_validators(int(height))
        return {"block_height": int(height), "validators": vs.to_json()}

    def status(self):
        return {"latest_block_height": self.chain.block_store.height()}

    def abci_query(self, data="", path="", height=0, prove=False):
        """The rpc/core abci_query shape, served straight off the app —
        what LightClient.verified_query drives in tests/benches."""
        res = self.chain.app.query(
            bytes.fromhex(data) if data else b"", path, int(height), bool(prove)
        )
        return {
            "response": {
                "code": res.code,
                "key": res.key.hex().upper(),
                "value": (res.value or b"").hex().upper(),
                "proof": (res.proof or b"").hex().upper(),
                "height": res.height,
                "log": res.log,
            }
        }


def build_kvstore_chain(n_blocks: int, txs_per_block: int = 2, **kw):
    """Convenience: a KVStore DevChain with deterministic txs."""
    from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp

    chain = DevChain(KVStoreApp(), **kw)
    chain.build(
        n_blocks,
        tx_fn=lambda h: [
            b"k%d-%d=v%d" % (h, i, h) for i in range(txs_per_block)
        ],
    )
    return chain


def build_signedkv_chain(n_blocks: int, txs_per_block: int = 2, **kw):
    """A SignedKV DevChain: every tx carries a real Ed25519 envelope, so
    DeliverTx verifies signatures — the committee-verify workload the
    snapshot/restore bench compares against."""
    from tendermint_tpu_torch.abci.apps.signedkv import SignedKVStoreApp, make_sig_tx

    signer = bytes(range(32))
    chain = DevChain(SignedKVStoreApp(), **kw)
    chain.build(
        n_blocks,
        tx_fn=lambda h: [
            make_sig_tx(signer, b"s%d-%d=v%d" % (h, i, h))
            for i in range(txs_per_block)
        ],
    )
    return chain
