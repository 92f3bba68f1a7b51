"""Light client: verify headers and data through the RPC surface alone.

Working implementation of docs/specification/light-client-protocol.md
(the reference ships only the spec, light-client-protocol.rst; here the
verifier is code, and its batch-verify hook means even a light client's
commit checks can ride the gateway's Verifier on the card).

Trust model: start from a trusted validator set (genesis or out-of-band);
`verify_header(h)` accepts a header only if that set still holds +2/3 of
the commit; `advance()` walks trust forward height-by-height (sequential
verification — no skipping/bisection, matching the reference line).
"""

from __future__ import annotations

from collections import OrderedDict

from tendermint_tpu_torch.types.agg_commit import commit_from_json, commit_is_aggregate
from tendermint_tpu_torch.types.block import Commit, Header
from tendermint_tpu_torch.types.validator_set import CommitError, ValidatorSet


class LightClientError(Exception):
    pass


class LightClient:
    """`client` is any RPC client exposing .commit/.validators/.tx
    (rpc/client.py HTTPClient, LocalClient, or a test stub)."""

    def __init__(self, client, chain_id: str, trusted_validators: ValidatorSet,
                 trusted_height: int = 0, batch_verifier=None):
        self.client = client
        self.chain_id = chain_id
        self.validators = trusted_validators
        self.height = trusted_height
        self.batch_verifier = batch_verifier
        # last header verified by advance(); persisting it means every
        # validator-set change is chain-linked to a verified predecessor,
        # even across separate advance() calls
        self._trusted_header: Header | None = None
        # small LRU of VERIFIED headers by height: N proof
        # checks at one height cost one commit verification, and a read
        # replica can verify proofs at any recent height without
        # re-walking trust. Every entry comes out of _verify_with, so
        # everything memoized carried +2/3 of a trusted/adopted set.
        self.header_memo_max = 64
        self._header_memo: OrderedDict[int, Header] = OrderedDict()

    @classmethod
    def from_genesis(cls, client, **kw) -> "LightClient":
        """Bootstrap trust from the node's /genesis (trust-on-first-use;
        for stronger setups pass an out-of-band validator set instead)."""
        from tendermint_tpu_torch.types.genesis import GenesisDoc
        from tendermint_tpu_torch.types.validator import Validator

        doc = GenesisDoc.from_json(client.genesis()["genesis"])
        vs = ValidatorSet(
            [Validator.new(v.pub_key, v.power) for v in doc.validators]
        )
        return cls(client, doc.chain_id, vs, trusted_height=0, **kw)

    def copy(self) -> "LightClient":
        """A speculative clone sharing this client's transport and
        current trust: advancing the clone never mutates this instance
        (advance() only REBINDS validators/height/_trusted_header, it
        never mutates the set in place). The statesync restorer walks a
        clone per candidate snapshot and adopts it only once the
        manifest binds — a forged high-height offer must not advance
        trust past lower, honest snapshots."""
        c = LightClient(
            self.client, self.chain_id, self.validators, self.height,
            batch_verifier=self.batch_verifier,
        )
        c._trusted_header = self._trusted_header
        # the memo is copied, not shared: the clone's walk must never
        # mutate this instance's state
        c.header_memo_max = self.header_memo_max
        c._header_memo = OrderedDict(self._header_memo)
        return c

    def trusted_header(self) -> Header | None:
        """The last header advance() fully verified (None until the first
        advance past an anchor). The statesync restorer reads headers H
        and H+1 off the walk to bind a snapshot manifest to the verified
        chain."""
        return self._trusted_header

    # -- header verification ------------------------------------------------

    def verify_header(self, height: int, _res: dict | None = None) -> Header:
        """Fetch (header, commit) at `height` and verify +2/3 of the
        TRUSTED set signed it. Returns the verified header; raises
        LightClientError otherwise. Does not advance trust. `_res` lets
        advance() share one /commit fetch instead of issuing two."""
        return self._verify_with(self.validators, height, _res)

    def _verify_with(
        self, validators: ValidatorSet, height: int, _res: dict | None = None
    ) -> Header:
        """verify_header against an explicit set — advance() uses this so a
        candidate set is never installed as trusted before it verifies."""
        res = _res if _res is not None else self.client.commit(height=int(height))
        if not res.get("commit") or not res.get("header"):
            raise LightClientError(f"no commit/header for height {height}")
        try:
            header = Header.from_json(res["header"])
            # polymorphic: post-upgrade heights serve AggregateCommit
            # (docs/upgrade.md); verify_commit dispatches on the form
            commit = commit_from_json(res["commit"])
        except ValueError as exc:
            # the serving node's response is untrusted input too
            raise LightClientError(f"malformed commit response: {exc}")
        if header.chain_id != self.chain_id:
            raise LightClientError(
                f"chain id {header.chain_id!r} != trusted {self.chain_id!r}"
            )
        if header.height != height:
            raise LightClientError("header height mismatch")
        # the commit must be over THIS header: BlockID.hash == header hash
        if commit.block_id.hash != header.hash():
            raise LightClientError("commit is not over the fetched header")
        # the signing set must be the verifying one, and the header must
        # commit to the same set
        if header.validators_hash != validators.hash():
            raise LightClientError(
                "validator set changed; advance() trust to this height first"
            )
        try:
            validators.verify_commit(
                self.chain_id, commit.block_id, height, commit,
                batch_verifier=self.batch_verifier,
            )
        except CommitError as exc:
            raise LightClientError(f"commit verification failed: {exc}")
        self._memo_header(height, header)
        return header

    def _memo_header(self, height: int, header: Header) -> None:
        memo = self._header_memo
        memo[height] = header
        memo.move_to_end(height)
        while len(memo) > max(1, self.header_memo_max):
            memo.popitem(last=False)

    def header_at(self, height: int) -> Header:
        """A verified header at `height`, from the memo when possible:
        repeat proof checks at one height verify its commit
        once, not once per query. Advances trust when `height` is ahead
        of the walk; raises LightClientError when the height fell out of
        the memo behind trust (re-query for a fresher proof)."""
        hdr = self._header_memo.get(height)
        if hdr is not None:
            self._header_memo.move_to_end(height)
            return hdr
        if height > self.height:
            self.advance(height)
        if height == self.height and self._trusted_header is not None:
            return self._trusted_header
        hdr = self._header_memo.get(height)
        if hdr is not None:
            return hdr
        raise LightClientError(
            f"no verified header at {height} (trust is at {self.height}); "
            "re-query for a fresher proof"
        )

    def advance(self, to_height: int) -> None:
        """Walk trust forward to `to_height`, verifying every header with
        the then-trusted set.

        Validator-set changes: this header format carries no
        next_validators_hash, so a claimed new set can't be linked
        cryptographically through the previous header alone — a node
        could serve a forged set vouched for only by itself. The sound
        sequential rule used here: adopt a new set at height h only if
        (a) it matches header h's validators_hash, (b) +2/3 of the NEW
        set signed commit(h), (c) header h chains to the verified header
        h-1 (last_block_id), and (d) the valid precommits in commit(h)
        cast by validators PRESENT IN THE OLD TRUSTED SET carry > 2/3 of
        the old set's power — i.e. the set we already trust still
        controls the chain across the transition. An attacker without
        2/3 of the trusted keys cannot fabricate (d).

        Pruned sources (bounded retention): a server that
        pruned history below its store base cannot serve the sequential
        walk's early commits. When a commit fetch fails AND the server's
        /status attests `earliest_block_height > h`, the walk JUMPS to
        that horizon. Across the gap, header linkage (c) is unknowable
        and is skipped; trust transfers on the signature rules alone —
        same set: +2/3 of the CURRENTLY trusted set on the horizon
        commit; changed set: rules (a)/(b)/(d), i.e. the old trusted
        set's members must still carry > 2/3 of its power among the
        horizon commit's valid precommits (strictly stronger than
        production Tendermint's 1/3-overlap skipping rule). A set that
        turned over past that bound inside the pruned gap fails loudly:
        the operator must pin statesync.trust_height inside the retained
        window. A lying `earliest_block_height` is denial-of-service
        only — it can widen the jump, never weaken the signature rules."""
        prev_header = self._trusted_header
        if prev_header is None and self.height >= 1:
            # trust was established out-of-band (or this object was rebuilt
            # from a persisted height): verify the trusted height itself so
            # every later set change is chain-linked to a VERIFIED header —
            # only genesis trust (height 0) legitimately has no predecessor
            prev_header = self.verify_header(self.height)
            self._trusted_header = prev_header
        # a verified header at self.height means the walk starts after it;
        # only genesis trust (no header) starts at 1
        h = self.height + 1 if prev_header is not None else 1
        while h <= to_height:
            try:
                res = self.client.commit(height=h)
            except Exception:
                jump = self._horizon_jump_target(h, to_height)
                if jump is None:
                    raise  # a real transport/server failure
                prev_header = None  # linkage across the pruned gap is
                # unknowable; the signature rules below carry the trust
                h = jump
                continue
            try:
                header = Header.from_json(res.get("header"))
            except ValueError as exc:
                raise LightClientError(f"malformed header at {h}: {exc}")
            vals = self.validators
            if header.validators_hash != vals.hash():
                claimed = ValidatorSet.from_json(
                    self.client.validators(height=h)["validators"]
                )
                if claimed.hash() != header.validators_hash:
                    raise LightClientError(
                        f"claimed validator set at {h} does not match header"
                    )
                if prev_header is not None and (
                    header.last_block_id.hash != prev_header.hash()
                ):
                    raise LightClientError(
                        f"header {h} does not chain to verified header {h - 1}"
                    )
                try:
                    commit = commit_from_json(res["commit"])
                except ValueError as exc:
                    raise LightClientError(f"malformed commit at {h}: {exc}")
                self._check_old_set_overlap(h, commit, claimed)
                vals = claimed
            # verify with the candidate set FIRST; only a fully verified
            # height moves trust (set, height, header) forward — a raised
            # LightClientError leaves the previous trusted state intact
            prev_header = self._verify_with(vals, h, _res=res)
            self.validators = vals
            self.height = h
            self._trusted_header = prev_header
            h += 1

    def horizon_floor(self) -> int | None:
        """The server's attested earliest servable height
        (/status earliest_block_height) — what a caller
        stepping the walk in its own strides (statesync's header-caching
        loop) consults to aim past a pruned gap. None when the probe
        fails or the server predates the field."""
        try:
            st = self.client.status()
        except Exception:  # noqa: BLE001 — dead server: no attestation
            return None
        earliest = st.get("earliest_block_height", 0) or 0
        if isinstance(earliest, int) and earliest > 0:
            return earliest
        return None

    def _horizon_jump_target(self, h: int, to_height: int) -> int | None:
        """Where the walk may legally resume when the server cannot
        serve height `h`: the server's own attested earliest height,
        IFF it proves a pruned gap (earliest above h, at or below the
        target). None re-raises the original fetch failure."""
        earliest = self.horizon_floor()
        if earliest is not None and h < earliest <= to_height:
            return earliest
        return None

    def _check_old_set_overlap(
        self, height: int, commit: Commit, new_set: ValidatorSet
    ) -> None:
        """Condition (d) of advance(): > 2/3 of the OLD trusted set's
        power signed commit(height), counting each precommit under the
        NEW set's index order but crediting the OLD set's power.

        With `batch_verifier` wired, the structural filter runs
        first and every candidate signature flushes in ONE gateway batch
        (the turnover check was the last per-sig loop on the light walk);
        per-lane verdicts feed the same tally, so accept/reject is
        byte-identical to the sequential loop."""
        old = self.validators
        if commit_is_aggregate(commit):
            self._check_old_set_overlap_aggregate(height, commit, new_set)
            return
        candidates = []  # (old_val, sign_bytes, signature)
        for idx, pre in enumerate(commit.precommits):
            if pre is None or pre.signature is None:
                continue
            # only precommits FOR this commit's block at this height count:
            # commit_tally tolerates valid precommits for other block ids
            # (they're evidence of the network's round, not endorsement), so
            # without this filter an attacker could stuff replayed genuine
            # old-set precommits from the real chain — same height, different
            # block — into a forged commit and satisfy (d) with zero old-set
            # endorsement of the fork
            if (
                pre.height != height
                or pre.round_ != commit.round_()
                or pre.block_id != commit.block_id
            ):
                continue
            _, val = new_set.get_by_index(idx)
            if val is None:
                continue
            _, old_val = old.get_by_address(val.address)
            if old_val is None:
                continue
            candidates.append(
                (old_val, pre.sign_bytes(self.chain_id), pre.signature)
            )
        if self.batch_verifier is not None:
            oks = self.batch_verifier(
                [(v.pub_key.raw, sb, sig.raw) for v, sb, sig in candidates]
            )
        else:
            oks = [
                v.pub_key.verify_bytes(sb, sig) for v, sb, sig in candidates
            ]
        signed_old_power = sum(
            v.voting_power for (v, _, _), ok in zip(candidates, oks) if ok
        )
        if signed_old_power * 3 <= old.total_voting_power() * 2:
            raise LightClientError(
                f"validator change at {height}: trusted set signed only "
                f"{signed_old_power}/{old.total_voting_power()} power"
            )

    def _check_old_set_overlap_aggregate(
        self, height: int, commit, new_set: ValidatorSet
    ) -> None:
        """Condition (d) for an aggregate-format commit (docs/upgrade.md):
        the half-aggregate is one indivisible equation over the NEW set's
        signer lanes, so it verifies whole — against the new set — and
        then the OLD trusted set's power is credited over the signer
        BITMAP (a signer lane that fails would fail the whole equation,
        so a verified aggregate proves every bitmap member signed).
        The per-lane scalar muls ride the gateway's batched path."""
        if (
            commit.height() != height
            or commit.block_id.is_zero()
        ):
            raise LightClientError(
                f"aggregate commit at {height} has wrong coordinates"
            )
        try:
            commit.verify(self.chain_id, new_set)
        except CommitError as exc:
            raise LightClientError(
                f"validator change at {height}: aggregate commit failed: {exc}"
            )
        old = self.validators
        signed_old_power = 0
        for idx in commit.signers.indices():
            _, val = new_set.get_by_index(idx)
            if val is None:
                continue
            _, old_val = old.get_by_address(val.address)
            if old_val is not None:
                signed_old_power += old_val.voting_power
        if signed_old_power * 3 <= old.total_voting_power() * 2:
            raise LightClientError(
                f"validator change at {height}: trusted set signed only "
                f"{signed_old_power}/{old.total_voting_power()} power"
            )

    # -- data verification --------------------------------------------------

    def verified_query(self, key: bytes, path: str = "", height: int = 0) -> dict:
        """A light-client VERIFIED state read: `abci_query`
        with prove=True, the returned state-tree proof checked against
        the app hash carried by the light-verified header at
        (proof height + 1) — header H+1 commits to the app state block H
        produced. `height` pins the proven version (0 = the app's
        latest; note a proof at the chain HEAD verifies only once the
        next block commits — pass head-1 for an immediately verifiable
        read). Returns {"key", "value", "height", "absent", "proof"};
        `value` is None (and `absent` True) for a verified absence.
        Raises LightClientError on any failure: a missing proof, a
        proofs-unsupported app, a proof that does not verify, or a
        response value contradicting the proven one."""
        import json as _json

        from tendermint_tpu_torch.merkle.statetree_proof import TreeProof

        res = self.client.abci_query(
            data=key.hex(), path=path, height=int(height), prove=True
        )
        resp = res.get("response") if isinstance(res, dict) else None
        if not isinstance(resp, dict):
            raise LightClientError("malformed abci_query response")
        code = resp.get("code", 0)
        if code != 0:
            raise LightClientError(
                f"query refused (code {code}): {resp.get('log', '')}"
            )
        proof_hex = resp.get("proof") or ""
        if not isinstance(proof_hex, str) or not proof_hex:
            raise LightClientError("node returned no state proof")
        h = resp.get("height")
        if not isinstance(h, int) or isinstance(h, bool) or h < 1:
            raise LightClientError("bad proof height in query response")
        try:
            proof = TreeProof.from_json(_json.loads(bytes.fromhex(proof_hex)))
        except ValueError as exc:
            raise LightClientError(f"malformed state proof: {exc}")
        if proof.key != key:
            raise LightClientError("proof is for a different key")
        # the root that commits height-h app state is header (h+1)'s
        # app_hash; header_at serves repeat queries at one height from
        # the verified-header memo and walks trust forward when needed
        app_hash = self.header_at(h + 1).app_hash
        if not proof.verify(app_hash):
            raise LightClientError(
                f"state proof failed verification against header {h + 1}"
            )
        # the response's bare value must BE the proven one — otherwise a
        # node could prove one value while returning another
        resp_value = bytes.fromhex(resp.get("value") or "")
        if proof.is_membership:
            if resp_value != proof.value:
                raise LightClientError("response value does not match proven value")
        elif resp_value:
            raise LightClientError("response carries a value the proof says is absent")
        return {
            "key": key,
            "value": proof.value,
            "height": h,
            "absent": not proof.is_membership,
            "proof": proof,
        }

    def verify_tx(self, tx_hash: bytes, header: Header) -> dict:
        """Fetch a tx with proof and check inclusion against a VERIFIED
        header's data_hash (types/tx.py TxProof)."""
        from tendermint_tpu_torch.types.tx import TxProof

        from tendermint_tpu_torch.types.tx import tx_hash as _tx_hash

        res = self.client.tx(hash=tx_hash.hex(), prove=True)
        if not res.get("proof"):
            raise LightClientError("node returned no proof")
        proof = TxProof.from_json(res["proof"])
        err = proof.validate(header.data_hash)
        if err is not None:
            raise LightClientError(f"tx inclusion proof failed: {err}")
        # the proof must be for the REQUESTED tx, and the response's tx
        # bytes must be the proven ones — otherwise a node could prove
        # some other committed tx while returning arbitrary payload
        if _tx_hash(proof.data) != tx_hash:
            raise LightClientError("proof is for a different tx")
        if bytes.fromhex(res["tx"]) != bytes(proof.data):
            raise LightClientError("response tx does not match proven tx")
        return res
