"""ValidatorSet: address-sorted validator set with commit verification
(reference: types/validator_set.go).

verify_commit is the hottest path in the reference (sequential Ed25519
verifies, types/validator_set.go:220-264; called per block at
state/execution.go:198 and per fast-sync block at
blockchain/reactor.go:235). It takes a pluggable batch verifier so a whole
commit's signatures go to the device kernel in one batch, with the exact
accept/reject semantics of the sequential loop. An AggregateCommit takes
the aggregate branch instead: one multi-term check through the gateway.
"""

from __future__ import annotations

import bisect

from tendermint_tpu_torch.merkle.simple import simple_hash_from_hashes
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT


class CommitError(Exception):
    pass


class ValidatorSet:
    def __init__(self, validators: list[Validator] | None):
        self.validators: list[Validator] = sorted(
            (v.copy() for v in (validators or [])), key=lambda v: v.address
        )
        self.proposer: Validator | None = None
        self._total_voting_power = 0
        self._hash: bytes | None = None
        if validators:
            self.increment_accum(1)

    def _addresses(self) -> list[bytes]:
        return [v.address for v in self.validators]

    def get_by_address(self, address: bytes) -> tuple[int, Validator | None]:
        i = bisect.bisect_left(self._addresses(), address)
        if i < len(self.validators) and self.validators[i].address == address:
            return i, self.validators[i].copy()
        return 0, None

    def has_address(self, address: bytes) -> bool:
        return self.get_by_address(address)[1] is not None

    def get_by_index(self, index: int) -> tuple[bytes, Validator | None]:
        if index < 0 or index >= len(self.validators):
            return b"", None
        v = self.validators[index]
        return v.address, v.copy()

    def size(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        if self._total_voting_power == 0:
            self._total_voting_power = sum(v.voting_power for v in self.validators)
        return self._total_voting_power

    def increment_accum(self, times: int) -> None:
        """Each validator gains VotingPower*times accum; `times` times, the
        richest validator is decremented by the total power; the last
        decremented one becomes proposer (types/validator_set.go:52-69)."""
        for v in self.validators:
            v.accum += v.voting_power * times
        for i in range(times):
            mostest = None
            for v in self.validators:
                mostest = v.compare_accum(mostest)
            if i == times - 1:
                self.proposer = mostest
            mostest.accum -= self.total_voting_power()

    def get_proposer(self) -> Validator | None:
        if not self.validators:
            return None
        if self.proposer is None:
            p = None
            for v in self.validators:
                p = v.compare_accum(p)
            self.proposer = p
        return self.proposer.copy()

    # -- membership changes (applied from ABCI EndBlock diffs,
    #    state/execution.go:120-159) ----------------------------------------

    def _invalidate(self) -> None:
        self.proposer = None
        self._total_voting_power = 0
        self._hash = None

    def add(self, val: Validator) -> bool:
        val = val.copy()
        i = bisect.bisect_left(self._addresses(), val.address)
        if i < len(self.validators) and self.validators[i].address == val.address:
            return False
        self.validators.insert(i, val)
        self._invalidate()
        return True

    def update(self, val: Validator) -> bool:
        i, existing = self.get_by_address(val.address)
        if existing is None:
            return False
        self.validators[i] = val.copy()
        self._invalidate()
        return True

    def remove(self, address: bytes) -> tuple[Validator | None, bool]:
        i = bisect.bisect_left(self._addresses(), address)
        if i >= len(self.validators) or self.validators[i].address != address:
            return None, False
        removed = self.validators.pop(i)
        self._invalidate()
        return removed, True

    def copy(self) -> "ValidatorSet":
        vs = ValidatorSet(None)
        vs.validators = [v.copy() for v in self.validators]
        vs.proposer = self.proposer.copy() if self.proposer else None
        vs._total_voting_power = self._total_voting_power
        return vs

    def hash(self) -> bytes:
        """Merkle root of validator identity hashes
        (types/validator_set.go:140-148), memoized."""
        if not self.validators:
            return b""
        if self._hash is None:
            self._hash = simple_hash_from_hashes([v.hash() for v in self.validators])
        return self._hash

    # -- commit verification ------------------------------------------------

    def verify_commit(
        self,
        chain_id: str,
        block_id: BlockID,
        height: int,
        commit,
        batch_verifier=None,
    ) -> None:
        """Raise CommitError unless +2/3 of this set signed the commit
        (types/validator_set.go:220-264 semantics, preserved exactly).

        batch_verifier: callable(list[(pubkey32, msg, sig64)]) -> list[bool].
        When given, all structural checks run first, then every signature in
        the commit is verified in ONE batch; per-signature results feed the
        same accept/reject logic the sequential loop has.

        Polymorphic over the commit format: an AggregateCommit takes the
        aggregate branch (one multi-term check, batched through the
        gateway), so every caller spans the upgrade boundary without
        knowing it."""
        if self._try_verify_aggregate(chain_id, block_id, height, commit):
            return
        items = self._commit_structural_check(chain_id, height, commit)
        if batch_verifier is not None:
            oks = batch_verifier(
                [(val.pub_key.raw, sb, sig.raw) for _, _, val, sb, sig in items]
            )
        else:
            oks = [
                val.pub_key.verify_bytes(sb, sig) for _, _, val, sb, sig in items
            ]
        self._commit_tally(block_id, items, oks)

    def verify_commit_async(
        self, chain_id: str, block_id: BlockID, height: int, commit,
        async_batch_verifier,
    ):
        """Pipelined verify_commit: structural checks run now (raising
        CommitError immediately), the signature batch is dispatched to the
        device, and the returned zero-arg resolver finishes the tally —
        raising CommitError exactly as verify_commit would.

        async_batch_verifier: callable(items) -> resolver() -> list[bool]
        (ops.gateway.Verifier.verify_batch_async)."""
        if self._aggregate_precheck(chain_id, block_id, height, commit):
            def finish_agg() -> None:
                self._try_verify_aggregate(chain_id, block_id, height, commit)

            return finish_agg
        items = self._commit_structural_check(chain_id, height, commit)
        resolve = async_batch_verifier(
            [(val.pub_key.raw, sb, sig.raw) for _, _, val, sb, sig in items]
        )

        def finish() -> None:
            self._commit_tally(block_id, items, resolve())

        return finish

    def verify_commits_async(self, chain_id: str, entries, async_batch_verifier):
        """Grouped verify_commit_async: several commits' signature batches
        concatenated into ONE device dispatch (fast sync verifies four
        commits per group). entries = [(block_id, height, commit)]; returns
        one zero-arg finisher per entry, each raising CommitError exactly as
        verify_commit would for its block."""
        spans, all_items = [], []
        for block_id, height, commit in entries:
            try:
                if self._aggregate_precheck(chain_id, block_id, height, commit):
                    # aggregate entries carry no per-vote lanes for the
                    # group batch; each runs its own multi-term check (one
                    # verify_aggregate call, one dsm launch) at consume time
                    spans.append((block_id, None, 0, 0, (height, commit)))
                    continue
                items = self._commit_structural_check(chain_id, height, commit)
            except CommitError as exc:
                # a structurally bad commit must not poison its group: its
                # finisher re-raises at consume time
                spans.append((block_id, exc, 0, 0, None))
                continue
            spans.append(
                (block_id, items, len(all_items), len(all_items) + len(items), None)
            )
            all_items.extend(
                (val.pub_key.raw, sb, sig.raw) for _, _, val, sb, sig in items
            )
        resolve = async_batch_verifier(all_items)
        memo: dict = {}

        def resolved():
            if "oks" not in memo:
                memo["oks"] = resolve()
            return memo["oks"]

        def make_finish(block_id, items, lo, hi, aggregate):
            def finish() -> None:
                if isinstance(items, CommitError):
                    raise items
                if aggregate is not None:
                    self._try_verify_aggregate(chain_id, block_id, *aggregate)
                    return
                self._commit_tally(block_id, items, resolved()[lo:hi])

            return finish

        return [make_finish(*span) for span in spans]

    # -- aggregate-commit branch (docs/upgrade.md cutover) -----------------

    def _aggregate_precheck(self, chain_id: str, block_id: BlockID,
                            height: int, commit) -> bool:
        """True iff `commit` is an AggregateCommit; raises CommitError on
        the cheap structural mismatches so async callers fail fast."""
        from tendermint_tpu_torch.types.agg_commit import AggregateCommit

        if not isinstance(commit, AggregateCommit):
            return False
        if height != commit.height():
            raise CommitError(f"wrong height: {height} vs {commit.height()}")
        if block_id != commit.block_id:
            raise CommitError(
                f"aggregate commit is for a different block: "
                f"{commit.block_id!r} vs {block_id!r}"
            )
        err = commit.validate_basic()
        if err:
            raise CommitError(err)
        return True

    def _try_verify_aggregate(self, chain_id: str, block_id: BlockID,
                              height: int, commit) -> bool:
        """Full aggregate verify (structural + quorum + multi-term
        crypto); returns False when `commit` is a plain Commit."""
        if not self._aggregate_precheck(chain_id, block_id, height, commit):
            return False
        commit.verify(chain_id, self)
        return True

    def _commit_structural_check(self, chain_id: str, height: int, commit):
        """Everything verify_commit checks before signatures; returns the
        signature work items (idx, precommit, validator, sign_bytes, sig)."""
        if self.size() != len(commit.precommits):
            raise CommitError(
                f"wrong set size: {self.size()} vs {len(commit.precommits)}"
            )
        if height != commit.height():
            raise CommitError(f"wrong height: {height} vs {commit.height()}")

        round_ = commit.round_()
        items = []
        # sign bytes exclude the validator identity, so every precommit for
        # the same (H, R, block) shares ONE byte string: memoizing turns N
        # canonical serializations per commit into one
        sb_cache: dict = {}
        for idx, precommit in enumerate(commit.precommits):
            if precommit is None:
                continue  # validator skipped: fine
            if precommit.height != height:
                raise CommitError(f"wrong precommit height at {idx}")
            if precommit.round_ != round_:
                raise CommitError(f"wrong precommit round at {idx}")
            if precommit.type_ != VOTE_TYPE_PRECOMMIT:
                raise CommitError(f"not a precommit at index {idx}")
            _, val = self.get_by_index(idx)
            if precommit.signature is None:
                raise CommitError(f"missing signature at index {idx}")
            sb_key = (precommit.height, precommit.round_, precommit.block_id)
            sb = sb_cache.get(sb_key)
            if sb is None:
                sb = sb_cache[sb_key] = precommit.sign_bytes(chain_id)
            items.append((idx, precommit, val, sb, precommit.signature))
        return items

    def _commit_tally(self, block_id: BlockID, items, oks) -> None:
        tallied = 0
        for (idx, precommit, val, _, _), ok in zip(items, oks):
            if not ok:
                raise CommitError(f"invalid signature: {precommit!r}")
            if block_id != precommit.block_id:
                continue  # not an error, but doesn't count toward quorum
            tallied += val.voting_power

        if tallied <= self.total_voting_power() * 2 // 3:
            raise CommitError(
                f"insufficient voting power: got {tallied}, "
                f"needed {self.total_voting_power() * 2 // 3 + 1}"
            )

    def to_json(self):
        return {
            "validators": [v.to_json() for v in self.validators],
            "proposer": self.proposer.to_json() if self.proposer else None,
        }

    @classmethod
    def from_json(cls, obj) -> "ValidatorSet":
        vs = cls(None)
        vs.validators = [Validator.from_json(v) for v in obj["validators"]]
        if obj.get("proposer"):
            p = Validator.from_json(obj["proposer"])
            # alias the in-set object when present (the reference's heap
            # holds pointers into the validator list)
            vs.proposer = next(
                (v for v in vs.validators if v.address == p.address), p
            )
        return vs

    def __repr__(self):
        prop = self.get_proposer()
        return f"ValidatorSet{{n:{self.size()} proposer:{prop!r}}}"
