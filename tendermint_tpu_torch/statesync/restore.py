"""Snapshot restore: verify a manifest + chunks against the light-client
header chain, apply the app state, and seed state DB + block store at the
snapshot height — after which the ordinary fast-sync reactor replays only
the tail.

Trust model (docs/state-sync.md): NOTHING in a snapshot is trusted on
its own. The manifest binds to two light-verified headers —

    manifest.header_hash == hash(header H)
    manifest.app_hash    == header (H+1).app_hash

(the app hash resulting from block H's commit is carried by header H+1)
— and every claim inside the payload is checked against those headers:
the embedded state's last_block_id, app_hash, validator sets (via
validators_hash of H and H+1), the block-H meta/parts (proof-verified
against the parts root the seen commit SIGNED), and the seen commit
itself (+2/3 of the verified height-H set). Chunk digests batch-verify
against the manifest through the hashing gateway (streamed devd plane
when a daemon serves, CPU fallback behind the breaker), so transport
corruption is caught per chunk, before reassembly.

The light client walks sequentially from its trust anchor (genesis
trust-on-first-use, or an operator-pinned height), so restore cost is
one commit-verify per height from anchor to H+1 plus the snapshot apply
— against fast-sync's verify + EXECUTE + store per height from genesis.

The port's copy of the JAX package's `statesync/restore.py`, with one
deliberate difference: a device error (ops.gateway.DeviceError) raised
by a commit verify or a digest batch is not a transport failure and not
a bad snapshot. It leaves `verify_manifest` as itself, where the JAX
package turns every exception of the light walk into a RestoreError the
reactor retries, and it passes through `restore` untouched.
"""

from __future__ import annotations

import json
import logging
import time

from tendermint_tpu_torch.statesync.snapshot import (
    KIND_DELTA,
    KIND_FULL,
    Manifest,
    chunk_digest,
)

logger = logging.getLogger("statesync.restore")


class RestoreError(Exception):
    pass


class ManifestBindingError(RestoreError):
    """The manifest CONTRADICTS the light-verified chain (wrong chain id,
    header hash, or app hash) — proof the peer that served it lied, as
    opposed to a light-walk failure, which says nothing about the peer."""


class SnapshotRejected(RestoreError):
    """The snapshot CONTENT is proven bad (payload verification failed)
    or the height is permanently unverifiable (behind the light trust) —
    the reactor blacklists the height. A plain RestoreError is treated
    as transient (timeout, no peers, transport) and retried."""


def verify_chunk_batch(
    manifest: Manifest, indexed_chunks: list[tuple[int, bytes]], hasher=None
) -> list[int]:
    """Digest-check received chunks against the manifest in ONE batch
    (the gateway's streamed hash plane when wired). Returns the indices
    whose digest MISMATCHES — the caller's refetch/peer-ban list.
    Out-of-range indices raise: the caller already validated them."""
    for idx, _ in indexed_chunks:
        if not 0 <= idx < manifest.chunks:
            raise RestoreError(f"chunk index {idx} out of range")
    payloads = [c for _, c in indexed_chunks]
    if hasher is not None and payloads:
        digests = hasher.part_leaf_hashes(payloads)
    else:
        digests = [chunk_digest(c) for c in payloads]
    return [
        idx
        for (idx, _), got in zip(indexed_chunks, digests)
        if got != manifest.chunk_digests[idx]
    ]


class Restorer:
    """Pure verify/apply logic, transport-agnostic: the p2p reactor (and
    tests/benches) feed it a manifest + chunks however they obtained
    them. `light_client` is an rpc/light.LightClient positioned at or
    before the snapshot height; pass trust_manifest=True ONLY in tests
    that verify other layers."""

    def __init__(
        self,
        genesis_doc,
        app,
        state_db,
        block_store,
        hasher=None,
        light_client=None,
        batch_verifier=None,
        trust_manifest: bool = False,
    ):
        if light_client is None and not trust_manifest:
            raise ValueError("Restorer needs a light client (or trust_manifest=True)")
        self.genesis_doc = genesis_doc
        self.app = app
        self.state_db = state_db
        self.block_store = block_store
        self.hasher = hasher
        self.light_client = light_client
        self.batch_verifier = batch_verifier
        self.trust_manifest = trust_manifest
        # headers the light walk verified, by height — verify_manifest
        # may run more than once for the same snapshot (the reactor
        # pre-binds before downloading, restore() re-binds before
        # applying) and the light client cannot walk backwards
        self._verified_headers: dict = {}
        # gauges (statesync_* in the metrics RPC)
        self.chunks_verified = 0
        self.chunk_digest_failures = 0
        self.restore_seconds = 0.0
        self.restored_height = 0
        self.deltas_applied = 0
        self.delta_entries_applied = 0
        self.delta_proof_failures = 0

    # -- verification ------------------------------------------------------

    def verify_manifest(self, manifest: Manifest):
        """Advance light-client trust through H+1 and bind the manifest
        to the verified headers. Returns (header_H, header_H1) — or
        (None, None) under trust_manifest. Raises RestoreError when the
        manifest contradicts the verified chain."""
        if self.light_client is None:
            return None, None
        from tendermint_tpu_torch.ops.gateway import DeviceError
        from tendermint_tpu_torch.rpc.light import LightClientError

        lc = self.light_client
        if lc.chain_id != manifest.chain_id:
            raise ManifestBindingError(
                f"manifest chain {manifest.chain_id!r} != trusted {lc.chain_id!r}"
            )
        h = manifest.height
        # walk a CLONE: a candidate snapshot whose walk or binding fails
        # must not advance the real trust — a forged high-height offer
        # would otherwise put every lower honest snapshot "behind the
        # light client" and force the genesis fast-sync fallback
        walker = None
        try:
            for height in (h, h + 1):
                if height not in self._verified_headers:
                    if walker is None:
                        walker = lc.copy()
                    # advance ONE height at a time, caching every header
                    # the walk verifies in passing: if this candidate
                    # later dies (chunks never arrive), a LOWER honest
                    # snapshot must still bind from the cache — the walk
                    # itself cannot go backwards
                    while walker.height < height:
                        step = walker.height + 1
                        try:
                            walker.advance(step)
                        except (LightClientError, DeviceError):
                            raise
                        except Exception:
                            # a PRUNED source cannot serve the
                            # one-height stride; aim the walk at its
                            # attested horizon instead — advance()'s
                            # pruned-gap signature rules carry the trust
                            # across, and everything below the horizon is
                            # uncacheable from this source regardless
                            floor = walker.horizon_floor()
                            if floor is None or not step < floor <= height:
                                raise
                            walker.advance(floor)
                        self._verified_headers[walker.height] = (
                            walker.trusted_header()
                        )
                    if walker.height != height:
                        # behind the anchor (or a prior walk) AND not in
                        # the cache: permanently unverifiable
                        raise SnapshotRejected(
                            f"snapshot height {height} is behind the light "
                            f"client's trust ({walker.height}); pick a newer one"
                        )
            header_h = self._verified_headers[h]
            header_h1 = self._verified_headers[h + 1]
        except LightClientError as exc:
            raise RestoreError(f"light verification to {h + 1} failed: {exc}")
        except (RestoreError, DeviceError):
            raise
        except Exception as exc:  # noqa: BLE001 — transport/RPC failures
            # the walk rides a live RPC connection: a refused socket or
            # an RPC-client error is a TRANSIENT failure the driver must
            # retry, never a crash that abandons statesync for good
            raise RestoreError(
                f"light verification to {h + 1} failed (transport): {exc}"
            )
        if manifest.header_hash != header_h.hash():
            raise ManifestBindingError(
                f"manifest header hash {manifest.header_hash.hex()[:12]} != "
                f"verified header {header_h.hash().hex()[:12]} at {h}"
            )
        if manifest.app_hash != header_h1.app_hash:
            raise ManifestBindingError(
                f"manifest app hash does not match verified header {h + 1}"
            )
        if walker is not None:
            # the manifest bound: adopt the walked trust
            self.light_client = walker
        return header_h, header_h1

    def verify_chunks(self, manifest: Manifest, chunks: list[bytes]) -> None:
        if len(chunks) != manifest.chunks:
            raise RestoreError(
                f"{len(chunks)} chunk(s) for a {manifest.chunks}-chunk manifest"
            )
        bad = verify_chunk_batch(
            manifest, list(enumerate(chunks)), hasher=self.hasher
        )
        self.chunks_verified += len(chunks) - len(bad)
        self.chunk_digest_failures += len(bad)
        if bad:
            raise RestoreError(f"chunk digest mismatch at {bad}")

    def _parse_payload(self, manifest: Manifest, payload: bytes) -> dict:
        if len(payload) != manifest.total_bytes:
            raise RestoreError(
                f"payload is {len(payload)} bytes, manifest says {manifest.total_bytes}"
            )
        try:
            obj = json.loads(payload)
        except ValueError as exc:
            raise RestoreError(f"snapshot payload is not valid JSON: {exc}")
        if not isinstance(obj, dict) or obj.get("format") != manifest.format:
            raise RestoreError("snapshot payload format mismatch")
        if manifest.format >= 2 and obj.get("kind") != manifest.kind:
            raise RestoreError("snapshot payload kind mismatch")
        if obj.get("height") != manifest.height or obj.get("chain_id") != manifest.chain_id:
            raise RestoreError("snapshot payload height/chain mismatch")
        return obj

    def _verify_host(self, manifest: Manifest, obj: dict, header_h, header_h1):
        """Cross-check every host-section claim (embedded state, block H
        meta/parts, seen commit, validator history) against the verified
        headers. The seen commit comes from the PAYLOAD for format-1
        manifests and from the MANIFEST sidecar for format 2 (splitting it out of the digested bytes is what makes replica
        snapshot roots deterministic — it is re-verified here either
        way). Returns (state, meta, parts, seen_commit, validators_info)."""
        from tendermint_tpu_torch.state.state import State
        from tendermint_tpu_torch.types import PartSet
        from tendermint_tpu_torch.types.agg_commit import commit_from_json
        from tendermint_tpu_torch.types.block_meta import BlockMeta
        from tendermint_tpu_torch.types.part_set import Part, PartSetError
        from tendermint_tpu_torch.types.validator_set import CommitError

        h = manifest.height
        try:
            state = State.from_json_obj(
                self.state_db, self.genesis_doc, obj["state"]
            )
            meta = BlockMeta.from_json(obj["block"]["meta"])
            if manifest.format >= 2:
                if manifest.seen_commit is None:
                    raise ValueError("format-2 manifest carries no seen commit")
                seen_commit = commit_from_json(manifest.seen_commit)
            else:
                seen_commit = commit_from_json(obj["block"]["seen_commit"])
            parts_json = obj["block"]["parts"]
            validators_info = obj["validators_info"]
            if not isinstance(parts_json, list) or not isinstance(validators_info, dict):
                raise ValueError("bad parts/validators_info")
        except (KeyError, TypeError, ValueError) as exc:
            raise RestoreError(f"malformed snapshot payload: {exc}")

        if state.chain_id != manifest.chain_id or state.last_block_height != h:
            raise RestoreError("embedded state does not match manifest")
        # State.from_json_obj installs these without type checks, and the
        # restore path arithmetics on them (max() below, consensus time
        # math after handoff) — a non-int must refuse as a RestoreError,
        # not crash the driver
        lhc = state.last_height_validators_changed
        if not isinstance(lhc, int) or isinstance(lhc, bool) or not 0 <= lhc <= h + 1:
            raise RestoreError("bad state last_height_validators_changed")
        t_ns = state.last_block_time_ns
        if not isinstance(t_ns, int) or isinstance(t_ns, bool) or t_ns < 0:
            raise RestoreError("bad state block time")
        if state.last_block_id.hash != manifest.header_hash:
            raise RestoreError("embedded state's last block is not the verified header")
        if state.app_hash != manifest.app_hash:
            raise RestoreError("embedded state's app hash mismatch")
        if header_h is not None:
            if state.last_validators.hash() != header_h.validators_hash:
                raise RestoreError(
                    f"snapshot validator set at {h} does not match verified header"
                )
            if state.validators.hash() != header_h1.validators_hash:
                raise RestoreError(
                    f"snapshot validator set for {h + 1} does not match verified header"
                )
            if header_h1.last_block_id != state.last_block_id:
                raise RestoreError("verified header chain does not link the state")
        # the validator-history records seed load_validators and become
        # RPC-visible "historical truth", and seed_restored persists them
        # as-is — so every record is validated IN FULL here: the keys
        # must be exactly the heights the producer emits (lhc, H, H+1 —
        # validators_info_records), every record a well-formed
        # saveValidatorsInfo shape whose pointer resolves to a record in
        # this same payload, and every embedded set one of the two
        # header-verified ones
        allowed_keys = {str(max(lhc, 1)), str(h), str(h + 1)}
        if set(validators_info) - allowed_keys:
            raise RestoreError("validators_info carries unexpected heights")
        allowed = {state.validators.hash(), state.last_validators.hash()}
        for key, rec in validators_info.items():
            if not isinstance(rec, dict):
                raise RestoreError("malformed validators_info record")
            ptr = rec.get("last_height_changed")
            if (
                not isinstance(ptr, int) or isinstance(ptr, bool)
                or not 1 <= ptr <= int(key)
            ):
                raise RestoreError("bad validators_info pointer")
            if "validator_set" in rec:
                from tendermint_tpu_torch.types.validator_set import ValidatorSet

                try:
                    vs = ValidatorSet.from_json(rec["validator_set"])
                except (KeyError, TypeError, ValueError) as exc:
                    raise RestoreError(f"malformed validators_info set: {exc}")
                if vs.hash() not in allowed:
                    raise RestoreError(
                        "validators_info record carries an unverified set"
                    )
            else:
                target = validators_info.get(str(ptr))
                if not isinstance(target, dict) or "validator_set" not in target:
                    raise RestoreError(
                        "validators_info pointer does not resolve to a set"
                    )
        # presence, not just shape: the records for H and H+1 MUST exist
        # (they are exactly what load_validators needs on the restored
        # node) — a stripped-empty validators_info would otherwise pass
        # every per-record check and restore a node whose /validators
        # queries raise forever
        for need in (str(h), str(h + 1)):
            if need not in validators_info:
                raise RestoreError(f"validators_info missing height {need}")

        # block H: meta must BE the verified header; parts must prove
        # into the parts root the seen commit signed (it signs the whole
        # BlockID, parts header included)
        if meta.header.hash() != manifest.header_hash:
            raise RestoreError("snapshot block meta is not the verified header")
        if meta.block_id != state.last_block_id:
            raise RestoreError("snapshot block meta id mismatch")
        ps = PartSet.from_header(meta.block_id.parts_header)
        try:
            for pj in parts_json:
                ps.add_part(Part.from_json(pj))
        except (PartSetError, ValueError) as exc:
            raise RestoreError(f"snapshot block parts invalid: {exc}")
        if not ps.is_complete():
            raise RestoreError("snapshot block parts incomplete")
        if seen_commit.block_id != meta.block_id:
            raise RestoreError("seen commit is not over the snapshot block")
        try:
            state.last_validators.verify_commit(
                state.chain_id, meta.block_id, h, seen_commit,
                batch_verifier=self.batch_verifier,
            )
        except CommitError as exc:
            raise RestoreError(f"seen commit verification failed: {exc}")
        parts = [ps.get_part(i) for i in range(ps.total)]
        return state, meta, parts, seen_commit, validators_info

    def _seed(self, state, meta, parts, seen_commit, validators_info) -> None:
        self.block_store.seed_snapshot(meta, parts, seen_commit)
        state.seed_restored(validators_info)

    # -- the whole path ----------------------------------------------------

    def restore(self, manifest: Manifest, chunks: list[bytes], seed: bool = True):
        """Verify everything, apply the app state, seed state DB + block
        store. Returns the restored State. Raises RestoreError; on any
        failure nothing was applied — all host-side verification
        precedes the first mutation, and the app's restore contract
        (abci/types.py) requires it to validate the payload against the
        verified (height, app_hash) before mutating in turn. `seed=False`
        applies the app only (a delta chain seeds store/state from its
        FINAL link — restore_chain)."""
        if manifest.kind != KIND_FULL:
            raise RestoreError("restore() takes a full snapshot; deltas go "
                               "through restore_delta()")
        t0 = time.perf_counter()
        header_h, header_h1 = self.verify_manifest(manifest)
        self.verify_chunks(manifest, chunks)
        obj = self._parse_payload(manifest, b"".join(chunks))
        state, meta, parts, seen_commit, validators_info = (
            self._verify_host(manifest, obj, header_h, header_h1)
        )
        try:
            app_state = bytes.fromhex(obj["app_state"])
        except (KeyError, TypeError, ValueError) as exc:
            raise RestoreError(f"malformed snapshot payload: {exc}")

        # -- apply: app first, then block store, then state — the state
        # key is what a restarting node loads, so it lands only over a
        # complete seed. The app gets the light-verified (height,
        # app_hash) to gate on: its restore contract (abci/types.py) is
        # to validate the payload against them BEFORE mutating, so a bad
        # app_state refuses with nothing applied or persisted
        info = self.app.info()
        if info.last_block_height == 0:
            try:
                self.app.restore(
                    app_state, height=manifest.height, app_hash=state.app_hash
                )
            except (KeyError, TypeError, ValueError) as exc:
                raise RestoreError(f"app refused the snapshot state: {exc}")
        elif (
            info.last_block_height == manifest.height
            and info.last_block_app_hash == state.app_hash
        ):
            # crash-window recovery: a previous restore persisted the app
            # (PersistentKVStoreApp._save) but died before the block
            # store/state seeded. The app already holds EXACTLY the
            # verified (height, app hash) — skipping the apply and
            # re-seeding the rest is idempotent; refusing would wedge the
            # node behind "needs a fresh app" forever
            logger.info(
                "app already at verified snapshot height %d; resuming the "
                "interrupted seed", manifest.height,
            )
        else:
            raise RestoreError(
                f"app already at height {info.last_block_height}; restore "
                "needs a fresh app"
            )
        info = self.app.info()
        if info.last_block_height != manifest.height:
            raise RestoreError(
                f"app restored to height {info.last_block_height}, "
                f"snapshot is {manifest.height}"
            )
        if info.last_block_app_hash != state.app_hash:
            raise RestoreError("restored app hash does not match verified state")

        if seed:
            self._seed(state, meta, parts, seen_commit, validators_info)

        self.restored_height = manifest.height
        self.restore_seconds = round(time.perf_counter() - t0, 4)
        logger.info(
            "restored snapshot at height %d: %d chunk(s), app hash %s (%.0f ms)",
            manifest.height, manifest.chunks,
            state.app_hash.hex()[:12], self.restore_seconds * 1000,
        )
        return state

    # -- delta restore (docs/state-tree.md) ----------------------

    def _decode_delta_entries(self, manifest: Manifest, chunks: list[bytes]):
        """Parse + PROVE every entry chunk against the manifest's light-
        bound app hash. Each upsert carries a membership proof for its
        (key, value); each delete an absence proof — so a chunk is
        verified against CONSENSUS the moment it's complete, not after
        the whole snapshot assembles (the trustless-resume property).
        Completeness (no omitted/extra change) is enforced later by the
        app recomputing the tree root. Returns (upserts, deletes)."""
        from tendermint_tpu_torch.merkle.statetree_proof import (
            MAX_PROOF_STEPS,
            ProofStep,
            TreeProof,
        )

        upserts: dict[bytes, bytes] = {}
        deletes: list[bytes] = []
        seen_keys: set[bytes] = set()

        for ci, raw in enumerate(chunks[1:], start=1):
            try:
                grp = json.loads(raw)
            except ValueError as exc:
                raise RestoreError(f"delta chunk {ci} is not valid JSON: {exc}")
            if not isinstance(grp, dict) or grp.get("section") != "delta":
                raise RestoreError(f"delta chunk {ci} malformed")
            sets, dels = grp.get("sets"), grp.get("dels")
            raw_steps = grp.get("steps")
            if (
                not isinstance(sets, list) or not isinstance(dels, list)
                or not isinstance(raw_steps, list)
                or len(raw_steps) > (1 << 16)
            ):
                raise RestoreError(f"delta chunk {ci} malformed")
            try:
                steps = [ProofStep.from_json(s) for s in raw_steps]
            except ValueError as exc:
                raise RestoreError(f"malformed delta proof step: {exc}")

            def decode_proof(key, value, refs):
                # a proof is a bottom-up list of indices into the
                # chunk's shared step table (upper-tree steps dedupe
                # across every entry in the chunk)
                if (
                    not isinstance(refs, list)
                    or len(refs) > MAX_PROOF_STEPS
                    or any(
                        not isinstance(i, int) or isinstance(i, bool)
                        or not 0 <= i < len(steps)
                        for i in refs
                    )
                ):
                    raise RestoreError("malformed delta proof refs")
                return TreeProof(key, value, [steps[i] for i in refs])

            for entry in sets:
                if not isinstance(entry, list) or len(entry) != 3:
                    raise RestoreError("malformed delta upsert entry")
                try:
                    key, value = bytes.fromhex(entry[0]), bytes.fromhex(entry[1])
                except (TypeError, ValueError):
                    raise RestoreError("malformed delta upsert entry")
                proof = decode_proof(key, value, entry[2])
                if not proof.verify(manifest.app_hash):
                    self.delta_proof_failures += 1
                    raise RestoreError(
                        f"delta upsert proof failed against the verified "
                        f"app hash (chunk {ci})"
                    )
                if key in seen_keys:
                    raise RestoreError("duplicate key across delta chunks")
                seen_keys.add(key)
                upserts[key] = value
            for entry in dels:
                if not isinstance(entry, list) or len(entry) != 2:
                    raise RestoreError("malformed delta delete entry")
                try:
                    key = bytes.fromhex(entry[0])
                except (TypeError, ValueError):
                    raise RestoreError("malformed delta delete entry")
                proof = decode_proof(key, None, entry[1])
                if not proof.verify(manifest.app_hash):
                    self.delta_proof_failures += 1
                    raise RestoreError(
                        f"delta absence proof failed against the verified "
                        f"app hash (chunk {ci})"
                    )
                if key in seen_keys:
                    raise RestoreError("duplicate key across delta chunks")
                seen_keys.add(key)
                deletes.append(key)
        return upserts, deletes

    def _check_aux(self, aux, state) -> None:
        """The delta host section's app-private sidecar (e.g. the
        persistent kvstore's validator registry) is NOT covered by the
        tree root — cross-check it against the header-verified validator
        set before the app may apply it."""
        if aux is None:
            return
        if not isinstance(aux, dict):
            raise RestoreError("malformed delta app_aux")
        validators = aux.get("validators")
        if validators is None:
            return
        if not isinstance(validators, dict):
            raise RestoreError("malformed delta app_aux validators")
        try:
            claimed = {
                str(k).upper(): p for k, p in validators.items()
            }
        except (TypeError, ValueError):
            raise RestoreError("malformed delta app_aux validators")
        verified = {
            v.pub_key.raw.hex().upper(): v.voting_power
            for v in state.validators.validators
        }
        if claimed != verified:
            raise RestoreError(
                "delta app_aux validator registry does not match the "
                "header-verified set"
            )

    def restore_delta(self, manifest: Manifest, chunks: list[bytes],
                      seed: bool = True):
        """Advance an already-restored app from manifest.base_height to
        manifest.height by a verified delta. Every entry chunk proves
        its content against the light-bound app hash BEFORE the app
        applies anything, and the app's restore_delta contract re-derives
        the tree root and refuses (rolled back, nothing persisted) on any
        mismatch — an omitted or smuggled change cannot survive."""
        if manifest.kind != KIND_DELTA:
            raise RestoreError("restore_delta() takes a delta snapshot")
        t0 = time.perf_counter()
        header_h, header_h1 = self.verify_manifest(manifest)
        self.verify_chunks(manifest, chunks)
        if not chunks or sum(len(c) for c in chunks) != manifest.total_bytes:
            raise RestoreError("delta chunk bytes do not match the manifest")
        try:
            host = json.loads(chunks[0])
        except ValueError as exc:
            raise RestoreError(f"delta host section is not valid JSON: {exc}")
        if (
            not isinstance(host, dict)
            or host.get("format") != manifest.format
            or host.get("kind") != "delta"
            or host.get("section") != "host"
        ):
            raise RestoreError("delta host section malformed")
        if (
            host.get("height") != manifest.height
            or host.get("chain_id") != manifest.chain_id
            or host.get("base_height") != manifest.base_height
        ):
            raise RestoreError("delta host section contradicts the manifest")
        state, meta, parts, seen_commit, validators_info = (
            self._verify_host(manifest, host, header_h, header_h1)
        )
        upserts, deletes = self._decode_delta_entries(manifest, chunks)
        aux = host.get("app_aux")
        self._check_aux(aux, state)

        info = self.app.info()
        if (
            info.last_block_height == manifest.height
            and info.last_block_app_hash == state.app_hash
        ):
            # crash-window / chain-resume: this delta already applied
            # and persisted; re-seeding the rest is idempotent
            logger.info(
                "app already at verified delta height %d; resuming",
                manifest.height,
            )
        elif info.last_block_height != manifest.base_height:
            raise RestoreError(
                f"stale delta: app at height {info.last_block_height}, "
                f"delta bases on {manifest.base_height}"
            )
        else:
            apply = getattr(self.app, "restore_delta", None)
            if apply is None:
                raise RestoreError(
                    f"{type(self.app).__name__} cannot apply delta snapshots"
                )
            try:
                apply(upserts, deletes, manifest.height, state.app_hash, aux=aux)
            except (KeyError, TypeError, ValueError) as exc:
                raise RestoreError(f"app refused the delta: {exc}")
        info = self.app.info()
        if (
            info.last_block_height != manifest.height
            or info.last_block_app_hash != state.app_hash
        ):
            raise RestoreError("delta apply did not land on the verified state")

        if seed:
            self._seed(state, meta, parts, seen_commit, validators_info)

        self.deltas_applied += 1
        self.delta_entries_applied += len(upserts) + len(deletes)
        self.restored_height = manifest.height
        self.restore_seconds = round(time.perf_counter() - t0, 4)
        logger.info(
            "applied delta %d -> %d: %d upsert(s), %d delete(s) (%.0f ms)",
            manifest.base_height, manifest.height, len(upserts), len(deletes),
            self.restore_seconds * 1000,
        )
        return state

    def restore_step(self, manifest: Manifest, chunks: list[bytes],
                     seed: bool = True):
        """One link of a snapshot chain: full or delta by manifest kind."""
        if manifest.kind == KIND_DELTA:
            return self.restore_delta(manifest, chunks, seed=seed)
        return self.restore(manifest, chunks, seed=seed)

    def restore_chain(self, items: list[tuple[Manifest, list[bytes]]]):
        """Restore a full-then-deltas chain (ascending heights, each
        delta basing on the previous link). Only the FINAL link seeds the
        block store and state DB — intermediate links advance the app
        only. Links the app already passed (a crashed earlier run — the
        app persists per link) are skipped; any divergence a skip could
        hide is caught by the next delta's base check and root equality."""
        if not items:
            raise RestoreError("empty snapshot chain")
        for (prev, _), (cur, _) in zip(items, items[1:]):
            if cur.kind != KIND_DELTA or cur.base_height != prev.height:
                raise RestoreError("snapshot chain links do not connect")
        app_h = self.app.info().last_block_height
        resumable = app_h in {m.height for m, _ in items}
        state = None
        for i, (manifest, chunks) in enumerate(items):
            last = i == len(items) - 1
            if not last and resumable and app_h >= manifest.height:
                logger.info(
                    "skipping chain link %d (app already at %d)",
                    manifest.height, app_h,
                )
                continue
            state = self.restore_step(manifest, chunks, seed=last)
        return state

    def stats(self) -> dict:
        return {
            "chunks_verified": self.chunks_verified,
            "chunk_digest_failures": self.chunk_digest_failures,
            "restored_height": self.restored_height,
            "restore_seconds": self.restore_seconds,
            "deltas_applied": self.deltas_applied,
            "delta_entries_applied": self.delta_entries_applied,
            "delta_proof_failures": self.delta_proof_failures,
        }
