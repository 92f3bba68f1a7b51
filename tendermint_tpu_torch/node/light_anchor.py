"""Persisted light-client trust anchor (docs/localnet.md §
Trust anchor).

A statesync restore ends with the light client's trust walked to the
restored height — state that previously lived only in memory. A node
that restored at height H, crashed, wiped its data dir, and restored
again would re-anchor at the OPERATOR's pinned `statesync.trust_height`
(often genesis), re-walking — and re-trusting — the whole range it had
already verified. Persisting the anchor in the node home closes that
regression window: the next restore starts its light walk from the
deepest height this home ever verified.

Format: one JSON file at `<home>/data/light_anchor.json` holding
{chain_id, height, validators, header}. The validators are the set
trusted AT that height (what LightClient needs to resume); the header
is the last fully verified one so validator-set changes after a restart
stay chain-linked (rpc/light.py advance() condition (c)). Writes are
atomic (tmp + rename) and best-effort — losing the anchor only costs a
re-walk, never safety. Loads are strict: a chain-id mismatch or any
malformed field returns None (the caller falls back to configured
trust) rather than seeding trust from a corrupt file.
"""

from __future__ import annotations

import json
import logging
import os

logger = logging.getLogger("node.light_anchor")

ANCHOR_FILE = os.path.join("data", "light_anchor.json")


def anchor_path(root_dir: str) -> str:
    return os.path.join(root_dir, ANCHOR_FILE)


def save_anchor(root_dir: str, light_client) -> bool:
    """Persist `light_client`'s trust state under `root_dir`. Returns
    True on write. NEVER raises — the caller is the statesync completion
    path, and a full disk must not wedge the fast-sync handoff."""
    if not root_dir or light_client is None or light_client.height < 1:
        return False
    try:
        header = light_client.trusted_header()
        doc = {
            "chain_id": light_client.chain_id,
            "height": light_client.height,
            "validators": light_client.validators.to_json(),
            "header": header.to_json() if header is not None else None,
        }
        path = anchor_path(root_dir)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return True
    except Exception:  # noqa: BLE001 — anchor loss costs a re-walk only
        logger.exception("failed to persist light-client trust anchor")
        return False


def load_anchor(root_dir: str, chain_id: str):
    """The persisted anchor for `chain_id`, as
    (height, ValidatorSet, Header | None) — or None when absent, for a
    different chain, or malformed (strict: corrupt trust state must not
    seed a light client)."""
    from tendermint_tpu_torch.types.block import Header
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    if not root_dir:
        return None
    try:
        with open(anchor_path(root_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    try:
        if doc.get("chain_id") != chain_id:
            logger.warning(
                "light anchor is for chain %r (this node runs %r); ignoring",
                doc.get("chain_id"), chain_id,
            )
            return None
        height = doc["height"]
        if not isinstance(height, int) or isinstance(height, bool) or height < 1:
            return None
        validators = ValidatorSet.from_json(doc["validators"])
        header = None
        if doc.get("header") is not None:
            header = Header.from_json(doc["header"])
            if header.height != height or header.chain_id != chain_id:
                return None
            # the persisted header must be signed by the persisted set —
            # a file whose parts disagree is corrupt, not trustworthy
            if header.validators_hash != validators.hash():
                return None
        return height, validators, header
    except (KeyError, TypeError, ValueError):
        logger.warning("malformed light anchor at %s; ignoring",
                       anchor_path(root_dir))
        return None
