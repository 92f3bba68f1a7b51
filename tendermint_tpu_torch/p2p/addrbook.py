"""Address book for peer discovery (reference: p2p/addrbook.go).

btcd-style bucketed book: addresses live in "new" buckets (heard about,
never connected) or "old" buckets (connected successfully). Bucket
placement is keyed by a salted hash of (address group, source group) so an
attacker feeding addresses can't fill every bucket. pick_address biases
between new/old; mark_good promotes, mark_attempt counts failures.
Persisted as JSON with periodic saves (addrbook.go:160-182).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time

from tendermint_tpu_torch.libs.service import BaseService
from tendermint_tpu_torch.p2p.netaddress import NetAddress

NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
BUCKET_SIZE = 64
NEW_BUCKETS_PER_ADDRESS = 4
OLD_BUCKETS_PER_GROUP = 4  # informational; enforcement is per-address here
DEFAULT_SAVE_INTERVAL = 120.0
# is_bad() thresholds (addrbook.go isBad/expireNew criteria)
MAX_FAILURES = 3  # never-succeeded attempts before an address is bad
STALE_AFTER = 30 * 24 * 3600.0  # not heard from in 30 days
RECENT_ATTEMPT = 60.0  # just-tried addresses aren't judged yet
NEED_ADDRESS_THRESHOLD = 1000  # below this the book wants more (PEX asks)


class KnownAddress:
    def __init__(self, addr: NetAddress, src: NetAddress):
        self.addr = addr
        self.src = src
        self.attempts = 0
        self.added = time.time()
        self.last_attempt = 0.0
        self.last_success = 0.0
        self.bucket_type = "new"
        self.buckets: list[int] = []

    def is_old(self) -> bool:
        return self.bucket_type == "old"

    def is_bad(self, now: float | None = None) -> bool:
        """Eviction/skip criteria (addrbook.go isBad): an address is bad if
        it keeps failing without ever having worked, or nothing has been
        heard from it in STALE_AFTER. Old (proven) addresses and ones tried
        within the last minute are never judged bad."""
        if self.is_old():
            return False
        now = time.time() if now is None else now
        if self.last_attempt and now - self.last_attempt < RECENT_ATTEMPT:
            return False
        if self.attempts >= MAX_FAILURES and not self.last_success:
            return True
        last_seen = max(self.added, self.last_attempt, self.last_success)
        return now - last_seen > STALE_AFTER

    def to_json(self) -> dict:
        return {
            "addr": str(self.addr),
            "src": str(self.src),
            "attempts": self.attempts,
            "added": self.added,
            "last_attempt": self.last_attempt,
            "last_success": self.last_success,
            "bucket_type": self.bucket_type,
        }

    @classmethod
    def from_json(cls, o: dict) -> "KnownAddress":
        ka = cls(NetAddress.from_string(o["addr"]), NetAddress.from_string(o["src"]))
        ka.attempts = o.get("attempts", 0)
        ka.added = o.get("added", ka.added)
        ka.last_attempt = o.get("last_attempt", 0.0)
        ka.last_success = o.get("last_success", 0.0)
        ka.bucket_type = o.get("bucket_type", "new")
        return ka


def _group(addr: NetAddress) -> str:
    """/16 group for IPv4, string ip otherwise (addrbook.go groupKey)."""
    parts = addr.ip.split(".")
    if len(parts) == 4:
        return ".".join(parts[:2])
    return addr.ip


class AddrBook(BaseService):
    def __init__(self, file_path: str = "", routability_strict: bool = True):
        super().__init__(name="p2p.addrbook")
        self.file_path = file_path
        self.routability_strict = routability_strict
        self.key = os.urandom(24).hex()  # bucket-hash salt
        self._mtx = threading.Lock()
        self._addrs: dict[str, KnownAddress] = {}
        self._new: list[dict[str, KnownAddress]] = [
            {} for _ in range(NEW_BUCKET_COUNT)
        ]
        self._old: list[dict[str, KnownAddress]] = [
            {} for _ in range(OLD_BUCKET_COUNT)
        ]
        self._rng = random.Random()
        self.save_interval = DEFAULT_SAVE_INTERVAL
        # churn accounting (scrape-visible as p2p_addrbook_*):
        # evictions = entries expired out of full new buckets (the
        # group-domination containment actually firing), bad_dropped =
        # addresses removed via mark_bad (flooders, provably-theirs only)
        self.evictions = 0
        self.bad_dropped = 0
        if file_path and os.path.exists(file_path):
            self._load(file_path)

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        t = threading.Thread(target=self._save_routine, daemon=True, name="addrbook.save")
        t.start()

    def on_stop(self) -> None:
        self.save()

    def _save_routine(self) -> None:
        while not self.quit_event.wait(self.save_interval):
            self.save()

    # -- hashing -----------------------------------------------------------

    def _bucket_index(self, addr: NetAddress, src: NetAddress, which: str, n: int) -> int:
        h = hashlib.sha256(
            f"{self.key}:{which}:{_group(addr)}:{_group(src)}:{n}".encode()
        ).digest()
        count = NEW_BUCKET_COUNT if which == "new" else OLD_BUCKET_COUNT
        return int.from_bytes(h[:8], "big") % count

    # -- mutation ----------------------------------------------------------

    def _routable_ok(self, addr: NetAddress) -> bool:
        if not addr.valid():
            return False
        return addr.routable() or not self.routability_strict

    def add_address(self, addr: NetAddress, src: NetAddress) -> bool:
        with self._mtx:
            return self._add(addr, src)

    def _add(self, addr: NetAddress, src: NetAddress) -> bool:
        if not self._routable_ok(addr):
            return False
        key = str(addr)
        ka = self._addrs.get(key)
        if ka is not None:
            if ka.is_old():
                return False
            if len(ka.buckets) >= NEW_BUCKETS_PER_ADDRESS:
                return False
            # probabilistically avoid piling one address into many buckets
            if self._rng.random() > 1.0 / (2 ** len(ka.buckets)):
                return False
        else:
            ka = KnownAddress(addr, src)
            self._addrs[key] = ka
        for n in range(NEW_BUCKETS_PER_ADDRESS):
            idx = self._bucket_index(addr, src, "new", n)
            if idx in ka.buckets:
                continue
            bucket = self._new[idx]
            if len(bucket) >= BUCKET_SIZE:
                self._expire_one(bucket)
            bucket[key] = ka
            ka.buckets.append(idx)
            return True
        return False

    def _expire_one(self, bucket: dict[str, KnownAddress]) -> None:
        """Evict from a full new bucket: a bad entry if any (addrbook.go
        expireNew), else the stalest."""
        now = time.time()
        victim_key = next(
            (k for k, ka in bucket.items() if ka.is_bad(now)), None
        ) or min(
            bucket, key=lambda k: (bucket[k].last_success, -bucket[k].attempts)
        )
        victim = bucket.pop(victim_key)
        victim.buckets = [b for b in victim.buckets if bucket is not self._new[b]]
        if not victim.buckets and not victim.is_old():
            self._addrs.pop(victim_key, None)
        self.evictions += 1

    def remove_address(self, addr: NetAddress) -> None:
        with self._mtx:
            key = str(addr)
            ka = self._addrs.pop(key, None)
            if ka is None:
                return
            for buckets in (self._new, self._old):
                for b in buckets:
                    b.pop(key, None)

    def mark_attempt(self, addr: NetAddress) -> None:
        with self._mtx:
            ka = self._addrs.get(str(addr))
            if ka:
                ka.attempts += 1
                ka.last_attempt = time.time()

    def mark_bad(self, addr: NetAddress) -> None:
        """Drop a misbehaving peer's address (addrbook.go MarkBad — which
        the reference also implements as removal)."""
        if str(addr) in self._addrs:
            self.bad_dropped += 1
        self.remove_address(addr)

    def mark_good(self, addr: NetAddress) -> None:
        """Promote new -> old on successful connection (addrbook.go:393)."""
        with self._mtx:
            key = str(addr)
            ka = self._addrs.get(key)
            if ka is None:
                if not self._add(addr, addr):
                    return
                ka = self._addrs.get(key)
                if ka is None:
                    return
            ka.attempts = 0
            ka.last_success = time.time()
            if ka.is_old():
                return
            for idx in ka.buckets:
                self._new[idx].pop(key, None)
            ka.buckets = []
            ka.bucket_type = "old"
            idx = self._bucket_index(ka.addr, ka.src, "old", 0)
            bucket = self._old[idx]
            if len(bucket) >= BUCKET_SIZE:
                # demote the stalest old entry back to new
                demote_key = min(bucket, key=lambda k: bucket[k].last_success)
                demoted = bucket.pop(demote_key)
                demoted.bucket_type = "new"
                demoted.buckets = []
                self._addrs[demote_key] = demoted
                self._add(demoted.addr, demoted.src)
            bucket[key] = ka
            ka.buckets = [idx]

    # -- queries -----------------------------------------------------------

    def size(self) -> int:
        with self._mtx:
            return len(self._addrs)

    def stats(self) -> dict:
        """Scrape-surface shape of the book (node/telemetry.py exports
        these as p2p_addrbook_*): size split new/old, churn counters,
        and max_group — how many entries the single most-populated
        address group holds. Bucket hashing caps any one group at
        NEW_BUCKETS_PER_ADDRESS buckets, so a subnet flooding ~500
        addresses can never own more than 4*BUCKET_SIZE slots; this
        gauge is the operator's read on that containment."""
        with self._mtx:
            old = sum(1 for ka in self._addrs.values() if ka.is_old())
            groups: dict[str, int] = {}
            for ka in self._addrs.values():
                g = _group(ka.addr)
                groups[g] = groups.get(g, 0) + 1
            return {
                "size": len(self._addrs),
                "new": len(self._addrs) - old,
                "old": old,
                "max_group": max(groups.values()) if groups else 0,
                "evictions": self.evictions,
                "bad_dropped": self.bad_dropped,
            }

    def need_more_addrs(self) -> bool:
        """Should PEX keep soliciting addresses? (addrbook.go
        NeedMoreAddrs: size < 1000)."""
        return self.size() < NEED_ADDRESS_THRESHOLD

    def our_addresses(self) -> set[str]:
        return getattr(self, "_ours", set())

    def add_our_address(self, addr: NetAddress) -> None:
        self._ours = self.our_addresses() | {str(addr)}

    def pick_address(self, new_bias_pct: int = 30) -> NetAddress | None:
        """Random pick, biased between old/new (addrbook.go PickAddress)."""
        with self._mtx:
            if not self._addrs:
                return None
            now = time.time()
            olds = [ka for ka in self._addrs.values() if ka.is_old()]
            news_all = [ka for ka in self._addrs.values() if not ka.is_old()]
            # prefer not-bad new addresses, but never strand the node: if
            # everything new looks bad (e.g. after an outage burned 3
            # attempts on every address) fall back to retrying them — the
            # reference uses isBad only for bucket eviction for the same
            # reason (addrbook.go expireNew vs PickAddress)
            news = [ka for ka in news_all if not ka.is_bad(now)] or news_all
            pool = news if (self._rng.random() * 100 < new_bias_pct or not olds) else olds
            if not pool:
                pool = olds or news
            return self._rng.choice(pool).addr if pool else None

    def get_selection(self, max_count: int = 250) -> list[NetAddress]:
        """Random 23% (<=max_count) of known addrs, for PEX responses."""
        with self._mtx:
            addrs = [ka.addr for ka in self._addrs.values()]
        self._rng.shuffle(addrs)
        want = min(max_count, max(len(addrs) * 23 // 100, min(len(addrs), 8)))
        return addrs[:want]

    # -- persistence -------------------------------------------------------

    def save(self) -> None:
        if not self.file_path:
            return
        with self._mtx:
            data = {
                "key": self.key,
                "addrs": [ka.to_json() for ka in self._addrs.values()],
            }
        tmp = self.file_path + ".tmp"
        os.makedirs(os.path.dirname(self.file_path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.file_path)

    def _load(self, path: str) -> None:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        self.key = data.get("key", self.key)
        for o in data.get("addrs", []):
            try:
                ka = KnownAddress.from_json(o)
            except (KeyError, ValueError):
                continue
            if ka.is_old():
                idx = self._bucket_index(ka.addr, ka.src, "old", 0)
                self._old[idx][str(ka.addr)] = ka
                ka.buckets = [idx]
                self._addrs[str(ka.addr)] = ka
            else:
                # new entries re-enter through the REAL add path so the
                # bucket-capacity invariants hold on load too: a saved
                # book dominated by one subnet (or a crafted file) gets
                # the same group containment a live flood would —
                # overflow evicts inside the group's few buckets instead
                # of accumulating bucket-less forever-unevictable
                # entries in _addrs
                if not self._add(ka.addr, ka.src):
                    continue
                got = self._addrs.get(str(ka.addr))
                if got is not None:
                    got.attempts = ka.attempts
                    got.added = ka.added
                    got.last_attempt = ka.last_attempt
                    got.last_success = ka.last_success
