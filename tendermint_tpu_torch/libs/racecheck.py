"""Lock-order race/deadlock instrumentation — the framework's analogue of
the reference's race discipline (Go `-race` in CI, Makefile:31-34, plus the
single receiveRoutine owning RoundState, consensus/state.go:604-608).

Python's GIL hides data races Go's detector would catch, but the failure
mode that actually bites a threaded BFT node is the same one `-race`'s
happens-before graph encodes: inconsistent lock acquisition order across
threads (deadlock potential) and re-entering a non-reentrant lock. This
module instruments `threading.Lock`/`RLock` construction so a test tier —
or a live node run with TENDERMINT_RACECHECK=1 — records the process-wide
lock-order graph and reports:

- **order inversions**: thread T1 acquires site A then B while T2 acquires
  B then A — a cycle in the site graph == a latent deadlock;
- **self-deadlock**: a plain Lock acquired again by its holding thread
  (raises immediately instead of hanging the process);
- **hot-path discipline**: `assert_owner(obj)` pins a structure to the
  thread that first touched it (the receiveRoutine discipline).

Sites are keyed by the lock's construction call-site (file:line), so every
`ConsensusState` instance shares one node in the graph and cross-instance
ordering is checked structurally, not per-object. Limitation: two
same-site locks (e.g. two peers' locks) acquired in opposite orders
collapse to one node and aren't flagged — same-site nesting is exactly the
pattern the per-struct-mutex discipline forbids anyway, so treat any code
that needs to hold two sibling locks as a design smell, not a tooling gap.

Usage:
    mon = racecheck.install()
    ... run threads ...
    mon.check()        # raises LockOrderError on any finding
    racecheck.uninstall()
"""

from __future__ import annotations

import os
import sys
import threading
import traceback

_REPO_PREFIX = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class LockOrderError(AssertionError):
    pass


def _call_site() -> tuple[str, int]:
    """First stack frame outside this module: where the lock was built."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:  # pragma: no cover - defensive
        return ("<unknown>", 0)
    return (f.f_code.co_filename, f.f_lineno)


class Monitor:
    """Shared state for one install() window."""

    def __init__(self) -> None:
        self._mtx = threading.Lock()
        # site -> set of sites acquired while holding it
        self.edges: dict[tuple, set[tuple]] = {}
        # (a, b) -> formatted stack captured when the edge first appeared
        self.edge_stacks: dict[tuple, str] = {}
        self.violations: list[str] = []
        self._tls = threading.local()

    # -- per-thread held stack --------------------------------------------

    def _held(self) -> list:
        try:
            return self._tls.held
        except AttributeError:
            self._tls.held = []
            return self._tls.held

    def on_acquire(
        self, lock_id: int, site: tuple, reentrant: bool, blocking: bool = True
    ) -> None:
        held = self._held()
        if reentrant and any(lid == lock_id for lid, _ in held):
            # RLock re-entry never blocks, so it can neither deadlock nor
            # impose ordering — recording an edge here would report a
            # phantom cycle for `with r: with b: with r:` patterns
            held.append((lock_id, site))
            return
        if blocking and not reentrant and any(lid == lock_id for lid, _ in held):
            msg = (
                f"self-deadlock: non-reentrant Lock from {site[0]}:{site[1]} "
                f"re-acquired by its holding thread "
                f"{threading.current_thread().name}\n"
                + "".join(traceback.format_stack(limit=12))
            )
            with self._mtx:
                self.violations.append(msg)
            raise LockOrderError(msg)
        new_edges = []
        if blocking:  # a try-acquire never blocks, so it can't deadlock
            for _lid, held_site in held:
                if held_site != site:
                    new_edges.append((held_site, site))
        if new_edges:
            with self._mtx:
                for a, b in new_edges:
                    if b not in self.edges.setdefault(a, set()):
                        self.edges[a].add(b)
                        self.edge_stacks[(a, b)] = "".join(
                            traceback.format_stack(limit=10)
                        )
        held.append((lock_id, site))

    def on_release(self, lock_id: int) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == lock_id:
                del held[i]
                return

    # -- reporting ---------------------------------------------------------

    def _in_repo(self, site: tuple) -> bool:
        return site[0].startswith(_REPO_PREFIX)

    def cycles(self, repo_only: bool = True) -> list[list[tuple]]:
        """Cycles in the lock-order graph (each is a latent deadlock)."""
        with self._mtx:
            edges = {a: set(bs) for a, bs in self.edges.items()}
        if repo_only:
            edges = {
                a: {b for b in bs if self._in_repo(b)}
                for a, bs in edges.items()
                if self._in_repo(a)
            }
        # Tarjan-free: iterative DFS three-color cycle extraction
        WHITE, GRAY, BLACK = 0, 1, 2
        color = dict.fromkeys(edges, WHITE)
        found: list[list[tuple]] = []
        for root in edges:
            if color.get(root, WHITE) != WHITE:
                continue
            stack = [(root, iter(edges.get(root, ())))]
            color[root] = GRAY
            path = [root]
            while stack:
                node, it = stack[-1]
                adv = False
                for nxt in it:
                    c = color.get(nxt, WHITE)
                    if c == GRAY:
                        found.append(path[path.index(nxt):] + [nxt])
                    elif c == WHITE:
                        color[nxt] = GRAY
                        path.append(nxt)
                        stack.append((nxt, iter(edges.get(nxt, ()))))
                        adv = True
                        break
                if not adv:
                    color[node] = BLACK
                    path.pop()
                    stack.pop()
        return found

    def check(self, repo_only: bool = True) -> None:
        """Raise LockOrderError on any recorded violation or order cycle."""
        with self._mtx:
            viols = list(self.violations)
        cyc = self.cycles(repo_only=repo_only)
        if not viols and not cyc:
            return
        parts = viols[:]
        for c in cyc:
            desc = " -> ".join(f"{os.path.relpath(f, _REPO_PREFIX)}:{l}" for f, l in c)
            stacks = ""
            for a, b in zip(c, c[1:]):
                s = self.edge_stacks.get((a, b))
                if s:
                    stacks += f"\n  edge {a[0]}:{a[1]} -> {b[0]}:{b[1]} first seen:\n{s}"
            parts.append(f"lock-order cycle (latent deadlock): {desc}{stacks}")
        raise LockOrderError("\n\n".join(parts))

    def report(self) -> str:
        """Human summary (logged by the node at shutdown under
        TENDERMINT_RACECHECK=1)."""
        with self._mtx:
            n_sites = len(
                {s for a, bs in self.edges.items() for s in (a, *bs)}
            )
            n_edges = sum(len(bs) for bs in self.edges.values())
            viols = len(self.violations)
        cyc = self.cycles()
        return (
            f"racecheck: {n_sites} lock sites, {n_edges} order edges, "
            f"{len(cyc)} cycles, {viols} violations"
            + ("" if not cyc else f"; FIRST CYCLE: {cyc[0]}")
        )


class _TracedLock:
    """Wraps a real lock; reports acquire/release order to the Monitor."""

    __slots__ = ("_lock", "_mon", "_site", "_reentrant")

    def __init__(self, real, mon: Monitor, reentrant: bool):
        self._lock = real
        self._mon = mon
        self._site = _call_site()
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1):
        # order is recorded before blocking so a true deadlock still leaves
        # the inversion in the graph for the post-mortem
        self._mon.on_acquire(
            id(self), self._site, self._reentrant, blocking=bool(blocking)
        )
        ok = self._lock.acquire(blocking, timeout)
        if not ok:
            self._mon.on_release(id(self))
        return ok

    def release(self):
        self._lock.release()
        self._mon.on_release(id(self))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()

    # threading.Condition integration: delegate the private protocol so a
    # Condition built on a traced RLock keeps exact ownership semantics.
    # _release_save drops every recursion level at once, so pop ALL held
    # entries for this lock; _acquire_restore re-enters as one entry.
    def _is_owned(self):
        if hasattr(self._lock, "_is_owned"):
            return self._lock._is_owned()
        # plain Lock: probe directly (bypassing the monitor — a probe is
        # not an ordering event), mirroring Condition's fallback
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def _release_save(self):
        if hasattr(self._lock, "_release_save"):
            state = self._lock._release_save()
            held = self._mon._held()
            held[:] = [(lid, s) for lid, s in held if lid != id(self)]
            return state
        self.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._lock, "_acquire_restore"):
            self._lock._acquire_restore(state)
            self._mon.on_acquire(id(self), self._site, True)
        else:
            self.acquire()

    def _at_fork_reinit(self):  # pragma: no cover - fork support
        self._lock._at_fork_reinit()


_installed: Monitor | None = None
_orig_lock = threading.Lock
_orig_rlock = threading.RLock


def install() -> Monitor:
    """Patch threading.Lock/RLock to traced versions. Locks created BEFORE
    install are untouched (stdlib internals stay fast); only code paths
    constructing locks inside the window are instrumented."""
    global _installed
    if _installed is not None:
        return _installed
    mon = Monitor()

    def make_lock():
        return _TracedLock(_orig_lock(), mon, reentrant=False)

    def make_rlock():
        return _TracedLock(_orig_rlock(), mon, reentrant=True)

    threading.Lock = make_lock  # type: ignore[assignment]
    threading.RLock = make_rlock  # type: ignore[assignment]
    _installed = mon
    return mon


def uninstall() -> None:
    global _installed
    threading.Lock = _orig_lock  # type: ignore[assignment]
    threading.RLock = _orig_rlock  # type: ignore[assignment]
    _installed = None


def monitor() -> Monitor | None:
    return _installed


# -- thread-affinity assertion (receiveRoutine discipline) -------------------

_affinity: dict[int, tuple[str, str]] = {}
_aff_mtx = _orig_lock()


def assert_owner(obj, label: str = "") -> None:
    """Assert `obj` is only touched by the thread that first touched it —
    the single-receive-routine ownership discipline the reference leans on
    for RoundState. No-op cost is one dict lookup; call it at the top of
    methods that must stay on the owner thread."""
    me = threading.current_thread().name
    key = id(obj)
    with _aff_mtx:
        prev = _affinity.get(key)
        if prev is None:
            _affinity[key] = (me, label)
            return
    if prev[0] != me:
        raise LockOrderError(
            f"thread-affinity violation: {label or type(obj).__name__} "
            f"owned by thread {prev[0]!r} touched from {me!r}"
        )


def reset_affinity() -> None:
    with _aff_mtx:
        _affinity.clear()
