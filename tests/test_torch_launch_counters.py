"""The kernel wrappers' launch counts hold under concurrent launches.

The device daemon serves each connection on a thread of its own, all
launching through the same wrappers, so a count is shared between
threads. Every wrapper counts through `ops.kernels.count_launch`, which
takes one lock: 16 threads bumping a counter at a 1 us switch interval
lose no count, and no wrapper increments its counter any other way."""

from __future__ import annotations

import ast
import importlib
import inspect
import sys
import threading

import pytest

from tendermint_tpu_torch.ops import kernels

THREADS, CALLS = 16, 2000


@pytest.mark.parametrize("key", sorted(kernels.LAUNCH_COUNTERS))
def test_counts_hold_under_a_thread_storm(monkeypatch, key):
    module, attr = kernels.LAUNCH_COUNTERS[key]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, 0)
    start = threading.Barrier(THREADS)

    def bump() -> None:
        start.wait()
        for _ in range(CALLS):
            kernels.count_launch(module, attr)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert getattr(mod, attr) == THREADS * CALLS
    assert kernels.launch_counts()[key] == THREADS * CALLS


def _counting_calls(mod) -> tuple[set[str], list[str]]:
    """The counter attributes a module passes to kernels.count_launch, and
    every augmented assignment to a module-level name ending in
    `launches`."""
    tree = ast.parse(inspect.getsource(mod))
    counted, bare = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "count_launch":
            if len(node.args) < 2:
                counted.add("launches")
            elif isinstance(node.args[1], ast.Constant):
                counted.add(node.args[1].value)
            elif isinstance(node.args[1], ast.IfExp):
                counted |= {node.args[1].body.value, node.args[1].orelse.value}
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name) \
                and node.target.id.endswith("launches"):
            bare.append(node.target.id)
    return counted, bare


def test_every_wrapper_counts_through_the_lock():
    by_module: dict[str, set[str]] = {}
    for module, attr in kernels.LAUNCH_COUNTERS.values():
        by_module.setdefault(module, set()).add(attr)
    for module, attrs in by_module.items():
        counted, bare = _counting_calls(importlib.import_module(module))
        assert counted == attrs, module
        assert bare == [], f"{module} increments {bare} outside count_launch"
