"""The port's telemetry plane (libs/telemetry.py) and the consensus
trace's TraceRecorder (consensus/trace.py) on the cases
of tests/test_telemetry.py; the last two cases hold the port's scrape
text, flat map and traces against the JAX package's on the same
operations."""

from __future__ import annotations

import math
import re
import threading

import pytest

from tendermint_tpu_torch.libs import telemetry
from tendermint_tpu_torch.libs.telemetry import (
    Registry,
    log_buckets,
)


@pytest.fixture()
def reg():
    return Registry()


# -- instruments ---------------------------------------------------------------


class TestCounter:
    def test_inc_and_value(self, reg):
        c = reg.counter("c_total", "help")
        c.inc()
        c.inc(5)
        assert c.value == 6

    def test_negative_inc_rejected(self, reg):
        c = reg.counter("c_total")
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_create_or_get_same_instance(self, reg):
        assert reg.counter("c_total") is reg.counter("c_total")

    def test_type_conflict_fails_loudly(self, reg):
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x")

    def test_concurrent_increments_lose_nothing(self, reg):
        c = reg.counter("c_total")
        n_threads, n_incs = 8, 2000

        def work():
            for _ in range(n_incs):
                c.inc()

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value == n_threads * n_incs


class TestGauge:
    def test_set_inc_dec(self, reg):
        g = reg.gauge("g")
        g.set(10)
        g.inc(2.5)
        g.dec()
        assert g.value == 11.5

    def test_callback_gauge(self, reg):
        box = {"v": 3}
        g = reg.gauge("g_fn", fn=lambda: box["v"])
        assert g.value == 3
        box["v"] = 7
        assert g.value == 7

    def test_callback_gauge_cannot_be_labeled(self, reg):
        with pytest.raises(ValueError):
            reg.gauge("g_bad", labelnames=("a",), fn=lambda: 1)


class TestHistogram:
    def test_log_buckets_shape(self):
        b = log_buckets(0.001, 1.0, 1)
        assert b == (0.001, 0.01, 0.1, 1.0)
        b4 = log_buckets(1e-4, 30.0, 4)
        assert b4[0] == 1e-4 and b4[-1] >= 30.0
        assert list(b4) == sorted(b4)

    def test_bad_bucket_spec_rejected(self):
        with pytest.raises(ValueError):
            log_buckets(0, 1, 4)
        with pytest.raises(ValueError):
            log_buckets(1, 1, 4)

    def test_observe_lands_in_bucket(self, reg):
        h = reg.histogram("h_seconds", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v)
        child = h._own()
        assert child.counts == [1, 2, 1, 1]  # last = +Inf bucket
        assert child.count == 5
        assert child.sum == pytest.approx(56.05)

    def test_boundary_value_counts_in_its_le_bucket(self, reg):
        # Prometheus le is INCLUSIVE: observe(0.1) must count under
        # le="0.1"
        h = reg.histogram("h_edge", buckets=(0.1, 1.0))
        h.observe(0.1)
        assert h._own().counts == [1, 0, 0]

    def test_quantile_approximation(self, reg):
        h = reg.histogram("h_q", buckets=(1.0, 2.0, 4.0, 8.0))
        for v in [0.5] * 50 + [3.0] * 49 + [7.0]:
            h.observe(v)
        assert h.quantile(0.5) == 1.0
        assert h.quantile(0.99) == 4.0

    def test_env_tunable_default_buckets(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_TELEMETRY_HIST_MIN_S", "0.01")
        monkeypatch.setenv("TENDERMINT_TELEMETRY_HIST_MAX_S", "1.0")
        monkeypatch.setenv("TENDERMINT_TELEMETRY_HIST_PER_DECADE", "1")
        assert telemetry.default_latency_buckets() == (0.01, 0.1, 1.0)
        # a typo'd knob warns and keeps the default (envknob contract)
        monkeypatch.setenv("TENDERMINT_TELEMETRY_HIST_MIN_S", "oops")
        b = telemetry.default_latency_buckets()
        assert b[0] == 1e-4

    def test_disable_knob_makes_observe_noop(self, reg):
        h = reg.histogram("h_off", buckets=(1.0,))
        c = reg.counter("c_off")
        telemetry.set_enabled(False)
        try:
            h.observe(0.5)
            c.inc()
            # API validation must not depend on the runtime knob: a
            # caller bug crashes identically either way
            with pytest.raises(ValueError):
                c.inc(-1)
        finally:
            telemetry.set_enabled(True)
        assert h.count == 0 and c.value == 0
        h.observe(0.5)
        assert h.count == 1


class TestLabels:
    def test_labeled_series_are_independent(self, reg):
        c = reg.counter("ops_total", labelnames=("op",))
        c.labels(op="verify").inc(3)
        c.labels(op="hash").inc(1)
        assert c.labels(op="verify").value == 3
        assert c.labels(op="hash").value == 1

    def test_wrong_label_names_fail_loudly(self, reg):
        c = reg.counter("ops_total", labelnames=("op",))
        with pytest.raises(KeyError):
            c.labels(kind="verify")
        with pytest.raises(KeyError):
            c.inc()  # labeled family has no unlabeled series

    def test_cardinality_bound_collapses_to_overflow(self, reg):
        c = reg.counter("wide_total", labelnames=("k",), max_series=4)
        for i in range(10):
            c.labels(k=f"v{i}").inc()
        assert c.series_count() <= 5  # 4 + the shared overflow series
        assert c.dropped_series == 6
        # totals survive the collapse
        total = sum(child.value for _k, child in c._items())
        assert total == 10
        assert c.labels(k=telemetry.OVERFLOW_LABEL).value == 6

    def test_cardinality_bound_holds_for_labeled_histograms(self, reg):
        """The _other collapse must bound labeled HISTOGRAMS
        too — a per-peer latency histogram under 100-peer churn stays at
        the series cap, every observation lands somewhere, and the
        overflow child is a real histogram (buckets, sum, count)."""
        h = reg.histogram("peer_lat_seconds", labelnames=("peer",),
                          buckets=(0.1, 1.0), max_series=8)
        for i in range(100):  # 100-peer churn
            h.labels(peer=f"peer{i}").observe(0.5)
        assert h.series_count() <= 9  # 8 + the shared overflow series
        assert h.dropped_series == 100 - 8
        total = sum(child.count for _k, child in h._items())
        assert total == 100, "observations must survive the collapse"
        over = h.labels(peer=telemetry.OVERFLOW_LABEL)
        assert over.count == 92
        counts, total_sum, count = over.snapshot()
        assert counts[1] == 92 and count == 92  # 0.5 -> le=1.0 bucket
        assert total_sum == pytest.approx(92 * 0.5)
        # ... and the rendered exposition stays parseable and bounded
        text = reg.render_prometheus()
        bucket_lines = [l for l in text.splitlines()
                        if l.startswith("peer_lat_seconds_bucket")]
        assert len(bucket_lines) == h.series_count() * 3  # 2 bounds + +Inf

    def test_remove_labels_drops_series_and_frees_slot(self, reg):
        """Staleness cleanup — a removed child vanishes from
        the exposition and its slot counts against the cardinality
        bound again (churned-out peers must disappear, not freeze)."""
        g = reg.gauge("peer_age", labelnames=("peer",), max_series=2)
        g.labels(peer="a").set(1)
        g.labels(peer="b").set(2)
        g.labels(peer="c").set(3)  # over the bound -> _other
        assert g.labels(peer="c") is g.labels(peer=telemetry.OVERFLOW_LABEL)
        g.remove_labels(peer="a")
        assert 'peer="a"' not in reg.render_prometheus()
        # freed slots admit a new real series instead of overflowing
        # (the retained _other series occupies one slot itself)
        g.remove_labels(peer="b")
        g.labels(peer="d").set(4)
        assert g.labels(peer="d") is not g.labels(
            peer=telemetry.OVERFLOW_LABEL
        )
        g.remove_labels(peer="missing")  # no-op
        with pytest.raises(KeyError):
            g.remove_labels(wrong="a")

    def test_per_family_max_series_env_override(self, monkeypatch):
        """TENDERMINT_TELEMETRY_MAX_SERIES_<FAMILY> overrides
        the global bound for one family; a typo'd value keeps the
        default (envknob contract)."""
        monkeypatch.setenv("TENDERMINT_TELEMETRY_MAX_SERIES", "16")
        monkeypatch.setenv(
            "TENDERMINT_TELEMETRY_MAX_SERIES_NARROW_TOTAL", "2"
        )
        reg = Registry()
        narrow = reg.counter("narrow_total", labelnames=("k",))
        wide = reg.counter("other_total", labelnames=("k",))
        for i in range(10):
            narrow.labels(k=f"v{i}").inc()
            wide.labels(k=f"v{i}").inc()
        assert narrow.series_count() <= 3  # 2 + overflow
        assert wide.series_count() == 10   # global 16 still governs
        assert telemetry.family_max_series("narrow_total") == 2
        monkeypatch.setenv(
            "TENDERMINT_TELEMETRY_MAX_SERIES_NARROW_TOTAL", "oops"
        )
        assert telemetry.family_max_series("narrow_total") == 16


# -- registry rendering --------------------------------------------------------


PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"              # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""    # first label
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
    r" [0-9.eE+-]+$|^.* \+Inf$"
)


class TestRegistry:
    def _sample_registry(self):
        reg = Registry()
        reg.counter("reqs_total", "requests").inc(3)
        g = reg.gauge("depth", "queue depth")
        g.set(2)
        h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0),
                          labelnames=("op",))
        h.labels(op="a").observe(0.05)
        h.labels(op="a").observe(0.5)
        reg.register_producer("plane", lambda: {"x": 1, "y": 2.5})
        reg.register_producer("scrapeonly", lambda: {"z": 9}, legacy=False)
        return reg

    def test_flatten_is_legacy_producers_only(self):
        reg = self._sample_registry()
        flat = reg.flatten()
        assert flat == {"plane_x": 1, "plane_y": 2.5}

    def test_producer_replacement_and_unregister(self, reg):
        reg.register_producer("p", lambda: {"a": 1})
        reg.register_producer("p", lambda: {"b": 2})
        assert reg.flatten() == {"p_b": 2}
        reg.unregister_producer("p")
        assert reg.flatten() == {}

    def test_failing_producer_fails_loudly(self, reg):
        """The loud-wiring convention: a renamed attribute (any
        producer exception) surfaces as an RPC error / a 500 scrape —
        never a silently missing plane behind a healthy-looking 200."""
        def boom():
            raise AttributeError("renamed_field")

        reg.register_producer("bad", boom)
        with pytest.raises(AttributeError, match="renamed_field"):
            reg.flatten()
        with pytest.raises(AttributeError, match="renamed_field"):
            reg.render_prometheus()

    def test_failing_callback_gauge_fails_loudly(self, reg):
        reg.gauge("g_bad", fn=lambda: (_ for _ in ()).throw(
            AttributeError("renamed")
        ))
        with pytest.raises(AttributeError):
            reg.render_prometheus()

    def test_prometheus_format_golden(self):
        """A sample scrape parses: HELP/TYPE per family, every sample
        line matches the 0.0.4 grammar, histogram series are cumulative
        and agree with _count."""
        text = self._sample_registry().render_prometheus()
        lines = text.strip().splitlines()
        assert text.endswith("\n")
        fams = {}
        for line in lines:
            if line.startswith("# HELP "):
                continue
            if line.startswith("# TYPE "):
                _, _, name, kind = line.split()
                fams[name] = kind
                continue
            assert PROM_SAMPLE.match(line), line
        assert fams["reqs_total"] == "counter"
        assert fams["depth"] == "gauge"
        assert fams["lat_seconds"] == "histogram"
        assert fams["plane_x"] == "gauge"
        assert fams["scrapeonly_z"] == "gauge"  # scrape-only still scrapes
        # every family has a HELP line preceding its TYPE line
        for name in fams:
            assert any(l.startswith(f"# HELP {name} ") for l in lines), name
        # histogram contract: cumulative buckets, +Inf == count
        buckets = [l for l in lines if l.startswith("lat_seconds_bucket")]
        counts = [float(l.rsplit(" ", 1)[1]) for l in buckets]
        assert counts == sorted(counts)
        inf = next(l for l in buckets if 'le="+Inf"' in l)
        cnt = next(l for l in lines if l.startswith("lat_seconds_count"))
        assert inf.rsplit(" ", 1)[1] == cnt.rsplit(" ", 1)[1] == "2"
        sm = next(l for l in lines if l.startswith("lat_seconds_sum"))
        assert math.isclose(float(sm.rsplit(" ", 1)[1]), 0.55)

    def test_parent_chain_renders_but_does_not_flatten(self):
        parent = Registry()
        parent.counter("proc_total").inc(1)
        parent.register_producer("procplane", lambda: {"v": 7})
        child = Registry(parent=parent)
        child.register_producer("nodeplane", lambda: {"w": 8})
        assert child.flatten() == {"nodeplane_w": 8}
        names = {f.name for f in child.collect()}
        assert {"proc_total", "procplane_v", "nodeplane_w"} <= names

    def test_name_dedup_first_wins(self):
        parent = Registry()
        parent.gauge("dup", fn=lambda: 1)
        child = Registry(parent=parent)
        child.gauge("dup", fn=lambda: 2)
        fams = [f for f in child.collect() if f.name == "dup"]
        assert len(fams) == 1
        assert fams[0].samples[0][2] == 2  # child's own wins

    def test_default_registry_reset_reruns_install_hooks(self):
        calls = []
        telemetry.on_default_registry(
            lambda r: calls.append(r) or r.register_producer(
                "hooked", lambda: {"v": 1}, legacy=False
            )
        )
        assert calls[-1] is telemetry.default_registry()
        fresh = telemetry.reset_default_registry()
        try:
            assert calls[-1] is fresh
            names = {f.name for f in fresh.collect()}
            assert "hooked_v" in names
            # module hooks re-registered too (ops/faults imports in this
            # process via other tests; tolerate either)
        finally:
            telemetry.reset_default_registry()

    def test_sanitize_bad_metric_chars(self):
        reg = Registry()
        reg.register_producer("weird", lambda: {"a-b.c": 1})
        text = reg.render_prometheus()
        assert "weird_a_b_c 1" in text

    def test_on_collect_hook_refreshes_before_instruments_render(self):
        """A pre-collect hook runs before instruments are
        gathered, so a point-in-time labeled gauge (per-peer last-recv
        age) is fresh in the SAME scrape — not one scrape stale."""
        reg = Registry()
        g = reg.gauge("age_seconds", labelnames=("peer",))
        box = {"v": 1.0}
        reg.on_collect(lambda: g.labels(peer="a").set(box["v"]))
        assert 'age_seconds{peer="a"} 1.0' in reg.render_prometheus()
        box["v"] = 2.5
        assert 'age_seconds{peer="a"} 2.5' in reg.render_prometheus()


class TestTraceRecorder:
    """consensus/trace.py: the segment clock partitions wall time."""

    def test_segments_partition_wall_clock(self):
        from tendermint_tpu_torch.consensus.trace import TraceRecorder

        rec = TraceRecorder(device_probe=None, ring=4)
        rec.begin(5, now=100.0)
        rec.mark("propose", now=100.5)
        rec.mark("prevote", now=100.75)
        rec.mark("commit", now=101.0)
        rec.note("part_hash_s", 0.2)
        tr = rec.finish(5, wall_s=1.5, now=101.5)
        assert tr.segments == {
            "new_height": 0.5, "propose": 0.25, "prevote": 0.25,
            "commit": 0.5,
        }
        assert tr.total_s == pytest.approx(1.5)
        assert tr.wall_s == 1.5
        assert tr.aux == {"part_hash_s": 0.2}
        assert rec.last(1)[0] is tr

    def test_ring_bound_and_order(self):
        from tendermint_tpu_torch.consensus.trace import TraceRecorder

        rec = TraceRecorder(ring=3)
        for h in range(6):
            rec.begin(h, now=float(h))
            rec.finish(h, wall_s=1.0, now=float(h) + 1)
        got = [t.height for t in rec.last(10)]
        assert got == [5, 4, 3]  # newest first, ring-bounded

    def test_device_probe_deltas_and_state(self):
        from tendermint_tpu_torch.consensus.trace import TraceRecorder

        probes = iter([
            {"verify_cpu_sigs": 3, "breaker_state": 0},   # constructor
            {"verify_cpu_sigs": 10, "breaker_state": 0},  # begin()
            {"verify_cpu_sigs": 17, "breaker_state": 2},  # finish()
        ])
        rec = TraceRecorder(device_probe=lambda: next(probes), ring=2)
        rec.begin(1, now=0.0)
        tr = rec.finish(1, wall_s=1.0, now=1.0)
        assert tr.device["verify_cpu_sigs"] == 7
        assert tr.device["breaker_state_start"] == 0
        assert tr.device["breaker_state_end"] == 2

    def test_failing_probe_never_raises(self):
        from tendermint_tpu_torch.consensus.trace import TraceRecorder

        def boom():
            raise RuntimeError("probe died")

        rec = TraceRecorder(device_probe=boom, ring=2)
        rec.begin(1, now=0.0)
        tr = rec.finish(1, wall_s=1.0, now=1.0)
        assert tr.device == {}


# -- held against the JAX package ----------------------------------------------


def _same_ops(mod):
    """One registry of package `mod` through the same instruments, labels,
    observations, producers and a parent: (scrape text, flat map)."""
    parent = mod.Registry()
    parent.counter("parent_total", "from the parent").inc(2)
    reg = mod.Registry(parent=parent)
    reg.counter("reqs_total", "requests").inc(3)
    c = reg.counter("sent_total", "sent", labelnames=("peer",))
    c.labels(peer="a").inc()
    c.labels(peer="b").inc(4)
    g = reg.gauge("depth", "queue depth")
    g.set(2)
    g.inc(3)
    g.dec()
    reg.gauge("cb", "callback", fn=lambda: 7.5)
    h = reg.histogram("lat_seconds", "latency", buckets=mod.log_buckets(0.001, 10.0, 8), labelnames=("op",))
    for v in (0.0005, 0.002, 0.05, 0.5, 3.0, 20.0):
        h.labels(op="a").observe(v)
    h.labels(op="b").observe(0.01)
    reg.register_producer("plane", lambda: {"x": 1, "y": 2.5})
    reg.register_producer("scrapeonly", lambda: {"z": 9}, legacy=False)
    return reg.render_prometheus(), reg.flatten()


def test_registry_renders_equal_to_jax():
    """The same instruments and operations give byte-equal Prometheus text
    and equal flat maps in both packages."""
    from tendermint_tpu.libs import telemetry as jtelemetry

    assert _same_ops(telemetry) == _same_ops(jtelemetry)


def test_trace_recorder_equal_to_jax():
    """The same begin / mark / note / finish sequence, probe readings
    included, gives equal traces (to_json) in both packages, newest
    first and ring-bounded alike."""
    from tendermint_tpu.consensus.trace import TraceRecorder as JTraceRecorder
    from tendermint_tpu_torch.consensus.trace import TraceRecorder

    def run(cls):
        readings = iter([{"verify_cpu_sigs": i, "breaker_state": i % 3} for i in range(0, 40, 3)])
        rec = cls(device_probe=lambda: next(readings), ring=3)
        for h in range(1, 6):
            t = 10.0 * h
            rec.begin(h, now=t)
            for k, seg in enumerate(("propose", "prevote", "precommit", "commit")):
                rec.mark(seg, now=t + 0.25 * (k + 1) * h / 5)
            rec.note("part_hash_s", 0.01 * h)
            rec.finish(h, wall_s=1.5 + h, now=t + 1.5 + h)
        # started_at / completed_at are the wall clock's at each call
        return [{k: v for k, v in tr.to_json().items() if k not in ("started_at", "completed_at")}
                for tr in rec.last(10)]

    assert run(TraceRecorder) == run(JTraceRecorder)
