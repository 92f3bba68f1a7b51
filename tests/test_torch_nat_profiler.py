"""The port's copy of tests/test_nat_profiler.py: the UPnP client against a fake in-process IGD, the per-IP-range inbound
counter, and the profiler RPC routes (ref p2p/upnp/*, p2p/ip_range_counter.go,
rpc/core/routes.go:42-45)."""

from __future__ import annotations

import http.server
import socket
import threading

import pytest

from tendermint_tpu_torch.p2p import upnp
from tendermint_tpu_torch.p2p.ip_range_counter import IPRangeCounter

DESC_XML = b"""<?xml version="1.0"?>
<root xmlns="urn:schemas-upnp-org:device-1-0">
 <device><deviceList><device>
  <serviceList><service>
   <serviceType>urn:schemas-upnp-org:service:WANIPConnection:1</serviceType>
   <controlURL>/ctl</controlURL>
  </service></serviceList>
 </device></deviceList></device>
</root>"""

SOAP_EXT_IP = b"""<?xml version="1.0"?>
<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"><s:Body>
 <u:GetExternalIPAddressResponse xmlns:u="urn:schemas-upnp-org:service:WANIPConnection:1">
  <NewExternalIPAddress>203.0.113.7</NewExternalIPAddress>
 </u:GetExternalIPAddressResponse>
</s:Body></s:Envelope>"""

SOAP_OK = b"""<?xml version="1.0"?>
<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"><s:Body>
 <u:AnyResponse xmlns:u="urn:schemas-upnp-org:service:WANIPConnection:1"/>
</s:Body></s:Envelope>"""


class _FakeIGD:
    """SSDP responder + description/SOAP HTTP server. `requests` keeps
    every SSDP datagram and HTTP request as received, in order."""

    def __init__(self):
        self.mapped: list[tuple[str, int]] = []
        self.deleted: list[tuple[str, int]] = []
        self.requests: list[tuple] = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                outer.requests.append(("http", self.requestline, str(self.headers), b""))
                self.send_response(200)
                self.end_headers()
                self.wfile.write(DESC_XML)

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                outer.requests.append(("http", self.requestline, str(self.headers), body))
                action = self.headers.get("SOAPAction", "")
                if "GetExternalIPAddress" in action:
                    payload = SOAP_EXT_IP
                else:
                    import re

                    port = re.search(rb"<NewExternalPort>(\d+)<", body)
                    port = int(port.group(1)) if port else 0
                    if "AddPortMapping" in action:
                        outer.mapped.append(("tcp", port))
                    elif "DeletePortMapping" in action:
                        outer.deleted.append(("tcp", port))
                    payload = SOAP_OK
                self.send_response(200)
                self.end_headers()
                self.wfile.write(payload)

        self.http = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.http.serve_forever, daemon=True).start()
        self.location = f"http://127.0.0.1:{self.http.server_address[1]}/desc.xml"
        # SSDP responder on a plain UDP socket
        self.udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.udp.bind(("127.0.0.1", 0))
        self.ssdp_addr = self.udp.getsockname()

        def responder():
            while True:
                try:
                    data, addr = self.udp.recvfrom(2048)
                except OSError:
                    return
                self.requests.append(("ssdp", data))
                if b"M-SEARCH" in data:
                    resp = (
                        "HTTP/1.1 200 OK\r\n"
                        f"LOCATION: {self.location}\r\n"
                        "ST: urn:schemas-upnp-org:device:InternetGatewayDevice:1\r\n\r\n"
                    )
                    self.udp.sendto(resp.encode(), addr)

        threading.Thread(target=responder, daemon=True).start()

    def close(self):
        self.http.shutdown()
        self.udp.close()


class TestUPnP:
    @pytest.fixture()
    def igd(self):
        g = _FakeIGD()
        yield g
        g.close()

    def test_discover_and_map(self, igd):
        nat = upnp.discover(timeout=3.0, ssdp_addr=igd.ssdp_addr)
        assert nat.service_type.endswith("WANIPConnection:1")
        assert nat.get_external_address() == "203.0.113.7"
        assert nat.add_port_mapping("tcp", 46656, 46656, "test") == 46656
        nat.delete_port_mapping("tcp", 46656)
        assert igd.mapped == [("tcp", 46656)]
        assert igd.deleted == [("tcp", 46656)]

    def test_discovery_timeout_is_an_error(self):
        sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sink.bind(("127.0.0.1", 0))
        try:
            with pytest.raises(upnp.UPnPError):
                upnp.discover(timeout=0.2, ssdp_addr=sink.getsockname())
        finally:
            sink.close()


class TestUPnPEqualToJax:
    @pytest.fixture()
    def igd(self):
        g = _FakeIGD()
        yield g
        g.close()

    def test_requests_and_answers_equal_to_jax(self, igd):
        """Both packages' discover / get_external_address /
        add_port_mapping / delete_port_mapping, pointed at one fake IGD,
        send it byte-equal SSDP datagrams and HTTP requests (request
        line, headers, SOAP body) and read the same answers."""
        from tendermint_tpu.p2p import upnp as jupnp

        seen = []
        for mod in (jupnp, upnp):
            igd.requests.clear()
            nat = mod.discover(timeout=3.0, ssdp_addr=igd.ssdp_addr)
            answers = (nat.control_url, nat.service_type, nat.our_ip, nat.get_external_address(),
                       nat.add_port_mapping("tcp", 46656, 46657, "tendermint", 1200))
            nat.delete_port_mapping("tcp", 46656)
            seen.append((answers, list(igd.requests)))
        (j_answers, j_requests), (t_answers, t_requests) = seen
        assert t_answers == j_answers
        assert [r[0] for r in j_requests] == ["ssdp", "http", "http", "http", "http"]
        assert t_requests == j_requests
        assert igd.mapped == [("tcp", 46656)] * 2 and igd.deleted == [("tcp", 46656)] * 2


class TestProbeEqualToJax:
    """`upnp.probe` and `Capabilities` (probe_upnp's answer), the CLI's
    `probe_upnp`: both packages, pointed at one fake IGD (their
    `discover` bound to its SSDP address, so no datagram leaves the
    loopback)."""

    @pytest.fixture()
    def igd(self):
        g = _FakeIGD()
        yield g
        g.close()

    @staticmethod
    def _bind(monkeypatch, mod, ssdp_addr, timeout=None):
        """mod.discover pointed at `ssdp_addr` (and, with `timeout`, with
        that window whatever the caller asks)."""
        orig = mod.discover

        def discover(timeout_=3.0, **kw):
            return orig(timeout=timeout_ if timeout is None else timeout, ssdp_addr=ssdp_addr)

        monkeypatch.setattr(mod, "discover", lambda timeout=3.0, **kw: discover(timeout))

    def test_probe_requests_and_capabilities_equal_to_jax(self, igd, monkeypatch):
        from tendermint_tpu.p2p import upnp as jupnp

        seen = []
        for mod in (jupnp, upnp):
            self._bind(monkeypatch, mod, igd.ssdp_addr)
            igd.requests.clear()
            caps = mod.probe(ext_port=46700, int_port=46701, timeout=3.0)
            seen.append((caps, list(igd.requests)))
        (j_caps, j_requests), (t_caps, t_requests) = seen
        assert isinstance(t_caps, upnp.Capabilities)
        assert (t_caps.port_mapping, t_caps.hairpin) == (j_caps.port_mapping, j_caps.hairpin) == (True, False)
        assert upnp.Capabilities() == upnp.Capabilities(port_mapping=False, hairpin=False)
        assert [r[0] for r in j_requests] == ["ssdp", "http", "http", "http", "http"]
        assert t_requests == j_requests
        assert igd.mapped == [("tcp", 46700)] * 2 and igd.deleted == [("tcp", 46700)] * 2

    def test_cli_probe_upnp_equal_to_jax(self, igd, monkeypatch, capsys):
        """`probe_upnp` prints the capabilities as JSON and exits 0; with no
        gateway answering it prints the error and exits 1, in both CLIs."""
        import json

        from tendermint_tpu import cli as jcli
        from tendermint_tpu.p2p import upnp as jupnp
        from tendermint_tpu_torch import cli

        sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sink.bind(("127.0.0.1", 0))
        got = {}
        try:
            for name, main, mod in (("jax", jcli.main, jupnp), ("port", cli.main, upnp)):
                self._bind(monkeypatch, mod, igd.ssdp_addr)
                ok = (main(["probe_upnp"]), json.loads(capsys.readouterr().out))
                monkeypatch.undo()
                self._bind(monkeypatch, mod, sink.getsockname(), timeout=0.2)
                failed = (main(["probe_upnp"]), json.loads(capsys.readouterr().out))
                monkeypatch.undo()
                got[name] = (ok, failed)
        finally:
            sink.close()
        assert got["port"][0] == got["jax"][0] == (0, {"port_mapping": True, "hairpin": False})
        assert got["port"][1] == got["jax"][1]
        assert got["port"][1][0] == 1 and got["port"][1][1]["error"].startswith("SSDP discovery failed")


class TestIPRangeCounter:
    def test_limits_per_depth(self):
        c = IPRangeCounter(limits=(4, 3, 2))
        assert c.try_add("10.0.0.1")
        assert c.try_add("10.0.0.2")
        assert not c.try_add("10.0.0.3")  # /24 at 2
        assert c.try_add("10.0.1.1")  # same /16, different /24
        assert not c.try_add("10.0.2.1")  # /16 at 3
        assert c.try_add("10.9.0.1")  # same /8
        assert not c.try_add("10.8.0.1")  # /8 at 4
        c.remove("10.0.0.1")
        assert c.try_add("10.0.0.9")  # freed

    def test_remove_unknown_is_noop(self):
        c = IPRangeCounter()
        c.remove("192.168.1.1")
        assert c.count("192") == 0


class TestProfilerRoutes:
    def test_cpu_and_heap_profile(self, tmp_path):
        from tendermint_tpu_torch.rpc.core import handlers

        cpu_out = tmp_path / "cpu.prof"
        heap_out = tmp_path / "heap.txt"
        handlers.unsafe_start_cpu_profiler(None, str(cpu_out))
        with pytest.raises(handlers.RPCError):
            handlers.unsafe_start_cpu_profiler(None, str(cpu_out))  # already on
        sum(i * i for i in range(10000))  # some work to profile
        res = handlers.unsafe_stop_cpu_profiler(None)
        assert "profile written" in res["log"]
        assert cpu_out.stat().st_size > 0
        import pstats

        pstats.Stats(str(cpu_out))  # parses as a valid profile
        with pytest.raises(handlers.RPCError):
            handlers.unsafe_stop_cpu_profiler(None)  # already off
        handlers.unsafe_write_heap_profile(None, str(heap_out))
        # second call captures live tracing
        handlers.unsafe_write_heap_profile(None, str(heap_out))
        assert heap_out.exists()

    def test_routes_registered_as_unsafe(self):
        from tendermint_tpu_torch.rpc.core.handlers import UNSAFE_ROUTES_TABLE

        for r in (
            "unsafe_start_cpu_profiler",
            "unsafe_stop_cpu_profiler",
            "unsafe_write_heap_profile",
        ):
            assert r in UNSAFE_ROUTES_TABLE
