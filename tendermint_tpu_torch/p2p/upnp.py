"""UPnP IGD client: NAT discovery, external-IP lookup, port mapping
(reference: p2p/upnp/upnp.go:35-380, probe.go).

Pure stdlib: SSDP discovery is an M-SEARCH datagram to the well-known
multicast group; the gateway answers with the LOCATION of its device
description, which names the WAN(IP|PPP)Connection control URL; mapping
calls are small SOAP envelopes POSTed there. Timeouts are short and
every failure degrades to "no NAT" — a node behind no IGD must start
instantly (node wiring gates this on p2p.skip_upnp, like the
reference's listener, p2p/listener.go:51-74).
"""

from __future__ import annotations

import socket
import urllib.request
import xml.etree.ElementTree as ET
from dataclasses import dataclass

SSDP_ADDR = ("239.255.255.250", 1900)
_SEARCH = (
    "M-SEARCH * HTTP/1.1\r\n"
    f"HOST: {SSDP_ADDR[0]}:{SSDP_ADDR[1]}\r\n"
    'MAN: "ssdp:discover"\r\n'
    "MX: 2\r\n"
    "ST: urn:schemas-upnp-org:device:InternetGatewayDevice:1\r\n"
    "\r\n"
)
_WAN_SERVICES = (
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)


class UPnPError(Exception):
    pass


@dataclass
class Capabilities:
    """probe_upnp's answer (ref probe.go UPNPCapabilities)."""

    port_mapping: bool = False
    hairpin: bool = False


class NAT:
    """One discovered IGD: a control URL + the service type to talk to."""

    def __init__(self, control_url: str, service_type: str, our_ip: str):
        self.control_url = control_url
        self.service_type = service_type
        self.our_ip = our_ip

    # -- SOAP plumbing -----------------------------------------------------

    def _soap(self, action: str, args: dict[str, str]) -> ET.Element:
        body_args = "".join(f"<{k}>{v}</{k}>" for k, v in args.items())
        envelope = (
            '<?xml version="1.0"?>'
            '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/" '
            's:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
            f'<s:Body><u:{action} xmlns:u="{self.service_type}">{body_args}'
            f"</u:{action}></s:Body></s:Envelope>"
        ).encode()
        req = urllib.request.Request(
            self.control_url,
            data=envelope,
            headers={
                "Content-Type": 'text/xml; charset="utf-8"',
                "SOAPAction": f'"{self.service_type}#{action}"',
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=3) as resp:
                return ET.fromstring(resp.read())
        except Exception as exc:  # noqa: BLE001 — one error surface
            raise UPnPError(f"SOAP {action} failed: {exc}") from exc

    @staticmethod
    def _find_text(root: ET.Element, tag: str) -> str:
        for el in root.iter():
            if el.tag.endswith(tag):
                return el.text or ""
        raise UPnPError(f"no {tag} in SOAP response")

    # -- the NAT interface (ref upnp.go NAT) --------------------------------

    def get_external_address(self) -> str:
        root = self._soap("GetExternalIPAddress", {})
        return self._find_text(root, "NewExternalIPAddress")

    def add_port_mapping(
        self,
        protocol: str,
        external_port: int,
        internal_port: int,
        description: str,
        lease_seconds: int = 0,
    ) -> int:
        self._soap(
            "AddPortMapping",
            {
                "NewRemoteHost": "",
                "NewExternalPort": str(external_port),
                "NewProtocol": protocol.upper(),
                "NewInternalPort": str(internal_port),
                "NewInternalClient": self.our_ip,
                "NewEnabled": "1",
                "NewPortMappingDescription": description,
                "NewLeaseDuration": str(lease_seconds),
            },
        )
        return external_port

    def delete_port_mapping(self, protocol: str, external_port: int) -> None:
        self._soap(
            "DeletePortMapping",
            {
                "NewRemoteHost": "",
                "NewExternalPort": str(external_port),
                "NewProtocol": protocol.upper(),
            },
        )


def _parse_ssdp_location(datagram: bytes) -> str | None:
    for line in datagram.decode(errors="replace").split("\r\n"):
        k, _, v = line.partition(":")
        if k.strip().lower() == "location":
            return v.strip()
    return None


def _control_url_from_description(location: str) -> tuple[str, str]:
    """(control_url, service_type) from the device-description XML."""
    with urllib.request.urlopen(location, timeout=3) as resp:
        root = ET.fromstring(resp.read())
    base = location.rsplit("/", 1)[0]
    services: dict[str, str] = {}
    for svc in root.iter():
        if not svc.tag.endswith("service"):
            continue
        st = ctl = ""
        for child in svc:
            if child.tag.endswith("serviceType"):
                st = (child.text or "").strip()
            elif child.tag.endswith("controlURL"):
                ctl = (child.text or "").strip()
        if st and ctl:
            services[st] = ctl
    for want in _WAN_SERVICES:
        if want in services:
            ctl = services[want]
            url = ctl if ctl.startswith("http") else base + "/" + ctl.lstrip("/")
            return url, want
    raise UPnPError("no WAN connection service in device description")


def discover(timeout: float = 3.0, ssdp_addr=SSDP_ADDR) -> NAT:
    """SSDP search for an IGD (ref upnp.go Discover)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.settimeout(timeout)
        sock.sendto(_SEARCH.encode(), ssdp_addr)
        datagram, _ = sock.recvfrom(4096)
        our_ip = sock.getsockname()[0]
    except OSError as exc:
        raise UPnPError(f"SSDP discovery failed: {exc}") from exc
    finally:
        sock.close()
    location = _parse_ssdp_location(datagram)
    if not location:
        raise UPnPError("SSDP response without LOCATION")
    if our_ip in ("0.0.0.0", ""):
        our_ip = _local_ip(location)
    try:
        control_url, service_type = _control_url_from_description(location)
    except UPnPError:
        raise
    except Exception as exc:  # noqa: BLE001 — unreachable/garbage device
        # description must degrade to "no NAT", never crash node startup
        raise UPnPError(f"bad device description at {location}: {exc}") from exc
    return NAT(control_url, service_type, our_ip)


def _local_ip(reach_url: str) -> str:
    """The local interface address that routes toward the gateway."""
    from urllib.parse import urlparse

    host = urlparse(reach_url).hostname or "8.8.8.8"
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((host, 9))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def probe(ext_port: int = 46656, int_port: int = 46656, timeout: float = 3.0) -> Capabilities:
    """Can this network do UPnP port mapping? (ref probe.go:87-112 minus
    the hairpin self-dial, which needs a live listener)."""
    caps = Capabilities()
    nat = discover(timeout=timeout)
    nat.get_external_address()
    nat.add_port_mapping("tcp", ext_port, int_port, "tendermint-tpu probe", 20 * 60)
    caps.port_mapping = True
    nat.delete_port_mapping("tcp", ext_port)
    return caps
