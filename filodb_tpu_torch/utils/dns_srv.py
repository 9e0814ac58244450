"""Minimal DNS SRV resolver over stdlib sockets (RFC 1035 + RFC 2782).

Copy of ``filodb_tpu/utils/dns_srv.py``.

Counterpart of reference ``akka-bootstrapper/.../DnsSrvClusterSeedDiscovery
.scala:1-122`` (which leans on dnsjava). This image has no dnspython, so the
wire format is spoken directly: one UDP query (QTYPE=SRV), answer parsing
with full name-compression support, answers ordered by (priority, -weight)
per RFC 2782. TCP fallback on truncation is intentionally omitted — seed
lists are small.
"""

from __future__ import annotations

import os
import secrets
import socket
import struct
from dataclasses import dataclass

QTYPE_SRV = 33
QCLASS_IN = 1


class DnsError(RuntimeError):
    pass


@dataclass(frozen=True)
class SrvRecord:
    target: str
    port: int
    priority: int
    weight: int


def encode_qname(name: str) -> bytes:
    out = bytearray()
    for label in name.rstrip(".").split("."):
        raw = label.encode("idna") if not label.isascii() else label.encode()
        if not 0 < len(raw) < 64:
            raise DnsError(f"bad label in {name!r}")
        out.append(len(raw))
        out += raw
    out.append(0)
    return bytes(out)


def build_query(name: str, txid: int) -> bytes:
    # header: id, flags=RD, qdcount=1
    header = struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0)
    return header + encode_qname(name) + struct.pack(">HH", QTYPE_SRV,
                                                     QCLASS_IN)


def read_name(msg: bytes, off: int, depth: int = 0) -> tuple[str, int]:
    """Decode a (possibly compressed) domain name; returns (name, next_off).
    ``next_off`` is the offset after the name AT THIS POSITION (a pointer
    consumes 2 bytes regardless of where it lands)."""
    if depth > 16:
        raise DnsError("compression loop")
    labels = []
    while True:
        if off >= len(msg):
            raise DnsError("truncated name")
        n = msg[off]
        if n == 0:
            return ".".join(labels), off + 1
        if n & 0xC0 == 0xC0:  # compression pointer
            if off + 2 > len(msg):
                raise DnsError("truncated pointer")
            ptr = struct.unpack(">H", msg[off:off + 2])[0] & 0x3FFF
            if ptr >= off:
                raise DnsError("forward pointer")
            suffix, _ = read_name(msg, ptr, depth + 1)
            return ".".join(labels + ([suffix] if suffix else [])), off + 2
        if n & 0xC0:
            raise DnsError("bad label type")
        off += 1
        labels.append(msg[off:off + n].decode("ascii", "replace"))
        off += n


def parse_srv_response(msg: bytes, txid: int) -> list[SrvRecord]:
    if len(msg) < 12:
        raise DnsError("short response")
    rid, flags, qd, an, _, _ = struct.unpack(">HHHHHH", msg[:12])
    if rid != txid:
        raise DnsError("transaction id mismatch")
    rcode = flags & 0xF
    if rcode == 3:  # NXDOMAIN
        return []
    if rcode != 0:
        raise DnsError(f"server rcode {rcode}")
    off = 12
    for _ in range(qd):  # skip question section
        _, off = read_name(msg, off)
        off += 4
    out = []
    for _ in range(an):
        _, off = read_name(msg, off)
        if off + 10 > len(msg):
            raise DnsError("truncated answer")
        rtype, rclass, _ttl, rdlen = struct.unpack(">HHIH",
                                                   msg[off:off + 10])
        off += 10
        rdata_end = off + rdlen
        if rdata_end > len(msg):
            raise DnsError("truncated rdata")
        if rtype == QTYPE_SRV and rclass == QCLASS_IN:
            if rdlen < 7:
                raise DnsError("short SRV rdata")
            prio, weight, port = struct.unpack(">HHH", msg[off:off + 6])
            target, _ = read_name(msg, off + 6)
            out.append(SrvRecord(target, port, prio, weight))
        off = rdata_end
    out.sort(key=lambda r: (r.priority, -r.weight))
    return out


def system_resolver() -> tuple[str, int]:
    """First nameserver from /etc/resolv.conf (127.0.0.53 systemd stub is
    fine — it speaks real DNS)."""
    try:
        with open("/etc/resolv.conf") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0] == "nameserver":
                    return parts[1], 53
    except OSError:
        pass
    return "127.0.0.1", 53


def resolve_srv(name: str, server: str | None = None, port: int | None = None,
                timeout: float = 2.0) -> list[SrvRecord]:
    """Resolve SRV records for ``name`` (e.g. ``_filodb._tcp.example.com``).

    ``server``/``port`` override the system resolver (tests point this at a
    stub). Env override: ``FILODB_DNS_SERVER=host[:port]``."""
    if server is None:
        env = os.environ.get("FILODB_DNS_SERVER")
        if env:
            host, _, p = env.partition(":")
            try:
                server, port = host, int(p) if p else 53
            except ValueError as e:
                raise DnsError(f"bad FILODB_DNS_SERVER {env!r}") from e
        else:
            server, sys_port = system_resolver()
            port = port or sys_port
    txid = secrets.randbelow(1 << 16)
    query = build_query(name, txid)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(query, (server, port or 53))
        msg, _ = s.recvfrom(4096)
    return parse_srv_response(msg, txid)
