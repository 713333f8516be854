"""EndPoint — address value type (reference src/butil/endpoint.{h,cpp}).

Extends the reference's ip:port model with the TPU fabric: an endpoint is
either a host address ("10.0.0.3:8000", "[::1]:8000", "unix:/tmp/s.sock")
or an ICI device address ("ici://slice0/4" = chip 4 in slice0), so channels
can target either the DCN (TCP) transport or the in-pod ICI transport with
one address grammar.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EndPoint:
    host: str
    port: int = 0
    scheme: str = "tcp"   # tcp | unix | ici

    def __str__(self) -> str:
        if self.scheme == "ici":
            return f"ici://{self.host}/{self.port}"
        if self.scheme == "unix":
            return f"unix:{self.host}"
        if ":" in self.host:  # ipv6
            return f"[{self.host}]:{self.port}"
        return f"{self.host}:{self.port}"

    @property
    def is_ici(self) -> bool:
        return self.scheme == "ici"


def str2endpoint(s: str) -> EndPoint:
    """Parse "host:port", "[v6]:port", "unix:/path", "ici://slice/chip"."""
    s = s.strip()
    if s.startswith("ici://"):
        rest = s[6:]
        if "/" in rest:
            slice_name, chip = rest.rsplit("/", 1)
            return EndPoint(slice_name, int(chip), "ici")
        return EndPoint(rest, 0, "ici")
    if s.startswith("unix:"):
        return EndPoint(s[5:], 0, "unix")
    if s.startswith("["):  # [v6]:port
        close = s.index("]")
        host = s[1:close]
        port = int(s[close + 2 :]) if close + 2 <= len(s) - 1 else 0
        return EndPoint(host, port)
    if ":" in s:
        host, port = s.rsplit(":", 1)
        return EndPoint(host or "127.0.0.1", int(port))
    return EndPoint(s, 0)
