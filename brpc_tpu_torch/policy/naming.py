"""Naming services (a copy of ``brpc_tpu/policy/naming.py``).

A NamingService runs in a daemon thread per cluster and pushes
ServerNode lists to its listener (the load balancer) whenever
membership changes.

Schemes: list://h1:p1,h2:p2[(w)][ tag]  static list
         file://path               one "host:port [weight] [tag]" per line,
                                   re-read periodically
         dns://host:port           resolve A/AAAA records periodically
         remotefile://host:port/path
                                   the file:// format fetched over HTTP
         discovery://, consul://, nacos://host:port/path
                                   a JSON server list fetched over HTTP

A refresh that fails (the registry down, a non-200 answer, malformed
JSON) raises, and the naming thread keeps the last-known-good list.

Left out: ici://, the local device mesh (ROADMAP Queue 1 item 9); it
raises NotImplementedError.
"""
from __future__ import annotations

import socket as _socket
import threading

from .. import flags as _flags
from ..butil.endpoint import EndPoint, str2endpoint
from .load_balancer import LoadBalancer, ServerNode

DEFAULT_INTERVAL_S = 5.0

_flags.define_flag("naming_log_refresh_failures", True,
                   "log naming-service refresh failures (kept-list notes)",
                   reloadable=True)


class NamingService:
    interval_s = DEFAULT_INTERVAL_S

    def __init__(self, param: str):
        self.param = param

    def get_servers(self) -> list[ServerNode]:
        raise NotImplementedError


class ListNamingService(NamingService):
    """list://host:port[(weight)][ tag],... -- static membership; the
    optional space-separated tag carries partition labels like "0/4"."""

    interval_s = 0  # never re-resolves

    def get_servers(self):
        nodes = []
        for part in self.param.split(","):
            part = part.strip()
            if not part:
                continue
            tag = ""
            if " " in part:
                part, _, tag = part.partition(" ")
                tag = tag.strip()
            weight = 1
            if part.endswith(")") and "(" in part:
                part, _, w = part[:-1].rpartition("(")
                weight = int(w)
            nodes.append(ServerNode(str2endpoint(part), weight, tag))
        return nodes


def _parse_server_lines(text: str) -> list[ServerNode]:
    """'host:port [weight] [tag]' per line, # comments."""
    nodes = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        weight, tag = 1, ""
        if len(parts) >= 2:
            if parts[1].isdigit():
                weight = int(parts[1])
                tag = parts[2] if len(parts) >= 3 else ""
            else:
                tag = parts[1]
        try:
            nodes.append(ServerNode(str2endpoint(parts[0]), weight, tag))
        except (ValueError, TypeError, IndexError):
            continue
    return nodes


class FileNamingService(NamingService):
    """file://path -- 'host:port [weight] [tag]' per line, # comments."""

    def get_servers(self):
        with open(self.param) as f:   # OSError propagates: the naming
            return _parse_server_lines(f.read())  # thread keeps the old
                                                  # list on refresh errors


class DnsNamingService(NamingService):
    """dns://host:port -- A/AAAA records of host."""

    def get_servers(self):
        host, _, port = self.param.partition(":")
        port = int(port or 80)
        try:
            infos = _socket.getaddrinfo(host, port, type=_socket.SOCK_STREAM)
        except OSError:
            return []
        seen = set()
        nodes = []
        for family, _, _, _, sockaddr in infos:
            ip = sockaddr[0]
            if ip not in seen:
                seen.add(ip)
                nodes.append(ServerNode(EndPoint(ip, port)))
        return nodes


class RemoteFileNamingService(NamingService):
    """remotefile://host:port/path -- fetch a server list over HTTP in
    the file:// format, periodically."""

    interval_s = 5.0

    def _fetch(self) -> str:
        """Raises on a network error or a non-200 answer, so the naming
        thread keeps the last-known-good list: returning [] here would
        wipe the balancer on a transient registry outage."""
        from ..rpc.http import HttpChannel
        addr, slash, path = self.param.partition("/")
        ch = HttpChannel(addr, timeout_ms=4000)
        try:
            r = ch.request("GET", "/" + path if slash else "/")
            if r.status != 200:
                raise OSError(f"registry returned HTTP {r.status}")
            return r.body.decode("utf-8", "replace")
        finally:
            ch.close()

    def get_servers(self):
        return _parse_server_lines(self._fetch())


class HttpJsonNamingService(RemoteFileNamingService):
    """discovery://, consul://, nacos://host:port/path -- fetch a JSON
    server list over HTTP, periodically (the three registries differ
    only in the JSON's shape).  Accepted shapes:

      ["host:port", ...]
      [{"addr": "host:port", "weight": 2, "tag": "0/4"}, ...]
      {"servers": [... either of the above ...]}   (or "hosts")

    A malformed entry is skipped; a malformed document raises."""

    interval_s = 5.0

    def get_servers(self):
        import json
        doc = json.loads(self._fetch() or "null")
        if isinstance(doc, dict):
            doc = doc.get("servers") or doc.get("hosts") or []
        if not isinstance(doc, list):
            raise ValueError("registry JSON is not a server list")
        nodes = []
        for item in doc:
            try:
                if isinstance(item, str):
                    nodes.append(ServerNode(str2endpoint(item)))
                elif isinstance(item, dict):
                    nodes.append(ServerNode(
                        str2endpoint(item["addr"]),
                        int(item.get("weight") or 1),
                        str(item.get("tag") or "")))
            except (ValueError, KeyError, TypeError, AttributeError):
                continue
        return nodes


_SCHEMES = {
    "list": ListNamingService,
    "file": FileNamingService,
    "dns": DnsNamingService,
    "remotefile": RemoteFileNamingService,
    "discovery": HttpJsonNamingService,
    "consul": HttpJsonNamingService,
    "nacos": HttpJsonNamingService,
}

# the JAX package's schemes the port does not have yet, and the ROADMAP
# Queue 1 item that brings each
_LATER = {
    "ici": "item 9 (the mesh slice)",
}


def register_naming_service(scheme: str, cls) -> None:
    _SCHEMES[scheme] = cls


class NamingServiceFilter:
    """Hook to drop nodes before they reach the balancer."""

    def accept(self, node: ServerNode) -> bool:
        return True


class NamingServiceThread(threading.Thread):
    """The refresher of one cluster."""

    def __init__(self, ns: NamingService, lb: LoadBalancer,
                 ns_filter: NamingServiceFilter | None = None):
        super().__init__(daemon=True, name=f"ns-{ns.param}")
        self.ns = ns
        self.lb = lb
        self.filter = ns_filter
        # not ``_stop``: that name is threading.Thread's own method, and
        # shadowing it breaks join()
        self._stop_ev = threading.Event()
        self._resolved_once = threading.Event()

    def run(self):
        while not self._stop_ev.is_set():
            try:
                nodes = self.ns.get_servers()
                if self.filter is not None:
                    nodes = [n for n in nodes if self.filter.accept(n)]
                if nodes or self._resolved_once.is_set():
                    self.lb.reset_servers(nodes)
                self._resolved_once.set()
            except Exception as e:
                # refresh failed: keep the last-known-good list, with a
                # one-line note (reloadable flag: test suites silence it)
                if _flags.get_flag("naming_log_refresh_failures"):
                    print(f"[naming] refresh of {self.ns.param!r} failed: "
                          f"{type(e).__name__}: {e} "
                          f"(keeping previous list)")
            if self.ns.interval_s <= 0:
                break
            self._stop_ev.wait(self.ns.interval_s)

    def wait_first_resolution(self, timeout: float = 5.0) -> bool:
        return self._resolved_once.wait(timeout)

    def stop(self):
        self._stop_ev.set()


def start_naming_service(url: str, lb: LoadBalancer,
                         ns_filter: NamingServiceFilter | None = None,
                         ) -> NamingServiceThread:
    scheme, _, param = url.partition("://")
    cls = _SCHEMES.get(scheme)
    if cls is None:
        if scheme in _LATER:
            raise NotImplementedError(
                f"naming scheme {scheme}:// is not ported yet (ROADMAP "
                f"Queue 1 {_LATER[scheme]})")
        raise KeyError(f"unknown naming service scheme {scheme!r}; "
                       f"have {sorted(_SCHEMES)}")
    t = NamingServiceThread(cls(param), lb, ns_filter)
    t.start()
    t.wait_first_resolution()
    return t
