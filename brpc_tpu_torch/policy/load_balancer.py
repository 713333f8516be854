"""Load balancers (a copy of ``brpc_tpu/policy/load_balancer.py``).

Every balancer reads its server set through a DoublyBufferedData
snapshot and implements ``select_server``/``feedback``.  Registered: rr,
wrr, random, wr, c_murmurhash, c_md5, c_ketama, la (locality-aware:
EWMA latency x inflight) and prefix_affinity (consistent hashing on the
prompt's prefix fingerprint, so repeat prefixes land on the replica
holding their KV pages).  The hashes, the virtual-node keys and the
request-code encoding are the JAX package's byte for byte, so a port
ring over the same servers equals the reference's ring point for point.

Left out (ROADMAP Queue 1 item 5, KV migration): prefix_affinity's
migration on rebalance, which pushes a remapped prefix's pages to its
new owner over the ``_kvmig`` service; ``migrate_on_rebalance`` raises.
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import random
import threading
from dataclasses import dataclass

from ..butil.doubly_buffered import DoublyBufferedData
from ..butil.endpoint import EndPoint


@dataclass(frozen=True)
class ServerNode:
    endpoint: EndPoint
    weight: int = 1
    tag: str = ""


class LoadBalancer:
    name = "base"

    def __init__(self):
        self._servers: DoublyBufferedData[tuple[ServerNode, ...]] = \
            DoublyBufferedData(())

    # ---- membership (pushed by naming services) ----

    def reset_servers(self, nodes: list[ServerNode]) -> None:
        self._servers.modify(lambda _old: tuple(nodes))
        self._on_servers_changed()

    def add_server(self, node: ServerNode) -> None:
        self._servers.modify(lambda old: tuple(list(old) + [node]))
        self._on_servers_changed()

    def remove_server(self, endpoint: EndPoint) -> None:
        self._servers.modify(
            lambda old: tuple(n for n in old if n.endpoint != endpoint))
        self._on_servers_changed()

    def server_count(self) -> int:
        return len(self._servers.read())

    def servers(self) -> tuple[ServerNode, ...]:
        return self._servers.read()

    def _on_servers_changed(self) -> None:
        pass

    def _alive(self, exclude=None):
        from .circuit_breaker import global_breaker
        from .health_check import is_broken
        breaker = global_breaker()
        nodes = self._servers.read()
        # admit() is the gradual-recovery gate: a freshly-revived endpoint
        # gets a linearly-growing fraction of selections (circuit_breaker
        # RECOVERY ramp) instead of its full share the instant it revives
        healthy = [n for n in nodes
                   if (exclude is None or n.endpoint not in exclude)
                   and not is_broken(n.endpoint)]
        out = [n for n in healthy if breaker.admit(n.endpoint)]
        if not out and healthy:
            # admit() probabilistically rejected every healthy node (all
            # are mid-recovery-ramp): prefer a recovering-but-healthy node
            # over falling through to known-broken ones
            out = healthy
        if not out and nodes:
            # all broken/excluded: let the caller retry anything rather than
            # fast-failing the whole cluster (cluster_recover_policy spirit)
            out = [n for n in nodes if exclude is None or
                   n.endpoint not in exclude]
        return out

    # ---- selection ----

    def select_server(self, exclude: set | None = None,
                      request_code: int | None = None) -> EndPoint | None:
        raise NotImplementedError

    def feedback(self, endpoint: EndPoint, error_code: int,
                 latency_us: int) -> None:
        pass


class RoundRobinLB(LoadBalancer):
    name = "rr"

    def __init__(self):
        super().__init__()
        self._counter = itertools.count()

    def select_server(self, exclude=None, request_code=None):
        nodes = self._alive(exclude)
        if not nodes:
            return None
        return nodes[next(self._counter) % len(nodes)].endpoint


class RandomLB(LoadBalancer):
    name = "random"

    def select_server(self, exclude=None, request_code=None):
        nodes = self._alive(exclude)
        if not nodes:
            return None
        return random.choice(nodes).endpoint


class WeightedRoundRobinLB(LoadBalancer):
    """Smooth weighted RR (same behavior class as policy/weighted_round_robin_
    load_balancer.cpp; smooth-WRR algorithm keeps bursts interleaved)."""

    name = "wrr"

    def __init__(self):
        super().__init__()
        self._mu = threading.Lock()
        self._current: dict[EndPoint, int] = {}

    def select_server(self, exclude=None, request_code=None):
        nodes = self._alive(exclude)
        if not nodes:
            return None
        with self._mu:
            total = 0
            best = None
            for n in nodes:
                w = max(1, n.weight)
                total += w
                cur = self._current.get(n.endpoint, 0) + w
                self._current[n.endpoint] = cur
                if best is None or cur > self._current[best.endpoint]:
                    best = n
            self._current[best.endpoint] -= total
            return best.endpoint


class WeightedRandomLB(LoadBalancer):
    name = "wr"

    def select_server(self, exclude=None, request_code=None):
        nodes = self._alive(exclude)
        if not nodes:
            return None
        weights = [max(1, n.weight) for n in nodes]
        return random.choices(nodes, weights=weights, k=1)[0].endpoint


def _hash_murmur_like(data: bytes) -> int:
    # fast stable 64-bit hash (fnv-1a variant; role of murmurhash in c_murmur)
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class ConsistentHashLB(LoadBalancer):
    """Ketama-style ring (reference policy/consistent_hashing_load_balancer.*):
    N virtual nodes per server; requests route by request_code."""

    name = "c_murmurhash"
    VIRTUAL_NODES = 100

    def __init__(self, hash_fn=None):
        super().__init__()
        self._hash = hash_fn or _hash_murmur_like
        self._ring: list[tuple[int, EndPoint]] = []
        self._ring_keys: list[int] = []
        self._mu = threading.Lock()

    def _on_servers_changed(self):
        ring = []
        for n in self._servers.read():
            base = str(n.endpoint).encode()
            for i in range(self.VIRTUAL_NODES * max(1, n.weight)):
                ring.append((self._hash(base + b"#%d" % i), n.endpoint))
        ring.sort()
        with self._mu:
            self._ring = ring
            self._ring_keys = [k for k, _ in ring]

    @staticmethod
    def _code_bytes(code) -> bytes:
        # mask into u64: hash()-derived codes are frequently negative and
        # to_bytes(signed=False) would raise OverflowError
        return (int(code) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")

    def _map_code(self, request_code) -> int:
        code = request_code if request_code is not None \
            else random.getrandbits(63)
        # hash the request code onto the ring (raw codes would all land at
        # one end of the 64-bit key space)
        return self._hash(self._code_bytes(code))

    def select_server(self, exclude=None, request_code=None):
        from .health_check import is_broken
        with self._mu:
            ring, keys = self._ring, self._ring_keys
        if not ring:
            return None
        h = self._map_code(request_code)
        i = bisect.bisect_left(keys, h) % len(ring)
        # walk the ring past excluded/broken nodes
        for step in range(len(ring)):
            ep = ring[(i + step) % len(ring)][1]
            if (exclude is None or ep not in exclude) and not is_broken(ep):
                return ep
        # nothing is both healthy and unexcluded: prefer a BROKEN but
        # unexcluded node (it may be mid-recovery — e.g. latency-
        # isolated yet alive) over one the caller JUST failed on.
        # Without this, a cluster whose survivors are transiently
        # isolated hands every retry back to the known-dead endpoint
        # the exclusion was recording.
        if exclude:
            for step in range(len(ring)):
                ep = ring[(i + step) % len(ring)][1]
                if ep not in exclude:
                    return ep
        return ring[i][1]

    def placement(self, request_code, n: int,
                  exclude: set | None = None) -> list:
        """The request's N-way placement: up to `n` DISTINCT
        endpoints walking the ring from the code's position — the
        owner (what ``select_server`` returns) first, then the ring
        successors a failover would land on, i.e. exactly where a
        replica of this prefix is worth keeping warm.  Healthy
        endpoints are taken first; broken ones fill remaining slots
        only when the fleet is too degraded to satisfy `n` otherwise
        (a placement must stay stable across a brief quarantine, not
        shrink the replica set)."""
        from .health_check import is_broken
        with self._mu:
            ring = self._ring
            keys = self._ring_keys
        if not ring or n <= 0:
            return []
        h = self._map_code(request_code)
        i = bisect.bisect_left(keys, h) % len(ring)
        out: list = []
        broken: list = []
        for step in range(len(ring)):
            ep = ring[(i + step) % len(ring)][1]
            if exclude is not None and ep in exclude:
                continue
            if ep in out or ep in broken:
                continue
            if is_broken(ep):
                broken.append(ep)
            else:
                out.append(ep)
            if len(out) >= n:
                return out
        return (out + broken)[:n]


class ConsistentHashMd5LB(ConsistentHashLB):
    name = "c_md5"

    def __init__(self):
        super().__init__(hash_fn=lambda d: int.from_bytes(
            hashlib.md5(d).digest()[:8], "little"))


class KetamaLB(ConsistentHashLB):
    """libketama-compatible ring (reference c_ketama,
    policy/consistent_hashing_load_balancer.cpp KetamaReplicaPolicy):
    per virtual-node GROUP one md5 of "host:port-<g>" yields FOUR ring
    points (digest split into 4 little-endian u32s), 40 groups => 160
    points per unit weight — the memcached client ecosystem's exact
    placement, so a ketama client and this LB agree on key ownership."""

    name = "c_ketama"
    GROUPS = 40   # x4 points/group = 160 points per weight unit

    def _on_servers_changed(self):
        ring = []
        for n in self._servers.read():
            base = str(n.endpoint)
            for g in range(self.GROUPS * max(1, n.weight)):
                digest = hashlib.md5(f"{base}-{g}".encode()).digest()
                for part in range(4):
                    point = int.from_bytes(
                        digest[part * 4:part * 4 + 4], "little")
                    ring.append((point, n.endpoint))
        ring.sort()
        with self._mu:
            self._ring = ring
            self._ring_keys = [k for k, _ in ring]

    def _map_code(self, request_code) -> int:
        if request_code is None:
            return random.getrandbits(32)
        # ketama hashes the KEY with md5 and takes the first 4 bytes —
        # request_code is already the caller's key hash, so map it into
        # the u32 ring space the same way
        digest = hashlib.md5(self._code_bytes(request_code)).digest()
        return int.from_bytes(digest[:4], "little")


def prefix_fingerprint(tokens, chunk_tokens: int = 16) -> int:
    """Stable 64-bit fingerprint of a prompt's leading page-aligned
    chunk(s) — the routing key for prefix-affinity balancing.  Prompts
    sharing their first ``chunk_tokens``-aligned prefix (the unit the
    paged KV cache shares at, `kvcache/pages.py`) produce the SAME
    fingerprint; anything shorter than one chunk fingerprints whole.
    """
    # only the FIRST chunk decides affinity: a shared system prompt
    # routes all its continuations to one replica's radix tree even
    # though their tails diverge
    head = [int(t) for t in tokens[:chunk_tokens]]
    if not head:
        return 0
    return _hash_murmur_like(b"".join(
        (t & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little") for t in head))


class PrefixAffinityLB(ConsistentHashLB):
    """Cache-aware routing: consistent hashing on the prefix fingerprint
    (``prefix_fingerprint``), so repeat prefixes land on the replica
    whose radix tree already holds their pages.  The virtual-node ring
    underneath means replica churn remaps only the departed replica's
    share of prefixes; the rest keep their warm caches.

    Use ``select_server(request_code=prefix_fingerprint(prompt))``, or
    :meth:`select_for_prompt`."""

    name = "prefix_affinity"

    def migrate_on_rebalance(self, hook, *,
                             track_capacity: int = 1024) -> None:
        raise NotImplementedError(
            "prefix_affinity's migration on rebalance pushes KV pages over "
            "the _kvmig service, which the port does not have yet "
            "(ROADMAP Queue 1 item 5, KV migration)")

    def select_for_prompt(self, prompt, exclude=None,
                          chunk_tokens: int = 16):
        return self.select_server(
            exclude=exclude,
            request_code=prefix_fingerprint(prompt, chunk_tokens))


class LocalityAwareLB(LoadBalancer):
    """Locality-aware: weight ∝ 1 / (EWMA latency × (inflight+1))
    (reference policy/locality_aware_load_balancer.cpp design: dividing
    qps by latency while penalizing inflight explorers)."""

    name = "la"
    DECAY = 0.8

    def __init__(self):
        super().__init__()
        self._mu = threading.Lock()
        self._lat: dict[EndPoint, float] = {}       # EWMA latency us
        self._inflight: dict[EndPoint, int] = {}

    def select_server(self, exclude=None, request_code=None):
        nodes = self._alive(exclude)
        if not nodes:
            return None
        with self._mu:
            weights = []
            for n in nodes:
                lat = self._lat.get(n.endpoint, 1000.0)
                inflight = self._inflight.get(n.endpoint, 0)
                weights.append(max(1, n.weight) * 1e6 /
                               (lat * (inflight + 1)))
            ep = random.choices(nodes, weights=weights, k=1)[0].endpoint
            self._inflight[ep] = self._inflight.get(ep, 0) + 1
            return ep

    def feedback(self, endpoint, error_code, latency_us):
        with self._mu:
            self._inflight[endpoint] = max(
                0, self._inflight.get(endpoint, 1) - 1)
            if error_code == 0:
                old = self._lat.get(endpoint, float(latency_us))
                self._lat[endpoint] = (self.DECAY * old +
                                       (1 - self.DECAY) * latency_us)
            else:
                # errors look like huge latency so traffic shifts away
                self._lat[endpoint] = max(
                    self._lat.get(endpoint, 1000.0) * 2, 1e5)


_LBS = {cls.name: cls for cls in
        (RoundRobinLB, RandomLB, WeightedRoundRobinLB, WeightedRandomLB,
         ConsistentHashLB, ConsistentHashMd5LB, KetamaLB, LocalityAwareLB,
         PrefixAffinityLB)}


def create_load_balancer(name: str) -> LoadBalancer:
    cls = _LBS.get(name or "rr")
    if cls is None:
        raise KeyError(f"unknown load balancer {name!r}; "
                       f"have {sorted(_LBS)}")
    return cls()


def register_load_balancer(name: str, cls) -> None:
    _LBS[name] = cls


class ExcludedServers:
    """Bounded record of servers already tried during one RPC's retries;
    retry selection skips them so a second attempt lands on a different
    replica (reference excluded_servers.h — pooled, capacity-bounded).
    Channel retries build one per call from Controller state; this named
    surface exists for users implementing custom RetryPolicy/LBs."""

    def __init__(self, capacity: int = 8):
        self._capacity = capacity
        self._eps: list = []

    def add(self, endpoint) -> None:
        if len(self._eps) < self._capacity:
            self._eps.append(endpoint)

    def is_excluded(self, endpoint) -> bool:
        return endpoint in self._eps

    def as_set(self) -> set:
        return set(self._eps)

    def __len__(self) -> int:
        return len(self._eps)

    def __contains__(self, endpoint) -> bool:
        return endpoint in self._eps
