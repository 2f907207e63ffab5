"""Multi-replica serving tier of the port: a prefix-affinity router over N
engines (the JAX package's ``serve/router.py``, on the port's servers).

One ``BatchedEngine`` behind one ``InferenceServer`` tops out at a single
device's paged pool.  This module puts N independent servers behind ONE
wire endpoint, with requests routed so that shared patient histories land
on the replica whose copy-on-write block pool already holds their prefix.
Three parts:

* :class:`ReplicaSupervisor` — owns the replica set.  It can *spawn*
  replicas as ``python -m repro_torch.serve.server`` subprocesses, boot
  them *in-process* (each an ``InferenceServer`` on an ephemeral port), or
  *adopt* already-running URLs.  A background prober hits each replica's
  ``/v1/healthz``; ``max_probe_failures`` consecutive failures mark it
  unhealthy (a later success restores it), and ``drain(name)`` stops
  admitting to a replica, waits for its in-flight requests to finish, then
  stops it.

* :class:`PrefixAffinityScheduler` — reuses ``serve/prefix.py``'s chained
  blake2b chunk digests (:func:`repro_torch.serve.prefix.prompt_digests`): the
  router remembers which replica it sent each full-block prefix digest to,
  so a request whose history extends an already-routed prefix goes to the
  replica whose resident ``PrefixIndex`` can admit it by reference.  No
  match falls back to least-loaded (most free pool blocks from the last
  health probe, then fewest in-flight).

* :class:`RouterServer` — the stdlib HTTP front-end (same
  ``ThreadingHTTPServer`` pattern as ``serve/server.py``) proxying every
  ``/v1/*`` endpoint over per-replica :class:`~repro_torch.api.RemoteBackend`
  connection pools.  Idempotent calls (generate / generate_batch / risk,
  and futures whose ``request_id`` the router itself assigned) are retried
  once on a different healthy replica when the first pick fails at the
  transport level; ``stream``/``cancel``/``futures`` for a given
  ``request_id`` are pinned to one replica (so cancellation finds the
  engine that holds the slot); and when no healthy replica remains the
  structured ``replica_unavailable`` error surfaces — including as the
  terminal SSE ``error`` frame of a pinned stream whose replica died
  mid-flight, which is never retried (a replay would duplicate emitted
  events).  ``/v1/healthz`` rolls up per-replica health/pool stats plus the
  scheduler's affinity-vs-fallback counters and each replica's prefix
  hit-rate delta between probes.

Run:  ``python -m repro_torch.serve.server --config delphi-2m --replicas 2``
"""
from __future__ import annotations

import http.client
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import replace as dc_replace
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from repro_torch.api.errors import (ApiError, InternalServerError,
                              InvalidRequestError, ReplicaUnavailableError)
from repro_torch.api.schemas import (WIRE_PROTOCOL_VERSION, FuturesRequest,
                               FuturesResult, GenerateRequest, RiskReport,
                               TrajectoryResult, check_protocol)
from repro_torch.serve.prefix import prompt_digests

__all__ = ["ReplicaHandle", "ReplicaSupervisor", "PrefixAffinityScheduler",
           "RouterServer", "build_router"]

ROUTER_NAME = "repro-router/0.1"


def _get_json(url: str, path: str, timeout: float) -> dict:
    """One lightweight GET round-trip (no RemoteBackend handshake) — the
    health-probe primitive.  Raises ``OSError`` on any transport or
    non-200 condition so the prober counts it as a single failure."""
    sp = urlsplit(url if "//" in url else "http://" + url)
    conn = http.client.HTTPConnection(sp.hostname or "127.0.0.1",
                                      sp.port or 80, timeout=timeout)
    try:
        conn.request("GET", (sp.path.rstrip("/")) + path)
        resp = conn.getresponse()
        raw = resp.read()
        if resp.status != 200:
            raise OSError(f"HTTP {resp.status} from {url}{path}")
        try:
            return json.loads(raw.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise OSError(f"undecodable healthz from {url}: {e}") from None
    finally:
        conn.close()


def _free_port(host: str = "127.0.0.1") -> int:
    import socket
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# Replica handle
# ---------------------------------------------------------------------------
class ReplicaHandle:
    """One serving replica as the router sees it: an address, a pool of
    keep-alive ``RemoteBackend`` connections, and health/load state.

    The connection pool exists because a ``RemoteBackend``'s pooled socket
    serializes callers: one backend per concurrent proxied request keeps
    the router's throughput at the replica's admission width instead of 1.
    Released backends return to the pool (capped at ``max_pool``; excess
    and transport-failed ones close).
    """

    def __init__(self, name: str, url: str, *,
                 server=None, proc: Optional[subprocess.Popen] = None,
                 connect_timeout: float = 5.0, read_timeout: float = 300.0,
                 max_pool: int = 8, max_failures: int = 3):
        self.name = name
        self.url = url.rstrip("/")
        self.server = server            # owned in-process InferenceServer
        self.proc = proc                # owned server subprocess
        self.connect_timeout = connect_timeout
        self.read_timeout = read_timeout
        self.max_pool = max_pool
        self.max_failures = max_failures
        self._lock = threading.Lock()
        self._pool: List = []                       # guarded-by: _lock
        self._healthy = True                        # guarded-by: _lock
        self._accepting = True                      # guarded-by: _lock
        self._failures = 0                          # guarded-by: _lock
        self._inflight = 0                          # guarded-by: _lock
        self._last_health: Optional[dict] = None    # guarded-by: _lock
        self._prev_prefix: Optional[dict] = None    # guarded-by: _lock
        self._prefix_delta: Optional[dict] = None   # guarded-by: _lock
        self._dialed = 0                            # guarded-by: _lock

    # -- connection pool ------------------------------------------------------
    def acquire(self):
        """A ``RemoteBackend`` for one proxied call — pooled, or freshly
        dialed (handshake included) outside the lock.  Dial failures raise
        ``replica_unavailable`` like any other transport failure."""
        with self._lock:
            if self._pool:
                return self._pool.pop()
            self._dialed += 1
        from repro_torch.api.remote import RemoteBackend
        try:
            return RemoteBackend(self.url,
                                 connect_timeout=self.connect_timeout,
                                 read_timeout=self.read_timeout)
        except ReplicaUnavailableError:
            raise
        except OSError as e:
            raise ReplicaUnavailableError(
                f"cannot dial replica {self.name} at {self.url}: "
                f"{e}") from None

    def release(self, rb) -> None:
        """Return a healthy connection to the pool (or close the excess)."""
        with self._lock:
            if self._healthy and len(self._pool) < self.max_pool:
                self._pool.append(rb)
                return
        rb.close()

    def discard(self, rb) -> None:
        """Close a connection that saw a transport failure."""
        rb.close()

    def _drain_pool(self) -> List:
        with self._lock:
            pool, self._pool = self._pool, []
        return pool

    # -- load accounting ------------------------------------------------------
    def begin_request(self) -> None:
        with self._lock:
            self._inflight += 1

    def end_request(self) -> None:
        with self._lock:
            self._inflight = max(self._inflight - 1, 0)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    # -- health ---------------------------------------------------------------
    @property
    def healthy(self) -> bool:
        with self._lock:
            return self._healthy

    @property
    def accepting(self) -> bool:
        with self._lock:
            return self._healthy and self._accepting

    def set_accepting(self, flag: bool) -> None:
        with self._lock:
            self._accepting = flag

    def probe_ok(self, health: dict) -> None:
        """A healthz probe landed: restore health, compute the prefix
        hit-rate delta vs the previous probe (affinity effectiveness as
        the replica itself observed it)."""
        prefix = None
        eng = health.get("engine") if isinstance(health, dict) else None
        if isinstance(eng, dict):
            mem = eng.get("memory") or {}
            prefix = mem.get("prefix_cache")
        with self._lock:
            self._failures = 0
            self._healthy = True
            self._last_health = health
            if isinstance(prefix, dict):
                prev = self._prev_prefix or {}
                self._prefix_delta = {
                    "hit_rate": prefix.get("hit_rate"),
                    "hits_delta": (prefix.get("hits", 0)
                                   - prev.get("hits", 0)),
                    "partial_hits_delta": (prefix.get("partial_hits", 0)
                                           - prev.get("partial_hits", 0)),
                }
                self._prev_prefix = prefix

    def probe_failed(self) -> bool:
        """Count one probe failure; returns True when this crossing marks
        the replica unhealthy."""
        with self._lock:
            self._failures += 1
            if self._failures >= self.max_failures and self._healthy:
                self._healthy = False
                return True
            return False

    def mark_unhealthy(self) -> bool:
        """A proxied call failed at the transport level — decisive evidence
        (connection refused / dropped mid-response), so the replica goes
        unhealthy immediately; the prober restores it on its next
        successful ``/v1/healthz``.  Returns True on the healthy->unhealthy
        edge."""
        with self._lock:
            self._failures = max(self._failures, self.max_failures)
            was = self._healthy
            self._healthy = False
        return was

    def free_blocks(self) -> Optional[int]:
        """Free pool blocks from the last health probe (the least-loaded
        routing signal); None when unknown (no probe yet / host backend)."""
        with self._lock:
            h = self._last_health
        eng = h.get("engine") if isinstance(h, dict) else None
        if isinstance(eng, dict):
            mem = eng.get("memory") or {}
            if "blocks_free" in mem:
                return int(mem["blocks_free"])
        return None

    def snapshot(self) -> dict:
        """Healthz rollup entry for this replica."""
        with self._lock:
            return {
                "url": self.url,
                "healthy": self._healthy,
                "accepting": self._accepting,
                "inflight": self._inflight,
                "consecutive_failures": self._failures,
                "connections_dialed": self._dialed,
                "pooled_connections": len(self._pool),
                "prefix": self._prefix_delta,
                "healthz": self._last_health,
            }

    # -- lifecycle ------------------------------------------------------------
    def stop(self, *, kill_timeout: float = 10.0) -> None:
        """Tear the replica down: close pooled connections, then stop the
        owned in-process server or terminate the owned subprocess (adopted
        replicas are left running)."""
        for rb in self._drain_pool():
            rb.close()
        if self.server is not None:
            self.server.stop()
            self.server = None
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=kill_timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=kill_timeout)
            self.proc = None
        with self._lock:
            self._healthy = False
            self._accepting = False

    def kill(self) -> None:
        """Crash simulation (failover tests / the roundtrip storm): an
        in-process replica severs every live connection mid-response
        (``InferenceServer.kill``), a subprocess replica gets SIGKILL —
        either way open streams die without terminal frames, exactly like
        a crashed process.  The router does NOT get its state updated here:
        it must discover the death through its own transport failures and
        probes, which is the code path under test."""
        if self.server is not None:
            server, self.server = self.server, None
            server.kill()
        if self.proc is not None:
            proc, self.proc = self.proc, None
            proc.kill()
            proc.wait(timeout=10.0)
        with self._lock:
            pool, self._pool = self._pool, []
        for rb in pool:
            rb.close()


# ---------------------------------------------------------------------------
# Replica supervisor
# ---------------------------------------------------------------------------
class ReplicaSupervisor:
    """Owns the replica set: spawn/boot/adopt, health-probe, drain-stop.

    ``on_unhealthy(name)`` (set by the router) fires on every
    healthy->unhealthy edge so the scheduler can forget affinities that
    point at a pool that no longer exists.
    """

    def __init__(self, replicas: Sequence[ReplicaHandle], *,
                 probe_interval: float = 2.0, probe_timeout: float = 5.0):
        self.replicas: List[ReplicaHandle] = list(replicas)
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.on_unhealthy: Optional[Callable[[str], None]] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- constructors ---------------------------------------------------------
    @classmethod
    def in_process(cls, make_backend: Callable[[int], object], n: int, *,
                   request_timeout: float = 300.0,
                   connect_timeout: float = 5.0, read_timeout: float = 300.0,
                   **kw) -> "ReplicaSupervisor":
        """Boot ``n`` replicas inside this process, each a fresh backend
        behind its own ``InferenceServer`` on an ephemeral port (engines on
        one device share its kernel library)."""
        from repro_torch.serve.server import InferenceServer
        handles = []
        try:
            for i in range(n):
                server = InferenceServer(make_backend(i), port=0,
                                         request_timeout=request_timeout
                                         ).start()
                handles.append(ReplicaHandle(
                    f"r{i}", server.address, server=server,
                    connect_timeout=connect_timeout,
                    read_timeout=read_timeout))
        except BaseException:
            for h in handles:
                h.stop()
            raise
        return cls(handles, **kw)

    @classmethod
    def spawn(cls, replica_argv: Callable[[int, int], List[str]], n: int, *,
              host: str = "127.0.0.1", python: Optional[str] = None,
              ready_timeout: float = 120.0, connect_timeout: float = 5.0,
              read_timeout: float = 300.0, **kw) -> "ReplicaSupervisor":
        """Spawn ``n`` ``python -m repro_torch.serve.server``
        subprocesses.  ``replica_argv(i, port)`` returns the CLI argv for
        replica ``i`` bound to ``port`` (it must include ``--port
        <port>``); each replica is polled on ``/v1/manifest`` until it
        answers or ``ready_timeout`` passes.  The children find this
        package through ``PYTHONPATH``."""
        py = python or sys.executable
        env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src, env.get("PYTHONPATH")) if p)
        handles: List[ReplicaHandle] = []
        try:
            for i in range(n):
                port = _free_port(host)
                argv = replica_argv(i, port)
                proc = subprocess.Popen(
                    [py, "-m", "repro_torch.serve.server", *argv], env=env)
                handles.append(ReplicaHandle(
                    f"r{i}", f"http://{host}:{port}", proc=proc,
                    connect_timeout=connect_timeout,
                    read_timeout=read_timeout))
            deadline = time.monotonic() + ready_timeout
            for h in handles:
                while True:
                    if h.proc is not None and h.proc.poll() is not None:
                        raise RuntimeError(
                            f"replica {h.name} exited with code "
                            f"{h.proc.returncode} before serving")
                    try:
                        _get_json(h.url, "/v1/manifest", timeout=2.0)
                        break
                    except OSError:
                        if time.monotonic() > deadline:
                            raise RuntimeError(
                                f"replica {h.name} at {h.url} not ready "
                                f"within {ready_timeout}s") from None
                        time.sleep(0.2)
        except BaseException:
            for h in handles:
                h.stop()
            raise
        return cls(handles, **kw)

    @classmethod
    def adopt(cls, urls: Sequence[str], *, connect_timeout: float = 5.0,
              read_timeout: float = 300.0, **kw) -> "ReplicaSupervisor":
        """Front already-running replicas (not owned: never stopped)."""
        handles = [ReplicaHandle(f"r{i}", url,
                                 connect_timeout=connect_timeout,
                                 read_timeout=read_timeout)
                   for i, url in enumerate(urls)]
        return cls(handles, **kw)

    # -- lookup ---------------------------------------------------------------
    def replica(self, name: str) -> ReplicaHandle:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica named {name!r}")

    def healthy(self) -> List[ReplicaHandle]:
        """Replicas currently eligible for new work (healthy + accepting)."""
        return [r for r in self.replicas if r.accepting]

    # -- probing --------------------------------------------------------------
    def probe_once(self) -> None:
        for r in self.replicas:
            try:
                h = _get_json(r.url, "/v1/healthz",
                              timeout=self.probe_timeout)
            except OSError:
                if r.probe_failed() and self.on_unhealthy is not None:
                    self.on_unhealthy(r.name)
            else:
                r.probe_ok(h)

    def _probe_loop(self) -> None:
        while not self._stop_evt.wait(self.probe_interval):
            self.probe_once()

    def start(self) -> "ReplicaSupervisor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop_evt.clear()
        self.probe_once()           # seed load/health before first route
        self._thread = threading.Thread(target=self._probe_loop,
                                        name="repro-router-prober",
                                        daemon=True)
        self._thread.start()
        return self

    # -- drain / teardown -----------------------------------------------------
    def drain(self, name: str, *, timeout: float = 30.0,
              stop: bool = True) -> bool:
        """Stop admitting to ``name``, wait for its in-flight proxied
        requests to finish, then (by default) stop it.  Returns True when
        in-flight hit zero inside ``timeout`` — the replica is stopped
        either way once ``stop`` is set (a stuck request has the engine's
        own request_timeout as backstop)."""
        r = self.replica(name)
        r.set_accepting(False)
        deadline = time.monotonic() + timeout
        drained = False
        while time.monotonic() < deadline:
            if r.inflight == 0:
                drained = True
                break
            time.sleep(0.02)
        if stop:
            r.stop()
            if self.on_unhealthy is not None:
                self.on_unhealthy(name)
        return drained

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        for r in self.replicas:
            r.stop()


# ---------------------------------------------------------------------------
# Prefix-affinity scheduler
# ---------------------------------------------------------------------------
class PrefixAffinityScheduler:
    """Route shared histories to the replica that already holds their KV.

    The router cannot see a replica's ``PrefixIndex``, but it doesn't need
    to: both sides hash (token, age) history through the same chained
    blake2b chunk digests (:func:`repro_torch.serve.prefix.prompt_digests`), so
    remembering *where each full-block digest was last routed* predicts
    residency — a replica that admitted a prompt has indexed exactly those
    chain digests.  ``route`` walks the new prompt's chain from longest
    prefix to shortest and picks the first still-eligible owner; no owner
    falls back to least-loaded (most free blocks from the last probe, then
    fewest in-flight).  The table is LRU-capped, mirroring the replicas'
    own LRU eviction.
    """

    def __init__(self, block_size: int = 16, max_tracked: int = 8192):
        self.block_size = block_size
        self.max_tracked = max_tracked
        self._lock = threading.Lock()
        self._owner: "OrderedDict[bytes, str]" = \
            OrderedDict()                           # guarded-by: _lock
        self._affinity_routed = 0                   # guarded-by: _lock
        self._fallback_routed = 0                   # guarded-by: _lock

    def route(self, tokens, ages,
              candidates: Sequence[ReplicaHandle]
              ) -> Tuple[ReplicaHandle, bool]:
        """Pick a replica for this history from ``candidates`` (all
        currently eligible).  Returns ``(replica, via_affinity)`` and
        records the prompt's chain as owned by the pick."""
        if not candidates:
            raise ReplicaUnavailableError(
                "no healthy replica available to take the request")
        chain, _key = prompt_digests(tokens, ages, self.block_size)
        by_name = {r.name: r for r in candidates}
        with self._lock:
            pick: Optional[ReplicaHandle] = None
            affinity = False
            for i in range(len(chain) - 1, -1, -1):
                owner = self._owner.get(chain[i])
                if owner is not None and owner in by_name:
                    pick = by_name[owner]
                    affinity = True
                    break
            if pick is None:
                pick = self._least_loaded(candidates)
            if affinity:
                self._affinity_routed += 1
            else:
                self._fallback_routed += 1
            for d in chain:
                self._owner[d] = pick.name
                self._owner.move_to_end(d)
            while len(self._owner) > self.max_tracked:
                self._owner.popitem(last=False)
        return pick, affinity

    @staticmethod
    def _least_loaded(candidates: Sequence[ReplicaHandle]) -> ReplicaHandle:
        """Most free pool blocks wins (fresh admissions land where CoW
        headroom is); unknown-pool replicas compare by in-flight only."""
        def load_key(r: ReplicaHandle):
            free = r.free_blocks()
            return (-(free if free is not None else 0), r.inflight)
        return min(candidates, key=load_key)

    def forget(self, name: str) -> int:
        """Drop every affinity pointing at ``name`` (replica died or was
        drained: its resident blocks are gone)."""
        with self._lock:
            dead = [d for d, n in self._owner.items() if n == name]
            for d in dead:
                del self._owner[d]
            return len(dead)

    def stats(self) -> dict:
        with self._lock:
            n = self._affinity_routed + self._fallback_routed
            return {
                "affinity_routed": self._affinity_routed,
                "fallback_routed": self._fallback_routed,
                "affinity_rate": self._affinity_routed / n if n else 0.0,
                "tracked_digests": len(self._owner),
                "block_size": self.block_size,
            }


# ---------------------------------------------------------------------------
# Router HTTP front-end
# ---------------------------------------------------------------------------
class RouterServer:
    """One wire endpoint over N replicas (drop-in for ``InferenceServer``:
    ``Client.connect(router.address)`` works unchanged).

    >>> sup = ReplicaSupervisor.in_process(make_backend, n=2)
    >>> router = RouterServer(sup, port=0).start()
    >>> Client.connect(router.address).generate(tokens=..., ages=...)
    >>> router.stop()
    """

    def __init__(self, supervisor: ReplicaSupervisor,
                 host: str = "127.0.0.1", port: int = 8478, *,
                 block_size: int = 16, quiet: bool = True):
        from repro_torch.serve.server import (  # shared plumbing
            _Handler, _TrackingHTTPServer)
        self.supervisor = supervisor
        self.scheduler = PrefixAffinityScheduler(block_size=block_size)
        supervisor.on_unhealthy = self._replica_lost
        self.quiet = quiet
        self._lock = threading.Lock()
        self._pins: Dict[str, str] = {}             # guarded-by: _lock
        self._rid_seq = itertools.count()
        self._rid_tag = uuid.uuid4().hex[:8]
        handler = type("_BoundRouterHandler", (_RouterHandler, _Handler),
                       {"srv": self})
        self.httpd = _TrackingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.httpd.block_on_close = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------
    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "RouterServer":
        self.supervisor.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="repro-router-http",
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.supervisor.start()
        try:
            self.httpd.serve_forever()
        finally:
            self.stop()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.supervisor.stop()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def drain_replica(self, name: str, *, timeout: float = 30.0) -> bool:
        """Drain-then-stop one replica and drop its affinities."""
        return self.supervisor.drain(name, timeout=timeout)

    # -- request ids / pins ---------------------------------------------------
    def _new_request_id(self) -> str:
        return f"rt-{self._rid_tag}-{next(self._rid_seq)}"

    def _pin(self, request_id: str, replica: ReplicaHandle) -> None:
        with self._lock:
            self._pins[request_id] = replica.name

    def _unpin(self, request_id: str) -> None:
        with self._lock:
            self._pins.pop(request_id, None)

    def pinned_replica(self, request_id: str) -> Optional[str]:
        with self._lock:
            return self._pins.get(request_id)

    def _replica_lost(self, name: str) -> None:
        """Healthy->unhealthy edge (probe threshold / transport failure /
        drain): affinities to its pool are stale — forget them so new
        traffic re-routes instead of chasing a dead prefix."""
        self.scheduler.forget(name)

    def _note_transport_failure(self, replica: ReplicaHandle) -> None:
        if replica.mark_unhealthy():
            self._replica_lost(replica.name)

    # -- routing core ---------------------------------------------------------
    def _candidates(self, exclude: frozenset) -> List[ReplicaHandle]:
        return [r for r in self.supervisor.healthy()
                if r.name not in exclude]

    def _proxied(self, tokens, ages, call, *, pin_id: Optional[str] = None,
                 retry: bool = True):
        """Route -> acquire -> call -> release, with one retry on a
        *different* healthy replica when the pick fails at the transport
        level (``replica_unavailable``).  Protocol-level ``ApiError``s are
        the replica ANSWERING (a validation failure would fail everywhere)
        and propagate without retry."""
        tried: set = set()
        last: Optional[ReplicaUnavailableError] = None
        attempts = 2 if retry else 1
        for _ in range(attempts):
            cands = self._candidates(frozenset(tried))
            if not cands:
                break
            replica, _aff = self.scheduler.route(tokens, ages, cands)
            tried.add(replica.name)
            if pin_id is not None:
                self._pin(pin_id, replica)
            replica.begin_request()
            ok = False
            rb = None
            try:
                rb = replica.acquire()
                out = call(rb, replica)
                ok = True
                return out
            except ReplicaUnavailableError as e:
                last = e
                self._note_transport_failure(replica)
                continue
            finally:
                if rb is not None:
                    (replica.release if ok else replica.discard)(rb)
                replica.end_request()
                if pin_id is not None and not ok:
                    self._unpin(pin_id)
        raise ReplicaUnavailableError(
            "no healthy replica could serve the request"
            + (f" (last failure: {last.message})" if last is not None
               else ""))

    def _relabel(self, obj, replica: ReplicaHandle):
        """``remote[engine]`` (the proxy hop's label) becomes
        ``router[r0:engine]`` — which replica answered stays visible."""
        inner = obj.backend or ""
        if inner.startswith("remote[") and inner.endswith("]"):
            inner = inner[len("remote["):-1]
        obj.backend = f"router[{replica.name}:{inner}]"
        return obj

    # -- endpoint logic (handler threads call these) -------------------------
    def manifest(self) -> dict:
        # not routed through the scheduler: a manifest GET happens on every
        # client handshake and must not count as a fallback-routed request
        last: Optional[ReplicaUnavailableError] = None
        for replica in self.supervisor.healthy():
            rb = None
            try:
                rb = replica.acquire()
                m = rb.server_manifest
            except ReplicaUnavailableError as e:
                last = e
                if rb is not None:
                    replica.discard(rb)
                self._note_transport_failure(replica)
                continue
            replica.release(rb)
            out = dict(m)
            out["server"] = ROUTER_NAME
            out["backend"] = f"router[{m.get('backend', '?')}]"
            out["router"] = {
                "replicas": {r.name: r.url
                             for r in self.supervisor.replicas},
            }
            return out
        raise ReplicaUnavailableError(
            "no healthy replica could serve the manifest"
            + (f" (last failure: {last.message})" if last is not None
               else ""))

    def healthz(self) -> dict:
        replicas = {r.name: r.snapshot()
                    for r in self.supervisor.replicas}
        healthy = [n for n, s in replicas.items() if s["healthy"]]
        sched = self.scheduler.stats()
        with self._lock:
            pinned = len(self._pins)
        # fleet-wide chunked-prefill counters summed from the replicas'
        # last probes (each replica's full healthz stays available below)
        prefill = {"chunked_prefills": 0, "prefill_chunks": 0,
                   "prefill_in_progress": 0, "suffix_tokens_saved": 0}
        for s in replicas.values():
            eng = (s.get("healthz") or {}).get("engine")
            mem = eng.get("memory") if isinstance(eng, dict) else None
            if isinstance(mem, dict):
                for k in prefill:
                    prefill[k] += int(mem.get(k) or 0)
        return {
            "ok": bool(healthy),
            "backend": "router",
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "router": {
                "server": ROUTER_NAME,
                "replicas": replicas,
                "healthy_replicas": len(healthy),
                "scheduler": sched,
                "pinned_requests": pinned,
                "prefill": prefill,
            },
        }

    def generate(self, req: GenerateRequest) -> TrajectoryResult:
        rid = req.request_id or self._new_request_id()
        req = dc_replace(req, request_id=rid)

        def call(rb, replica):
            return self._relabel(rb.generate(req), replica)
        try:
            res = self._proxied(req.tokens, req.ages, call, pin_id=rid)
        finally:
            self._unpin(rid)
        res.request_id = rid
        return res

    def generate_batch(self, reqs: List[GenerateRequest]
                       ) -> List[TrajectoryResult]:
        if not reqs:
            return []
        pin_ids = [r.request_id for r in reqs if r.request_id is not None]
        first = reqs[0]

        def call(rb, replica):
            for pid in pin_ids:
                self._pin(pid, replica)
            out = rb.generate_batch(reqs)
            return [self._relabel(r, replica) for r in out]
        try:
            results = self._proxied(first.tokens, first.ages, call)
        finally:
            for pid in pin_ids:
                self._unpin(pid)
        for req, res in zip(reqs, results):
            res.request_id = req.request_id
        return results

    def sample_futures(self, req: FuturesRequest) -> FuturesResult:
        # a client-chosen id is a cancellation handle the client may
        # already be using: it pins the request to ONE replica (no retry);
        # a router-assigned id exists only for pinning and is safe to
        # re-route before any response was produced
        client_pinned = req.request_id is not None
        rid = req.request_id or self._new_request_id()
        req = dc_replace(req, request_id=rid)

        def call(rb, replica):
            out = rb.sample_futures(req)
            self._relabel(out, replica)
            self._relabel(out.risk, replica)
            for t in out.trajectories:
                self._relabel(t, replica)
            return out
        try:
            return self._proxied(req.tokens, req.ages, call, pin_id=rid,
                                 retry=not client_pinned)
        finally:
            self._unpin(rid)

    def risk(self, d: dict) -> RiskReport:
        check_protocol(d)
        tokens = d.get("tokens")
        if tokens is None:
            raise InvalidRequestError("missing required field 'tokens'")
        try:
            tokens = [int(t) for t in tokens]
            ages = ([float(a) for a in d["ages"]]
                    if d.get("ages") is not None else None)
            horizon = float(d.get("horizon", 5.0))
            top = int(d.get("top", 10))
        except (ValueError, TypeError) as e:
            raise InvalidRequestError(
                f"malformed risk request field: {e}") from e

        def call(rb, replica):
            return self._relabel(
                rb.risk(tokens, ages, horizon=horizon, top=top), replica)
        return self._proxied(tokens, ages, call)

    def cancel(self, d: dict) -> dict:
        check_protocol(d)
        rid = d.get("request_id") if isinstance(d, dict) else None
        if not rid:
            raise InvalidRequestError("missing required field 'request_id'")
        rid = str(rid)
        pinned = self.pinned_replica(rid)
        if pinned is not None:
            targets = [self.supervisor.replica(pinned)]
        else:
            # unknown pin (already completed, or a pre-router id): fan the
            # cancel out — an engine that never saw the id answers False
            targets = self.supervisor.healthy()
        cancelled = False
        replica_name = None
        for replica in targets:
            if not replica.healthy:
                continue
            rb = None
            try:
                rb = replica.acquire()
                if rb.cancel(rid):
                    cancelled = True
                    replica_name = replica.name
            except ReplicaUnavailableError:
                self._note_transport_failure(replica)
            finally:
                if rb is not None:
                    replica.release(rb)
        return {"protocol_version": WIRE_PROTOCOL_VERSION,
                "request_id": rid, "cancelled": cancelled,
                "replica": replica_name}

    # -- streaming proxy ------------------------------------------------------
    def stream_frames(self, req: GenerateRequest
                      ) -> Iterator[Tuple[str, str]]:
        """Proxy ``/v1/stream``: yields raw SSE ``(event_name, data_json)``
        frames from the routed replica.  ``event`` frames pass through
        verbatim (bit-identical to the direct server); the terminal
        ``done`` frame is rewritten to carry the router backend label and
        the routed request id.  Once frames are flowing the stream is
        PINNED: a replica dying mid-flight terminates with a structured
        ``replica_unavailable`` error frame, never a silent replay on a
        survivor (events already emitted cannot be un-emitted)."""
        rid = req.request_id or self._new_request_id()
        req = dc_replace(req, request_id=rid)
        tried: set = set()
        last: Optional[ReplicaUnavailableError] = None
        for _ in range(2):
            cands = self._candidates(frozenset(tried))
            if not cands:
                break
            replica, _aff = self.scheduler.route(req.tokens, req.ages, cands)
            tried.add(replica.name)
            self._pin(rid, replica)
            replica.begin_request()
            rb = replica.acquire()
            try:
                # dedicated socket (stream=True): the pooled rb connection
                # is untouched, so the backend returns to the pool as soon
                # as the response handle exists
                resp, conn = rb._request("POST", "/v1/stream",
                                         req.to_json(), stream=True)
            except ReplicaUnavailableError as e:
                # the POST itself never reached the replica: nothing was
                # emitted, so re-routing is still safe
                last = e
                replica.discard(rb)
                replica.end_request()
                self._unpin(rid)
                self._note_transport_failure(replica)
                continue
            except BaseException:
                replica.release(rb)
                replica.end_request()
                self._unpin(rid)
                raise
            replica.release(rb)
            return self._forward_sse(resp, conn, replica, rid)
        self._unpin(rid)
        raise ReplicaUnavailableError(
            "no healthy replica could take the stream"
            + (f" (last failure: {last.message})" if last is not None
               else ""))

    def _forward_sse(self, resp, conn, replica: ReplicaHandle, rid: str
                     ) -> Iterator[Tuple[str, str]]:
        try:
            event: Optional[str] = None
            data_lines: List[str] = []
            saw_terminal = False
            try:
                for raw in resp:
                    line = raw.decode("utf-8").rstrip("\r\n")
                    if line.startswith("event:"):
                        event = line[len("event:"):].strip()
                    elif line.startswith("data:"):
                        data_lines.append(line[len("data:"):].strip())
                    elif line == "" and event is not None:
                        data = "\n".join(data_lines)
                        if event == "done":
                            data = self._rewrite_done(data, replica, rid)
                        yield event, data
                        if event in ("done", "error", "cancelled"):
                            saw_terminal = True
                            return
                        event, data_lines = None, []
            except (http.client.HTTPException, OSError) as e:
                saw_terminal = True
                # mark the replica BEFORE yielding: a consumer that closes
                # the generator at the error frame must not skip it
                self._note_transport_failure(replica)
                yield "error", json.dumps(ReplicaUnavailableError(
                    f"replica {replica.name} went away mid-stream: {e}"
                ).to_json())
                return
            if not saw_terminal:
                # clean close without a terminal frame: the replica died
                # between events (its SSE is close-delimited)
                self._note_transport_failure(replica)
                yield "error", json.dumps(ReplicaUnavailableError(
                    f"replica {replica.name} closed the stream without a "
                    f"terminal frame").to_json())
        finally:
            resp.close()
            conn.close()
            replica.end_request()
            self._unpin(rid)

    def _rewrite_done(self, data: str, replica: ReplicaHandle,
                      rid: str) -> str:
        try:
            body = json.loads(data or "null")
            res = TrajectoryResult.from_json(body)
        except (ApiError, ValueError, TypeError):
            return data                     # forward unparseable verbatim
        self._relabel(res, replica)
        res.request_id = rid
        return json.dumps(res.to_json())


# ---------------------------------------------------------------------------
# Handler: reuse the server's plumbing, override only the SSE proxy
# ---------------------------------------------------------------------------
class _RouterHandler:
    """Mixed in before ``serve.server._Handler``: all JSON endpoints reuse
    the handler verbatim (they call same-named ``srv`` methods); only the
    stream path differs — the router forwards raw SSE frames instead of
    re-assembling ``TrajectoryEvent`` objects."""
    server_version = ROUTER_NAME

    def _sse_raw(self, event: str, data: str) -> None:
        self.wfile.write(f"event: {event}\n".encode("utf-8"))
        self.wfile.write(f"data: {data}\n\n".encode("utf-8"))
        self.wfile.flush()

    def _do_stream(self) -> None:
        req = GenerateRequest.from_json(self._read_json())
        frames = self.srv.stream_frames(req)
        # pull the first frame BEFORE committing to SSE, so routing and
        # replica-side validation failures still map to HTTP statuses
        first: Tuple[Tuple[str, str], ...] = ()
        try:
            frame = next(frames)
            first = (frame,)
        except StopIteration:
            pass
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True        # SSE is close-delimited
        try:
            for name, data in itertools.chain(first, frames):
                self._sse_raw(name, data)
        except (BrokenPipeError, ConnectionResetError):
            # client went away: unwind the proxy generator so it unpins
            # and closes the upstream connection
            frames.close()
        except ApiError as e:               # mid-stream: headers are out —
            self._sse_raw("error", json.dumps(e.to_json()))
        except Exception as e:              # noqa: BLE001
            self._sse_raw("error", json.dumps(InternalServerError(
                f"{type(e).__name__}: {e}").to_json()))


# ---------------------------------------------------------------------------
# CLI glue (`python -m repro_torch.serve.server --replicas N`)
# ---------------------------------------------------------------------------
def build_router(args) -> RouterServer:
    """Build the router described by the server's CLI namespace:
    ``--replicas N`` in-process or subprocess replicas (or ``--replica-urls``
    to adopt running ones), fronted on ``--host``/``--port``."""
    block_size = getattr(args, "block_size", 16) or 16
    if getattr(args, "replica_urls", None):
        urls = [u for u in args.replica_urls.split(",") if u]
        sup = ReplicaSupervisor.adopt(
            urls, read_timeout=args.request_timeout)
    elif args.replica_mode == "subprocess":
        base = _replica_argv_base(args)

        def replica_argv(i: int, port: int) -> List[str]:
            return base + ["--host", args.host, "--port", str(port),
                           "--seed", str(args.seed)]
        sup = ReplicaSupervisor.spawn(replica_argv, args.replicas,
                                      host=args.host,
                                      read_timeout=args.request_timeout)
    else:
        make_backend = _shared_params_backend_factory(args)
        sup = ReplicaSupervisor.in_process(
            make_backend, args.replicas,
            request_timeout=args.request_timeout,
            read_timeout=args.request_timeout)
    return RouterServer(sup, args.host, args.port, block_size=block_size,
                        quiet=not getattr(args, "verbose", False))


def _replica_argv_base(args) -> List[str]:
    """Forward the model/engine knobs of the router's CLI namespace to a
    subprocess replica's argv (everything but host/port/seed)."""
    argv: List[str] = []
    if args.artifact:
        argv += ["--artifact", args.artifact]
    else:
        argv += ["--config", args.config]
        if args.reduced:
            argv.append("--reduced")
        argv += ["--backend", args.backend, "--device", args.device]
        if args.ckpt:
            argv += ["--ckpt", args.ckpt]
    argv += ["--slots", str(args.slots),
             "--max-context", str(args.max_context),
             "--cache", args.cache,
             "--block-size", str(args.block_size),
             "--request-timeout", str(args.request_timeout)]
    if args.blocks is not None:
        argv += ["--blocks", str(args.blocks)]
    if getattr(args, "prefill_chunk_tokens", None) is not None:
        argv += ["--prefill-chunk-tokens", str(args.prefill_chunk_tokens)]
    if args.prefix_cache is True:
        argv.append("--prefix-cache")
    elif args.prefix_cache is False:
        argv.append("--no-prefix-cache")
    return argv


def _shared_params_backend_factory(args) -> Callable[[int], object]:
    """In-process replicas share ONE parameter set on one device, so N
    replicas cost N KV pools — not N models."""
    from repro_torch.serve.server import _build_backend
    first = _build_backend(args)
    from repro_torch.api.client import EngineBackend, LocalBackend
    if isinstance(first, LocalBackend):
        made = [first]

        def make_backend(i: int):
            if made:
                return made.pop()
            return LocalBackend(first.params, first.cfg,
                                device=first.device)
        return make_backend
    assert isinstance(first, EngineBackend)
    params, cfg = first.params, first.cfg
    engine_kw = dict(
        slots=args.slots, max_context=args.max_context, cache=args.cache,
        blocks=args.blocks, block_size=args.block_size,
        request_timeout=args.request_timeout,
        prefix_cache=first.engine.prefix is not None,
        prefill_chunk_tokens=getattr(args, "prefill_chunk_tokens", None),
        device=first.engine.device)
    made = [first]

    def make_backend(i: int):
        if made:
            return made.pop()
        return EngineBackend.create(params, cfg, **engine_kw)
    return make_backend
