"""RemoteBackend: the network as a fourth pluggable inference backend.

Implements the ``InferenceBackend`` surface over the versioned JSON/SSE wire
protocol served by ``repro_torch.serve.server`` — stdlib ``http.client`` only, no
model code, no JAX — so ``Client(RemoteBackend(url))`` (or
``Client.connect(url)``) is a drop-in for the artifact/engine/local backends
and bit-identical to them under injected uniforms (the uniforms cross the
wire as raw little-endian bytes, and tokens/ages round-trip exactly through
JSON numbers).

Connection policy: the server speaks HTTP/1.1 with keep-alive, so this
backend holds **one persistent connection** and pipelines sequential JSON
calls over it instead of paying a TCP handshake per request (the req/s
delta is measured by ``benchmarks/run.py http``; pass ``keep_alive=False``
to get the old socket-per-call behaviour).  A stale pooled socket (server
restarted, idle timeout) is retried once on a fresh connection.  SSE
streams are close-delimited and always use a dedicated connection.

The server is the source of truth for validation: a bad request comes back
as ``{"error": {"code", "message"}}`` and is re-raised here as the *same*
typed ``repro_torch.api.errors.ApiError`` subclass an in-process backend would
have raised, so error handling is backend-agnostic too.  Cancellation
(``cancel(request_id)`` -> ``POST /v1/cancel``) propagates to engine slot
eviction server-side; a stream cancelled mid-flight terminates with a
``cancelled`` frame, surfaced as ``RequestCancelledError``.

Results keep the serving backend visible: ``result.backend`` is
``"remote[engine]"`` etc., recording both the hop and what answered.
"""
from __future__ import annotations

import http.client
import json
import threading
from typing import Iterator, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from repro_torch.api.client import InferenceBackend
from repro_torch.api.errors import (InternalServerError, ProtocolVersionError,
                              ReplicaUnavailableError, error_from_json)
from repro_torch.api.schemas import (WIRE_PROTOCOL_VERSION, FuturesRequest,
                               FuturesResult, GenerateRequest, RiskReport,
                               TrajectoryEvent, TrajectoryResult)

__all__ = ["RemoteBackend"]


class RemoteBackend(InferenceBackend):
    """Client half of the wire protocol (see ``repro_torch.serve.server``)."""
    name = "remote"

    def __init__(self, url: str, *, timeout: float = 300.0,
                 connect_timeout: Optional[float] = None,
                 read_timeout: Optional[float] = None,
                 keep_alive: bool = True):
        self.url = url.rstrip("/")
        sp = urlsplit(self.url if "//" in self.url else "http://" + self.url)
        if sp.scheme not in ("http", ""):
            raise ValueError(f"RemoteBackend speaks plain http, not "
                             f"{sp.scheme!r}")
        self._host = sp.hostname or "127.0.0.1"
        self._port = sp.port or 80
        self._base_path = sp.path.rstrip("/")
        # `timeout` is the one-knob form; the split knobs let a router
        # health probe fail fast on a dead replica (small connect_timeout)
        # while long generate calls keep their full read budget
        self.timeout = timeout
        self.connect_timeout = (timeout if connect_timeout is None
                                else connect_timeout)
        self.read_timeout = timeout if read_timeout is None else read_timeout
        self.keep_alive = keep_alive
        self._conn: Optional[http.client.HTTPConnection] = None
        self._conn_lock = threading.Lock()
        #: sockets dialed so far — the keep-alive benchmark/tests assert
        #: this stays at 1 across sequential JSON calls
        self.connections_opened = 0
        try:
            m = self._request("GET", "/v1/manifest")
            v = str(m.get("protocol_version"))
            if v != WIRE_PROTOCOL_VERSION:
                raise ProtocolVersionError(
                    f"server at {self.url} speaks wire protocol {v!r}; this "
                    f"client supports {WIRE_PROTOCOL_VERSION!r}")
        except BaseException:
            # a failed handshake raises out of __init__: the caller never
            # gets the instance, so the pooled socket must not outlive it
            self.close()
            raise
        self.server_manifest = m
        self.remote_backend = str(m.get("backend", "?"))
        mm = m.get("model", {})
        self.seq_len = int(mm["seq_len"])
        self.vocab_size = int(mm["vocab_size"])
        self.has_ages = bool(mm["has_ages"])
        self.max_age = float(mm["max_age"])
        self.death_token = int(mm["death_token"])

    # -- wire plumbing -------------------------------------------------------
    def _open(self) -> http.client.HTTPConnection:
        """Dial under ``connect_timeout``, then rebudget the established
        socket to ``read_timeout`` — raises ``OSError`` on dial failure
        (callers map it to the transport-level ``replica_unavailable``)."""
        self.connections_opened += 1
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=self.connect_timeout)
        try:
            conn.connect()
            if conn.sock is not None:
                conn.sock.settimeout(self.read_timeout)
        except BaseException:
            conn.close()
            raise
        return conn

    def _roundtrip(self, conn, method: str, path: str, body, stream: bool):
        conn.request(method, self._base_path + path, body=body, headers={
            "Content-Type": "application/json",
            "Accept": "text/event-stream" if stream else "application/json"})
        return conn.getresponse()

    def _raise_http(self, status: int, path: str, raw: bytes):
        try:
            err = error_from_json(json.loads(raw.decode("utf-8")))
        except (json.JSONDecodeError, UnicodeDecodeError):
            err = InternalServerError(
                f"HTTP {status} from {self.url}{path}: {raw[:200]!r}")
        raise err

    def _request(self, method: str, path: str, payload: Optional[dict] = None,
                 stream: bool = False, pooled: bool = True):
        body = (json.dumps(payload).encode("utf-8")
                if payload is not None else None)
        if stream or not pooled or not self.keep_alive:
            # dedicated socket: SSE holds its response open until the
            # ``done`` frame, and /v1/cancel must not queue behind the
            # pooled connection's in-flight call (the one it cancels)
            try:
                conn = self._open()
            except OSError as e:
                raise ReplicaUnavailableError(
                    f"cannot reach {self.url}{path}: {e}") from None
            try:
                resp = self._roundtrip(conn, method, path, body, stream)
            except OSError as e:
                conn.close()
                raise ReplicaUnavailableError(
                    f"cannot reach {self.url}{path}: {e}") from None
            if stream:
                if resp.status >= 400:
                    raw = resp.read()
                    conn.close()
                    self._raise_http(resp.status, path, raw)
                return resp, conn
            raw = resp.read()
            conn.close()
        else:
            # A previously-used pooled socket may have been dropped by the
            # server between calls; ONLY that case is retried (once, on a
            # fresh connection).  Timeouts and failures on a fresh socket
            # are never retried — the server may already be executing a
            # non-idempotent request.
            _reuse_errors = (http.client.RemoteDisconnected,
                             ConnectionResetError, BrokenPipeError)
            with self._conn_lock:
                for attempt in (0, 1):
                    fresh = self._conn is None
                    try:
                        conn = self._conn if not fresh else self._open()
                    except OSError as e:
                        raise ReplicaUnavailableError(
                            f"cannot reach {self.url}{path}: {e}") from None
                    self._conn = conn
                    try:
                        resp = self._roundtrip(conn, method, path, body,
                                               stream=False)
                        raw = resp.read()
                    except (http.client.HTTPException, OSError) as e:
                        self._conn = None
                        conn.close()
                        if attempt == 0 and not fresh \
                                and isinstance(e, _reuse_errors):
                            continue          # stale keep-alive socket
                        raise ReplicaUnavailableError(
                            f"cannot reach {self.url}{path}: {e}") from None
                    if resp.will_close:       # server opted out of reuse
                        self._conn = None
                        conn.close()
                    break
        if resp.status >= 400:
            self._raise_http(resp.status, path, raw)
        return json.loads(raw.decode("utf-8"))

    def close(self) -> None:
        """Drop the pooled keep-alive connection (idempotent)."""
        with self._conn_lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def _relabel(self, obj):
        obj.backend = f"{self.name}[{obj.backend or self.remote_backend}]"
        return obj

    # -- InferenceBackend surface --------------------------------------------
    def generate(self, req: GenerateRequest) -> TrajectoryResult:
        out = self._request("POST", "/v1/generate", req.to_json())
        return self._relabel(TrajectoryResult.from_json(out))

    def generate_batch(self, reqs: Sequence[GenerateRequest]
                       ) -> List[TrajectoryResult]:
        out = self._request("POST", "/v1/generate_batch",
                            {"protocol_version": WIRE_PROTOCOL_VERSION,
                             "requests": [r.to_json() for r in reqs]})
        return [self._relabel(TrajectoryResult.from_json(r))
                for r in out.get("results", [])]

    def stream(self, req: GenerateRequest) -> Iterator[TrajectoryEvent]:
        """Per-event SSE: frames yield as the server's engine tick lands.

        Non-generator wrapper: serialization (``rng``) and server-side
        validation errors raise HERE, at the call — the same eager contract
        as the in-process backends."""
        resp, conn = self._request("POST", "/v1/stream", req.to_json(),
                                   stream=True)
        return self._parse_sse(resp, conn)

    def _parse_sse(self, resp, conn) -> Iterator[TrajectoryEvent]:
        try:
            event: Optional[str] = None
            data_lines: List[str] = []
            try:
                for raw in resp:
                    line = raw.decode("utf-8").rstrip("\r\n")
                    if line.startswith("event:"):
                        event = line[len("event:"):].strip()
                    elif line.startswith("data:"):
                        data_lines.append(line[len("data:"):].strip())
                    elif line == "" and event is not None:
                        payload = json.loads("\n".join(data_lines) or "null")
                        if event == "event":
                            yield TrajectoryEvent.from_json(payload)
                        elif event in ("error", "cancelled"):
                            # `cancelled` is the terminal frame of
                            # /v1/cancel — reconstructed as
                            # RequestCancelledError by code
                            raise error_from_json(payload)
                        elif event == "done":
                            return
                        event, data_lines = None, []
            except (http.client.HTTPException, OSError) as e:
                raise ReplicaUnavailableError(
                    f"server at {self.url} went away mid-stream: "
                    f"{e}") from None
            # a clean close with no terminal frame is the same condition:
            # the server died between events (SSE is close-delimited)
            raise ReplicaUnavailableError(
                f"server at {self.url} closed the SSE stream without a "
                f"terminal frame")
        finally:
            resp.close()
            conn.close()

    def cancel(self, request_id: str) -> bool:
        """Server-side cancellation: ``POST /v1/cancel`` evicts the request
        from its engine slot (blocks freed) and waiters get the structured
        ``request_cancelled`` error / ``cancelled`` SSE frame.  Sent on a
        dedicated connection so it can overtake the pooled connection's
        in-flight call — usually exactly the one being cancelled."""
        out = self._request("POST", "/v1/cancel",
                            {"protocol_version": WIRE_PROTOCOL_VERSION,
                             "request_id": str(request_id)},
                            pooled=False)
        return bool(out.get("cancelled"))

    def sample_futures(self, req: FuturesRequest) -> FuturesResult:
        """Monte-Carlo futures over the wire (``POST /v1/futures``): the
        server fans the N continuations out through its backend — on an
        engine server, prefix-shared ``fork`` slots — and returns the
        aggregated ``RiskReport`` plus every trajectory, bit-identical to
        an in-process engine under injected uniforms (the uniforms cross
        as raw little-endian bytes)."""
        out = self._request("POST", "/v1/futures", req.to_json())
        res = FuturesResult.from_json(out)
        self._relabel(res)
        self._relabel(res.risk)
        for t in res.trajectories:
            self._relabel(t)
        return res

    def risk(self, tokens: Sequence[int],
             ages: Optional[Sequence[float]] = None, *,
             horizon: float = 5.0, top: int = 10) -> RiskReport:
        payload: dict = {"protocol_version": WIRE_PROTOCOL_VERSION,
                         "tokens": [int(t) for t in tokens],
                         "horizon": float(horizon), "top": int(top)}
        if ages is not None:
            payload["ages"] = [float(a) for a in ages]
        out = self._request("POST", "/v1/risk", payload)
        return self._relabel(RiskReport.from_json(out))

    def logits(self, tokens, ages=None):
        raise NotImplementedError(
            "the wire protocol exposes risk(), not raw logits — the paper's "
            "privacy boundary keeps bulk logit export off the service "
            "surface; use risk() or an in-process backend")

    def healthz(self) -> dict:
        return self._request("GET", "/v1/healthz")
