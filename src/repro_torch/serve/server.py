"""HTTP/SSE front-end of the port: the wire-protocol half of serving.

A stdlib-only (``http.server``) threaded server that exposes any
``repro_torch.api`` backend over the versioned JSON wire protocol of
``repro_torch.api.schemas``, the same protocol as the JAX package's
``repro-serve``: either package's ``RemoteBackend`` drives either server.
``repro_torch.api.RemoteBackend`` is the matching client half
(``Client.connect(url)``).

Endpoints (all under ``/v1``; schemas are the canonical ``to_json`` forms):

=====================  ======  ===============================================
``/v1/generate``       POST    GenerateRequest -> TrajectoryResult
``/v1/generate_batch`` POST    {"requests": [...]} -> {"results": [...]}
``/v1/risk``           POST    {tokens, ages?, horizon?, top?} -> RiskReport
``/v1/futures``        POST    FuturesRequest -> FuturesResult (N Monte-
                               Carlo futures of one history, aggregated
                               into a RiskReport; engine backends fan out
                               through prefix-shared ``fork`` slots)
``/v1/stream``         POST    GenerateRequest -> SSE: one ``event:`` frame
                               per TrajectoryEvent, then ``done`` carrying
                               the assembled TrajectoryResult (``error``
                               frame on mid-stream failure)
``/v1/manifest``       GET     protocol version, model/termination metadata,
                               endpoint map
``/v1/healthz``        GET     liveness + engine stats
=====================  ======  ===============================================

Error contract: every failure is a ``repro_torch.api.errors.ApiError`` rendered as
``{"error": {"code", "message"}}`` with the taxonomy's 1:1 HTTP status —
validation failures surface with the same stable codes whether the backend
is local or remote.

Concurrency: ``ThreadingHTTPServer`` gives one handler thread per
connection.  An :class:`~repro_torch.api.client.EngineBackend` gets **async
admission** — the engine ticks on its own background thread
(``BatchedEngine.start()``, idle backoff when no slot is active) and handler
threads merely enqueue requests and park on completion hooks, so concurrent
requests continuously batch onto engine slots.  The loop's thread and the
handler threads that run ``/v1/risk``'s forward all launch on the default
stream.  Host-loop backends (local) are serialized by a lock.

Run:  ``python -m repro_torch.serve.server --config delphi-2m
      [--device cuda] [--ckpt DIR] [--cache paged] [--replicas 2]``
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, List, Optional, Tuple
from urllib.parse import urlsplit

from repro_torch.api.errors import (ApiError, InternalServerError,
                              InvalidRequestError, RequestCancelledError,
                              UnknownEndpointError)
from repro_torch.api.schemas import (WIRE_PROTOCOL_VERSION, FuturesRequest,
                               FuturesResult, GenerateRequest,
                               TrajectoryEvent, TrajectoryResult,
                               check_protocol)

SERVER_NAME = "repro-torch-serve/0.1"

_ENDPOINTS = {
    "generate": {"method": "POST", "path": "/v1/generate"},
    "generate_batch": {"method": "POST", "path": "/v1/generate_batch"},
    "risk": {"method": "POST", "path": "/v1/risk"},
    "futures": {"method": "POST", "path": "/v1/futures"},
    "stream": {"method": "POST", "path": "/v1/stream", "content": "sse"},
    "cancel": {"method": "POST", "path": "/v1/cancel"},
    "manifest": {"method": "GET", "path": "/v1/manifest"},
    "healthz": {"method": "GET", "path": "/v1/healthz"},
}


class _TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that remembers its accepted sockets so
    :meth:`sever_connections` can cut every live connection (keep-alive and
    mid-SSE included) — ``shutdown()`` only stops NEW accepts, which makes
    a graceful stop but not a crash.  The router's failover tests use this
    to simulate an in-process replica dying mid-stream.

    The listen backlog is 128, not the stdlib's 5: a burst of clients that
    connect while the engine's loop holds the interpreter lock overflows 5,
    the kernel drops the connections past it, and each of those clients
    waits 1 s to retry."""
    request_queue_size = 128

    def __init__(self, *a, **kw):
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(*a, **kw)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def sever_connections(self) -> int:
        with self._conns_lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass                        # already gone
        return len(conns)


class InferenceServer:
    """Threaded HTTP wrapper around one ``repro_torch.api`` backend.

    >>> server = InferenceServer(EngineBackend(engine), port=0)  # ephemeral
    >>> server.start()
    >>> Client.connect(server.address).generate(tokens=..., ages=...)
    >>> server.stop()
    """

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 8478,
                 *, request_timeout: float = 300.0, quiet: bool = True):
        from repro_torch.api.client import EngineBackend
        self.backend = backend
        self.quiet = quiet
        self._is_engine = isinstance(backend, EngineBackend)
        if self._is_engine:
            backend.request_timeout = request_timeout
        # host-loop backends run the model on the handler thread: serialize
        # them (the engine serializes on its own tick thread instead)
        self._serial = threading.Lock()
        handler = type("_BoundHandler", (_Handler,), {"srv": self})
        self.httpd = _TrackingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        # never join handler threads on close: a stalled client (open
        # connection, unread SSE) would park stop() forever
        self.httpd.block_on_close = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "InferenceServer":
        """Serve on a daemon thread (embedding / tests); returns self."""
        if self._is_engine:
            self.backend.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="repro-torch-serve-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread (the CLI entry point)."""
        if self._is_engine:
            self.backend.engine.start()
        try:
            self.httpd.serve_forever()
        finally:
            self.stop()

    def stop(self) -> None:
        self.httpd.shutdown()
        # engine first: in-flight waiters parked in handler threads get
        # their immediate failure before the listener is torn down
        if self._is_engine:
            self.backend.engine.stop()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def kill(self) -> None:
        """Crash simulation (in-process replica failover tests): sever every
        live connection FIRST — an open SSE response dies without a terminal
        frame, keep-alive sockets reset — then tear down like :meth:`stop`.
        A graceful stop would let handler threads flush structured error
        frames, which a crashed process never does."""
        self.httpd.sever_connections()
        self.stop()

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- endpoint logic (handler threads call these) -------------------------
    def _exclusive(self):
        """Model-executing section for host-loop backends; no-op for the
        engine, whose tick thread is the serialization point."""
        if self._is_engine:
            return contextlib.nullcontext()
        return self._serial

    def manifest(self) -> dict:
        b = self.backend
        m = {
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "server": SERVER_NAME,
            "backend": b.name,
            "model": {
                "seq_len": int(b.seq_len),
                "vocab_size": int(b.vocab_size),
                "has_ages": bool(b.has_ages),
                "max_age": float(b.max_age),
                "death_token": int(b.death_token),
            },
            "endpoints": _ENDPOINTS,
        }
        return m

    def healthz(self) -> dict:
        h = {"ok": True, "backend": self.backend.name,
             "protocol_version": WIRE_PROTOCOL_VERSION}
        if self._is_engine:
            # one locked snapshot from the engine rather than poking its
            # guarded fields from this handler thread (RL001)
            h["engine"] = self.backend.engine.health_stats()
        return h

    def cancel(self, d: dict) -> dict:
        check_protocol(d)
        rid = d.get("request_id") if isinstance(d, dict) else None
        if not rid:
            raise InvalidRequestError("missing required field 'request_id'")
        return {"protocol_version": WIRE_PROTOCOL_VERSION,
                "request_id": str(rid),
                "cancelled": bool(self.backend.cancel(str(rid)))}

    def generate(self, req: GenerateRequest) -> TrajectoryResult:
        with self._exclusive():
            return self.backend.generate(req)

    def generate_batch(self, reqs: List[GenerateRequest]
                       ) -> List[TrajectoryResult]:
        with self._exclusive():
            return self.backend.generate_batch(reqs)

    def sample_futures(self, req: FuturesRequest) -> FuturesResult:
        with self._exclusive():
            return self.backend.sample_futures(req)

    def risk(self, d: dict):
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
        with self._serial:        # logits run on the handler thread for
            return self.backend.risk(   # every backend, engine included
                tokens, ages, horizon=horizon, top=top)

    def stream(self, req: GenerateRequest) -> Iterator[TrajectoryEvent]:
        it = self.backend.stream(req)
        lock = None if self._is_engine else self._serial
        while True:
            # hold the lock only across the model step that produces the
            # next event, never across the socket write the caller does
            # with it — a stalled SSE consumer must not block the server
            if lock is not None:
                with lock:
                    ev = next(it, None)
            else:
                ev = next(it, None)
            if ev is None:
                return
            yield ev


class _Handler(BaseHTTPRequestHandler):
    """HTTP/1.1 with keep-alive: JSON responses carry ``Content-Length`` so
    one connection serves many sequential requests (``RemoteBackend`` holds
    a persistent connection per backend — the req/s lever
    ``benchmarks/run.py http`` measures).  SSE responses are the exception:
    they are close-delimited (no chunked encoding on the stdlib server), so
    ``/v1/stream`` sends ``Connection: close`` and drops the connection."""
    server_version = SERVER_NAME
    protocol_version = "HTTP/1.1"
    srv: InferenceServer            # bound by InferenceServer.__init__

    # -- plumbing ------------------------------------------------------------
    def log_message(self, fmt, *args):
        if not self.srv.quiet:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _send_json(self, obj: dict, status: int = 200) -> None:
        self._drain_body()
        body = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_api_error(self, err: ApiError) -> None:
        self._send_json(err.to_json(), err.http_status)

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        self._body_read = True
        try:
            return json.loads(raw.decode("utf-8") or "null")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise InvalidRequestError(f"request body is not valid JSON: {e}")

    def _drain_body(self) -> None:
        """Consume an unread request body before writing a response: with
        keep-alive, leftover body bytes would be parsed as the NEXT request
        line, desyncing the connection for the following (valid) call."""
        if getattr(self, "_body_read", False):
            return
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            self.rfile.read(n)
        self._body_read = True

    def _sse(self, event: str, obj: dict) -> None:
        self.wfile.write(f"event: {event}\n".encode("utf-8"))
        self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode("utf-8"))
        self.wfile.flush()

    # -- routes --------------------------------------------------------------
    def do_GET(self):          # noqa: N802 (stdlib handler naming)
        self._body_read = False        # handler instance spans keep-alive
        path = urlsplit(self.path).path
        try:
            if path == "/v1/healthz":
                self._send_json(self.srv.healthz())
            elif path == "/v1/manifest":
                self._send_json(self.srv.manifest())
            else:
                raise UnknownEndpointError(f"no such endpoint: GET {path}")
        except ApiError as e:
            self._send_api_error(e)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:                      # noqa: BLE001
            self._send_api_error(InternalServerError(
                f"{type(e).__name__}: {e}"))

    def do_POST(self):         # noqa: N802
        self._body_read = False        # handler instance spans keep-alive
        path = urlsplit(self.path).path
        try:
            if path == "/v1/generate":
                req = GenerateRequest.from_json(self._read_json())
                self._send_json(self.srv.generate(req).to_json())
            elif path == "/v1/generate_batch":
                body = self._read_json()
                if not isinstance(body, dict) or "requests" not in body:
                    raise InvalidRequestError(
                        "generate_batch body must be "
                        "{\"requests\": [GenerateRequest, ...]}")
                check_protocol(body)
                reqs = [GenerateRequest.from_json(r)
                        for r in body["requests"]]
                results = self.srv.generate_batch(reqs)
                self._send_json({
                    "protocol_version": WIRE_PROTOCOL_VERSION,
                    "results": [r.to_json() for r in results]})
            elif path == "/v1/risk":
                body = self._read_json()
                if not isinstance(body, dict):
                    raise InvalidRequestError(
                        "risk body must be a JSON object")
                self._send_json(self.srv.risk(body).to_json())
            elif path == "/v1/futures":
                req = FuturesRequest.from_json(self._read_json())
                self._send_json(self.srv.sample_futures(req).to_json())
            elif path == "/v1/cancel":
                body = self._read_json()
                if not isinstance(body, dict):
                    raise InvalidRequestError(
                        "cancel body must be {\"request_id\": ...}")
                self._send_json(self.srv.cancel(body))
            elif path == "/v1/stream":
                self._do_stream()
            else:
                raise UnknownEndpointError(f"no such endpoint: POST {path}")
        except ApiError as e:
            self._send_api_error(e)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:                      # noqa: BLE001
            self._send_api_error(InternalServerError(
                f"{type(e).__name__}: {e}"))

    def _do_stream(self) -> None:
        req = GenerateRequest.from_json(self._read_json())
        it = self.srv.stream(req)
        # pull the first event BEFORE committing to SSE, so validation
        # failures still map to proper HTTP statuses + JSON bodies
        first: Tuple[TrajectoryEvent, ...] = ()
        try:
            ev = next(it)
            first = (ev,)
        except StopIteration:
            pass
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True        # SSE is close-delimited
        events: List[TrajectoryEvent] = []
        try:
            # chain lazily: a starred tuple here would drain the WHOLE
            # generator before the first frame is written, turning SSE into
            # a buffered-at-completion response (and making mid-stream
            # cancellation unobservable)
            for ev in itertools.chain(first, it):
                events.append(ev)
                self._sse("event", ev.to_json())
            result = self.srv.backend._result(req, events)
            self._sse("done", result.to_json())
        except (BrokenPipeError, ConnectionResetError):
            pass                                    # client went away
        except RequestCancelledError as e:          # /v1/cancel mid-stream:
            self._sse("cancelled", e.to_json())     # terminal frame
        except ApiError as e:                       # mid-stream: headers are
            self._sse("error", e.to_json())         # out — error as a frame
        except Exception as e:                      # noqa: BLE001
            self._sse("error", InternalServerError(
                f"{type(e).__name__}: {e}").to_json())


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.serve.server
# ---------------------------------------------------------------------------
PROG = "repro-torch-serve"


def _build_backend(args):
    """The backend the CLI namespace describes: fresh parameters from
    ``init_params(cfg, seed)`` or a JAX ``params.npz`` (``--ckpt``) on
    ``--device``, with activations in fp32."""
    if args.artifact:
        raise SystemExit(
            f"{PROG}: --artifact is not ported yet: serving an exported "
            f"artifact needs the port of the SDK runtime (ROADMAP queue A, "
            f"item 8); serve --config NAME instead")
    if not args.config:
        raise SystemExit(f"{PROG}: pass --config NAME")
    from repro_torch import resolve_device
    from repro_torch.api.client import EngineBackend, LocalBackend
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, load_checkpoint
    device = resolve_device(args.device)
    cfg = get_config(args.config, reduced=args.reduced).replace(
        dtype="float32")
    if args.ckpt:
        params = load_checkpoint(args.ckpt, cfg, device)
    else:
        params = init_params(cfg, args.seed, device)
    if args.backend == "local":
        return LocalBackend(params, cfg, device=device)
    # the prefix cache rides the paged pool: on by default there, refused
    # on a ring engine (no shareable blocks to index)
    prefix_cache = (args.cache == "paged" if args.prefix_cache is None
                    else args.prefix_cache)
    if prefix_cache and args.cache != "paged":
        raise SystemExit(f"{PROG}: --prefix-cache requires --cache paged "
                         f"(the ring layout has no shareable blocks)")
    if args.prefill_chunk_tokens is not None and args.cache != "paged":
        raise SystemExit(f"{PROG}: --prefill-chunk-tokens requires --cache "
                         f"paged (chunked prefill writes through the block "
                         f"table)")
    backend = EngineBackend.create(
        params, cfg, slots=args.slots, max_context=args.max_context,
        cache=args.cache, blocks=args.blocks, block_size=args.block_size,
        request_timeout=args.request_timeout, prefix_cache=prefix_cache,
        prefill_chunk_tokens=args.prefill_chunk_tokens, seed=args.seed,
        device=device)
    eng = backend.engine
    mem = eng.pool_stats()
    budget = (f"{mem['blocks']} x {args.block_size}-token blocks "
              f"(pool, {eng.slots} slots admitted by free-block budget)"
              if eng.paged else
              f"{eng.slots} slots x {eng.max_context} dense ring")
    chunk = (f"chunked prefill {args.prefill_chunk_tokens} tok/tick"
             if args.prefill_chunk_tokens else "monolithic prefill")
    print(f"{PROG}: engine KV cache [{args.cache}] on {eng.device} = "
          f"{mem['cache_bytes'] / 1e6:.1f} MB — {budget}; "
          f"prefix cache {'on' if prefix_cache else 'off'}; {chunk}; "
          f"request timeout {args.request_timeout:.0f}s", flush=True)
    return backend


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="Serve a repro_torch.api backend over the v%s JSON/SSE "
                    "wire protocol" % WIRE_PROTOCOL_VERSION)
    src = ap.add_argument_group("model source (one required)")
    src.add_argument("--artifact", metavar="DIR",
                     help="exported SDK artifact (not ported yet: refused)")
    src.add_argument("--config", metavar="NAME",
                     help="config name, e.g. delphi-2m: parameters from "
                          "--ckpt or fresh from --seed, served via --backend")
    ap.add_argument("--ckpt", metavar="DIR", default=None,
                    help="--config: a checkpoint directory holding the JAX "
                         "package's params.npz")
    ap.add_argument("--device", default="cuda",
                    help="device of the model (cpu runs the plain PyTorch "
                         "path)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced layer/width preset for --config")
    ap.add_argument("--backend", choices=("engine", "local"),
                    default="engine",
                    help="--config mode: continuous-batching engine "
                         "(default) or in-process local backend")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8478,
                    help="0 picks an ephemeral port")
    ap.add_argument("--slots", type=int, default=8,
                    help="decode batch width (max concurrent requests)")
    ap.add_argument("--max-context", type=int, default=512,
                    help="per-request KV context (ring width / table span)")
    ap.add_argument("--cache", choices=("ring", "paged"), default="ring",
                    help="KV layout: dense per-slot ring, or a shared "
                         "block pool with free-block admission + preemption")
    ap.add_argument("--blocks", type=int, default=None,
                    help="--cache paged: pool size in blocks "
                         "(default: dense-equivalent slots*context/size + 1)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="--cache paged: tokens per block")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=None,
                    help="index admitted prompts' KV blocks so identical "
                         "history prefixes admit by reference (default on "
                         "with --cache paged)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable the prefix index")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    metavar="N",
                    help="--cache paged: prefill prompts in N-token chunks "
                         "interleaved with decode ticks instead of one "
                         "monolithic pass (N must be a multiple of "
                         "--block-size; bit-identical outputs either way)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--request-timeout", type=float, default=300.0,
                    help="seconds before an in-flight request is expired "
                         "and its slot/blocks reclaimed")
    scale = ap.add_argument_group("scaling out (repro_torch.serve.router)")
    scale.add_argument("--replicas", type=int, default=1,
                       help="N > 1 fronts N engine replicas with the "
                            "prefix-affinity router instead of serving one "
                            "backend directly")
    scale.add_argument("--replica-mode", choices=("inprocess", "subprocess"),
                       default="inprocess",
                       help="--replicas placement: engines in this process "
                            "(shared parameters) or one server subprocess "
                            "per replica")
    scale.add_argument("--replica-urls", metavar="URL[,URL...]", default=None,
                       help="route over already-running servers instead of "
                            "starting any")
    ap.add_argument("--verbose", action="store_true",
                    help="log one line per HTTP request")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.replicas > 1 or args.replica_urls:
        from repro_torch.serve.router import ROUTER_NAME, build_router
        router = build_router(args)
        n = len(router.supervisor.replicas)
        print(f"{PROG}: {ROUTER_NAME} over {n} replicas on "
              f"{router.address} (wire protocol v{WIRE_PROTOCOL_VERSION})")
        for r in router.supervisor.replicas:
            print(f"  replica {r.name}: {r.url}")
        for name, ep in _ENDPOINTS.items():
            print(f"  {ep['method']:4s} {ep['path']}", flush=True)
        try:
            router.serve_forever()
        except KeyboardInterrupt:
            print(f"{PROG}: shutting down", flush=True)
        return 0

    backend = _build_backend(args)
    server = InferenceServer(backend, args.host, args.port,
                             request_timeout=args.request_timeout,
                             quiet=not args.verbose)
    print(f"{PROG}: {backend.name} backend on {server.address} "
          f"(wire protocol v{WIRE_PROTOCOL_VERSION})")
    for name, ep in _ENDPOINTS.items():
        print(f"  {ep['method']:4s} {ep['path']}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print(f"{PROG}: shutting down", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
