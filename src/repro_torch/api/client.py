"""Unified inference client of the port: one facade over pluggable backends.

``Client`` is the single public entry point over the port's inference
surfaces, with one request/result vocabulary (``repro_torch.api.schemas``)
and one host-side eq.-1 sampler
(``repro_torch.core.sampler.sample_next_event_np``), so trajectories are
bit-comparable across backends under injected uniforms:

* :class:`ArtifactBackend` wraps ``sdk.runtime.Runtime``.  Spec-v2
  artifacts generate by prefill-then-decode (the KV cache threaded through
  the exported decode graph, O(1) model work a token); v1 artifacts fall
  back to the paper's full-graph-per-token loop.
* :class:`EngineBackend` wraps ``serve.BatchedEngine`` for batched and
  streaming server-side use (eq.-1 sampling on the device, one host sync a
  tick), in the foreground or on the engine's background loop.
* :class:`LocalBackend`: in-process parameters and ``core.sampler``
  (``generate_trajectories`` for batched generation; streaming through the
  prefill and decode functions that the exporter serializes).
* :class:`repro_torch.api.remote.RemoteBackend`: the same surface over the
  versioned JSON/SSE wire protocol against ``repro_torch.serve.server``
  (``Client.connect(url)``).

``sdk.InferenceSession`` is a thin compatibility shim over ``Client``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card the default raises.
"""
from __future__ import annotations

import queue
import threading
from typing import (TYPE_CHECKING, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.errors import (AgesLengthMismatchError, AgesRequiredError,
                                    EmptyTrajectoryError, InvalidRequestError,
                                    RequestTimeoutError, TooLongError,
                                    UnsupportedOverrideError)
from repro_torch.api.schemas import (FuturesRequest, FuturesResult,
                                     GenerateRequest, RiskItem, RiskReport,
                                     TrajectoryEvent, TrajectoryResult)
from repro_torch.configs import base as cb
from repro_torch.configs.base import ModelConfig
from repro_torch.core.risk import (analytic_next_event_risk_np,
                                   futures_risk_items)
from repro_torch.core.sampler import (generate_trajectories,
                                      sample_next_event_np)
from repro_torch.models import forward
from repro_torch.sdk.export import build_inference_fns
from repro_torch.sdk.runtime import Runtime

if TYPE_CHECKING:                       # the engine imports this package
    from repro_torch.serve.engine import BatchedEngine
    from repro_torch.serve.engine import Request as EngineRequest


# ---------------------------------------------------------------------------
# Backend base: shared validation, host generation loop, result assembly
# ---------------------------------------------------------------------------
class InferenceBackend:
    """Common surface all backends implement.

    Subclasses set ``name``, ``seq_len``, ``vocab_size``, ``has_ages``,
    ``max_age``, ``death_token`` and implement ``logits`` plus either
    ``_event_stream`` (host-loop backends) or override ``generate`` /
    ``stream`` directly.  Concrete subclasses register by ``name``
    (``InferenceBackend.registry``).
    """
    name = "abstract"
    seq_len: int
    vocab_size: int
    has_ages: bool
    max_age: float
    death_token: int

    registry: dict = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        name = cls.__dict__.get("name")
        if name and name != "abstract":
            InferenceBackend.registry[name] = cls

    # -- validation (every error is a ValueError subclass) -------------------
    def _validate(self, tokens: Sequence[int],
                  ages: Optional[Sequence[float]]) -> None:
        if len(tokens) == 0:
            raise EmptyTrajectoryError(
                "empty trajectory: pass at least one event token")
        if len(tokens) > self.seq_len:
            raise TooLongError(f"trajectory longer than graph axis "
                               f"({self.seq_len})")
        if self.has_ages:
            if ages is None:
                raise AgesRequiredError(
                    "this model's signature declares an 'ages' input: pass "
                    "ages alongside tokens")
            if len(ages) != len(tokens):
                raise AgesLengthMismatchError(
                    f"ages/tokens length mismatch: "
                    f"{len(ages)} vs {len(tokens)}")

    def _validate_request(self, req: GenerateRequest) -> None:
        """Trajectory inputs plus the uniforms contract (row i feeds sampled
        event i, so the array covers max_new rows at the vocabulary's
        width).  A bad shape stays a structured 400 here instead of an
        IndexError in the engine loop, which would fail every request in
        flight."""
        self._validate(req.tokens, req.ages)
        if req.uniforms is not None:
            u = np.asarray(req.uniforms)
            if u.ndim != 2 or u.shape[0] < req.max_new \
                    or u.shape[1] != self.vocab_size:
                raise InvalidRequestError(
                    f"uniforms must have shape (>= max_new, vocab_size) = "
                    f"(>= {req.max_new}, {self.vocab_size}); got "
                    f"{tuple(u.shape)}")

    def _pad_inputs(self, tokens: Sequence[int],
                    ages: Optional[Sequence[float]]) -> Tuple[np.ndarray, ...]:
        """Right-pad to the fixed graph axis (ages repeat the last value)."""
        self._validate(tokens, ages)
        S = self.seq_len
        t = np.zeros((1, S), np.int32)
        t[0, :len(tokens)] = tokens
        if not self.has_ages:
            return (t,)
        a = np.zeros((1, S), np.float32)
        a[0, :len(ages)] = ages
        a[0, len(ages):] = ages[-1]
        return t, a

    def _term(self, req: GenerateRequest) -> Tuple[float, int]:
        max_age = self.max_age if req.max_age is None else req.max_age
        death = self.death_token if req.death_token is None else req.death_token
        return max_age, death

    # -- the one host-side generation loop -----------------------------------
    def _host_events(self, req: GenerateRequest, next_logits
                     ) -> Iterator[TrajectoryEvent]:
        """Iterative client-side generation.  ``next_logits(toks, ags,
        state) -> (logits (V,), state)`` hides how the logits are made (the
        state carries the KV cache); the sampling and termination here are
        the one host-side definition, shared by every host-loop backend."""
        max_age, death = self._term(req)
        toks = [int(t) for t in req.tokens]
        ags = ([float(a) for a in req.ages] if req.ages is not None else [])
        rng = req.rng if req.rng is not None else np.random.default_rng(req.seed)
        state = None
        n = 0
        for i in range(req.max_new):
            if len(toks) >= self.seq_len:
                break
            logits, state = next_logits(toks, ags, state)
            lg = np.asarray(logits).reshape(-1).astype(np.float64)
            u = (req.uniforms[i] if req.uniforms is not None
                 else rng.uniform(size=self.vocab_size))
            if self.has_ages:
                evt, tmin = sample_next_event_np(lg, u)      # paper eq. 1
                age = ags[-1] + tmin
                if age > max_age:       # censored BEFORE emitting
                    break
                toks.append(evt)
                ags.append(age)
                yield TrajectoryEvent(index=n, token=evt, age=age)
                n += 1
                if evt == death:
                    break
            else:                       # generic LM: Gumbel-max categorical
                g = -np.log(-np.log(np.clip(u, 1e-12, 1 - 1e-12)))
                evt = int(np.argmax(lg + g))
                toks.append(evt)
                yield TrajectoryEvent(index=n, token=evt)
                n += 1

    def _prefill_decode_stepper(self, prefill, decode):
        """One prefill-then-decode state machine over a (prefill, decode)
        pair: ``prefill(padded_inputs, last_index) -> (logits (1, V),
        cache)``; ``decode(cache, token, age_or_None, step) -> (logits
        (1, V), cache)``."""
        def next_fn(toks, ags, state):
            if state is None:
                inputs = self._pad_inputs(toks,
                                          ags if self.has_ages else None)
                lg, cache = prefill(inputs, len(toks) - 1)
                return np.asarray(lg)[0], (cache, len(toks))
            cache, step = state
            lg, cache = decode(cache, toks[-1],
                               ags[-1] if self.has_ages else None, step)
            return np.asarray(lg)[0], (cache, step + 1)
        return next_fn

    def _result(self, req: GenerateRequest,
                events: List[TrajectoryEvent]) -> TrajectoryResult:
        return TrajectoryResult(
            tokens=[e.token for e in events],
            ages=[e.age for e in events if e.age is not None],
            prompt_tokens=[int(t) for t in req.tokens],
            prompt_ages=([float(a) for a in req.ages]
                         if req.ages is not None else []),
            backend=self.name)

    # -- public backend surface ---------------------------------------------
    def logits(self, tokens: Sequence[int],
               ages: Optional[Sequence[float]] = None) -> np.ndarray:
        """Next-event logits for the trajectory so far: (V,) fp32."""
        raise NotImplementedError

    def _event_stream(self, req: GenerateRequest) -> Iterator[TrajectoryEvent]:
        raise NotImplementedError

    def stream(self, req: GenerateRequest) -> Iterator[TrajectoryEvent]:
        self._validate_request(req)
        return self._event_stream(req)

    def generate(self, req: GenerateRequest) -> TrajectoryResult:
        return self._result(req, list(self.stream(req)))

    def generate_batch(self, reqs: Sequence[GenerateRequest]
                       ) -> List[TrajectoryResult]:
        return [self.generate(r) for r in reqs]

    def cancel(self, request_id: str) -> bool:
        """Cancel an in-flight ``generate``/``stream`` by its
        ``GenerateRequest.request_id``.  Host-loop backends run the model on
        the caller's thread and have nothing concurrent to cancel; the
        engine and remote backends override this.  Returns False when
        nothing was cancelled."""
        return False

    def risk(self, tokens: Sequence[int],
             ages: Optional[Sequence[float]] = None, *,
             horizon: float = 5.0, top: int = 10) -> RiskReport:
        """Closed-form within-horizon next-event risks, highest first:
        P(next = i, t <= h) = softmax(logits)_i * (1 - e^{-Lambda h})."""
        lg = self.logits(tokens, ages)
        risk = analytic_next_event_risk_np(lg, horizon)
        order = np.argsort(-risk)[:top]
        return RiskReport(
            horizon=horizon,
            items=[RiskItem(token=int(i), risk=float(risk[i]))
                   for i in order],
            backend=self.name)

    # -- Monte-Carlo futures --------------------------------------------------
    def _validate_futures(self, req: FuturesRequest) -> None:
        self._validate(req.tokens, req.ages)
        if req.n_futures < 1:
            raise InvalidRequestError(
                f"n_futures must be >= 1; got {req.n_futures}")
        if req.uniforms is not None:
            u = np.asarray(req.uniforms)
            if u.ndim != 3 or u.shape[0] < req.n_futures \
                    or u.shape[1] < req.max_new \
                    or u.shape[2] != self.vocab_size:
                raise InvalidRequestError(
                    f"futures uniforms must have shape (>= n_futures, "
                    f">= max_new, vocab_size) = (>= {req.n_futures}, "
                    f">= {req.max_new}, {self.vocab_size}); got "
                    f"{tuple(u.shape)}")

    def _futures_result(self, req: FuturesRequest,
                        results: List[TrajectoryResult]) -> FuturesResult:
        """Aggregate N futures into the within-horizon ``RiskReport``: one
        host-side aggregation (``core.risk.futures_risk_items``) for every
        backend, so identical trajectories give identical reports."""
        age0 = (float(req.ages[-1])
                if req.ages is not None and len(req.ages) else 0.0)
        items = futures_risk_items(
            [(r.tokens, r.ages) for r in results], age0, req.horizon,
            self.vocab_size, top=req.top)
        report = RiskReport(
            horizon=req.horizon,
            items=[RiskItem(token=t, risk=p) for t, p in items],
            backend=self.name)
        return FuturesResult(risk=report, trajectories=results,
                             n_futures=req.n_futures, backend=self.name)

    def sample_futures(self, req: FuturesRequest) -> FuturesResult:
        """N stochastic continuations of one history, aggregated into a
        within-horizon ``RiskReport``.  Host-loop backends generate them one
        after another; the engine forks them from one prefilled parent and
        the local backend batches them in one call."""
        self._validate_futures(req)
        rng = np.random.default_rng(req.seed)
        results = []
        for i in range(req.n_futures):
            u = (np.asarray(req.uniforms[i]) if req.uniforms is not None
                 else rng.uniform(
                     size=(req.max_new, self.vocab_size)).astype(np.float32))
            results.append(self.generate(GenerateRequest(
                tokens=req.tokens, ages=req.ages, max_new=req.max_new,
                uniforms=u)))
        return self._futures_result(req, results)


def _torch(x, device) -> torch.Tensor:
    """A host array (copied: it may be a read-only view) on ``device``."""
    return torch.from_numpy(np.array(x)).to(device)


def _decode_inputs(token: int, age: Optional[float],
                   step: int) -> List[np.ndarray]:
    """A decode step's inputs in the graphs' order: token (1, 1)[, age
    (1, 1)], step (1,)."""
    args = [np.asarray([[token]], np.int32)]
    if age is not None:
        args.append(np.asarray([[age]], np.float32))
    args.append(np.asarray([step], np.int32))
    return args


# ---------------------------------------------------------------------------
# Artifact backend (the FAIR client path)
# ---------------------------------------------------------------------------
class ArtifactBackend(InferenceBackend):
    """Client over an exported artifact directory (``sdk.runtime.Runtime``
    on ``device``).

    Spec-v2 artifacts default to prefill-then-decode generation: one prefill
    over the prompt, then one KV-cached decode_step per generated token,
    instead of re-running the O(S·V) full graph per token (the v1 path, kept
    as ``use_decode_graph=False`` and as the automatic v1 fallback).
    """
    name = "artifact"

    def __init__(self, artifact_dir: str, *,
                 use_decode_graph: Optional[bool] = None, device="cuda"):
        self.runtime = Runtime(artifact_dir, device=device)
        m = self.runtime.manifest
        sig = m["signature"]
        self.seq_len = int(sig["inputs"][0]["shape"][1])
        self.vocab_size = int(sig["outputs"][0]["shape"][2])
        self.has_ages = any(i["name"] == "ages" for i in sig["inputs"])
        term = m.get("sampling", {}).get("termination", {})
        self.death_token = int(term.get("death_token", 1))
        self.max_age = float(term.get("max_age_years", 85.0))
        if use_decode_graph is None:
            use_decode_graph = self.runtime.has_decode_graph
        elif use_decode_graph and not self.runtime.has_decode_graph:
            raise ValueError(
                f"artifact {artifact_dir!r} is spec "
                f"{self.runtime.spec_version} and ships no decode graph; "
                f"re-export with spec v2 or pass use_decode_graph=False")
        self.use_decode_graph = bool(use_decode_graph)

    def logits(self, tokens, ages=None):
        inputs = self._pad_inputs(tokens, ages)
        out = self.runtime.run(*inputs)                  # (1, S, V)
        return out[0, len(tokens) - 1]

    def _next_full(self, toks, ags, state):
        return self.logits(toks, ags if self.has_ages else None), None

    def _next_decode_fn(self):
        def prefill(inputs, last):
            return self.runtime.prefill(*inputs,
                                        np.asarray([last], np.int32))

        def decode(cache, token, age, step):
            return self.runtime.decode_step(
                cache, *_decode_inputs(token, age, step))

        return self._prefill_decode_stepper(prefill, decode)

    def _event_stream(self, req):
        step_fn = (self._next_decode_fn() if self.use_decode_graph
                   else self._next_full)
        return self._host_events(req, step_fn)


# ---------------------------------------------------------------------------
# Local backend (in-process parameters + core.sampler)
# ---------------------------------------------------------------------------
class LocalBackend(InferenceBackend):
    """In-process inference: parameters and the port's sampler.

    ``generate`` runs the straight-line batched generator
    (``core.sampler.generate_trajectories``; without injected uniforms it
    draws from a ``torch.Generator`` seeded with the request's ``seed``);
    ``stream`` calls the prefill and decode functions that the exporter
    serializes (``sdk.export.build_inference_fns``: a batch-1 prefill into a
    ring of ``seq_len``, then one decode step a token), with the host-side
    sampler, so the local decode path and an artifact's are one function.
    Every prompt is right-padded to ``seq_len`` (default ``max_seq_len``;
    a recurrent config's bounds nothing, so there it must be given).
    """
    name = "local"

    def __init__(self, params, cfg: ModelConfig, *,
                 seq_len: Optional[int] = None, device="cuda"):
        if cfg.frontend is not None or cfg.arch_type in (cb.AUDIO,
                                                          cb.ENC_DEC):
            # the prefill and decode functions take tokens (and ages) only
            raise ValueError("engine serves token-only architectures")
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.cfg = cfg
        if seq_len is None and cfg.max_seq_len >= cb.UNBOUNDED_CONTEXT:
            # every prompt is right-padded to seq_len: a recurrent config's
            # max_seq_len is no width to prefill
            raise ValueError(f"{cfg.name} bounds no context (max_seq_len="
                             f"{cfg.max_seq_len}): pass seq_len")
        self.seq_len = int(seq_len or cfg.max_seq_len)
        if self.seq_len > cfg.max_seq_len:
            raise ValueError(f"seq_len={self.seq_len} exceeds "
                             f"cfg.max_seq_len={cfg.max_seq_len}")
        self.vocab_size = cfg.vocab_size
        self.has_ages = cfg.age_encoding
        self.max_age = cfg.max_age
        self.death_token = cfg.death_token
        self._fns = build_inference_fns(cfg, self.seq_len)

    def _tensors(self, *arrays) -> List[torch.Tensor]:
        return [_torch(a, self.device) for a in arrays]

    @torch.no_grad()
    def logits(self, tokens, ages=None):
        inputs = self._pad_inputs(tokens, ages)
        out = self._fns["full"](self.params, *self._tensors(*inputs))
        return out[0, len(tokens) - 1].float().cpu().numpy()

    def _next_decode_fn(self):
        @torch.no_grad()
        def prefill(inputs, last):
            lg, cache = self._fns["prefill"](
                self.params, *self._tensors(*inputs,
                                            np.asarray([last], np.int32)))
            return lg.float().cpu().numpy(), cache

        @torch.no_grad()
        def decode(cache, token, age, step):
            lg, cache = self._fns["decode"](
                self.params, cache,
                *self._tensors(*_decode_inputs(token, age, step)))
            return lg.float().cpu().numpy(), cache

        return self._prefill_decode_stepper(prefill, decode)

    def _event_stream(self, req):
        return self._host_events(req, self._next_decode_fn())

    @torch.no_grad()
    def _generate_rows(self, tokens, ages, n: int, max_new: int,
                       max_age: float, death: int, uniforms, seed: int):
        """``generate_trajectories`` over ``n`` copies of one history:
        (new tokens, new ages) of each row."""
        S0 = len(tokens)
        t = _torch(np.broadcast_to(np.asarray(tokens, np.int32), (n, S0)),
                   self.device)
        a = _torch(np.broadcast_to(np.asarray(ages, np.float32), (n, S0)),
                   self.device)
        gen = None
        if uniforms is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        u = (None if uniforms is None else
             _torch(np.asarray(uniforms, np.float32), self.device))
        out = generate_trajectories(
            self.params, self.cfg, t, a, max_new=max_new, max_age=max_age,
            death_token=death, uniforms=u, generator=gen)
        n_gen = out["n_generated"].cpu().numpy()
        toks = out["tokens"].cpu().numpy()
        ags = out["ages"].cpu().numpy()
        return [(toks[j, S0:S0 + n_gen[j]].tolist(),
                 [float(x) for x in ags[j, S0:S0 + n_gen[j]]])
                for j in range(n)]

    def generate(self, req: GenerateRequest) -> TrajectoryResult:
        # the host loop for generic LMs (no eq.-1 batched generator) and for
        # host-rng requests (the batched path would ignore req.rng)
        if not self.has_ages or req.rng is not None:
            return super().generate(req)
        self._validate_request(req)
        max_age, death = self._term(req)
        u = (None if req.uniforms is None
             else np.asarray(req.uniforms)[None, :req.max_new])
        [(toks, ags)] = self._generate_rows(
            req.tokens, req.ages, 1, req.max_new, max_age, death, u,
            req.seed)
        return TrajectoryResult(
            tokens=toks, ages=ags,
            prompt_tokens=[int(x) for x in req.tokens],
            prompt_ages=[float(x) for x in req.ages],
            backend=self.name)

    def sample_futures(self, req: FuturesRequest) -> FuturesResult:
        """All N futures in one batched ``generate_trajectories`` call.
        Generic-LM configs take the host loop."""
        if not self.has_ages:
            return super().sample_futures(req)
        self._validate_futures(req)
        N = req.n_futures
        u = (None if req.uniforms is None else
             np.asarray(req.uniforms, np.float32)[:N, :req.max_new])
        rows = self._generate_rows(req.tokens, req.ages, N, req.max_new,
                                   self.max_age, self.death_token, u,
                                   req.seed)
        results = [TrajectoryResult(
            tokens=toks, ages=ags,
            prompt_tokens=[int(x) for x in req.tokens],
            prompt_ages=[float(x) for x in req.ages],
            backend=self.name) for toks, ags in rows]
        return self._futures_result(req, results)


# ---------------------------------------------------------------------------
# Engine backend (batched / streaming serving)
# ---------------------------------------------------------------------------
class EngineBackend(InferenceBackend):
    """Client over the port's continuous-batching engine.

    Termination knobs (max_age / death_token / temperature / seed) are fixed
    when the engine is built, so per-request overrides raise instead of
    being ignored: build the engine from a ``cfg.replace(...)`` to change
    them.

    Two modes: foreground (this thread drives ``engine.run()`` /
    ``engine.step()``) and background (the engine ticks on its own thread
    after ``engine.start()``, as under the HTTP server: requests are
    enqueued and this thread waits on their completion hooks, so many
    handler threads share one engine).
    """
    name = "engine"

    #: background mode: seconds to wait for the loop to finish a submitted
    #: request before failing it with a structured timeout
    request_timeout: float = 300.0

    def __init__(self, engine: "BatchedEngine"):
        self.engine = engine
        cfg = engine.cfg
        self.cfg = cfg
        self.params = engine.params
        self.seq_len = engine.max_context
        self.vocab_size = cfg.vocab_size
        self.has_ages = cfg.age_encoding
        self.max_age = cfg.max_age
        self.death_token = cfg.death_token

    @classmethod
    def create(cls, params, cfg: ModelConfig, **engine_kwargs
               ) -> "EngineBackend":
        """An engine built from ``engine_kwargs`` (on ``cuda`` unless they
        pass ``device``)."""
        from repro_torch.serve.engine import BatchedEngine
        return cls(BatchedEngine(params, cfg, **engine_kwargs))

    def _check_overrides(self, req: GenerateRequest) -> None:
        if req.max_age is not None and req.max_age != self.max_age:
            raise UnsupportedOverrideError(
                f"EngineBackend termination is fixed in the engine: "
                f"requested max_age={req.max_age} but the engine was built "
                f"with {self.max_age} — construct the engine from "
                f"cfg.replace(max_age=...)")
        if req.death_token is not None and req.death_token != self.death_token:
            raise UnsupportedOverrideError(
                f"EngineBackend death_token is fixed at construction "
                f"({self.death_token}); got {req.death_token}")
        if req.rng is not None:
            raise UnsupportedOverrideError(
                "EngineBackend samples on the device: pass `uniforms` for "
                "determinism, or seed the engine")
        if req.uniforms is None and req.seed != 0:
            raise UnsupportedOverrideError(
                f"EngineBackend draws from the engine's construction-time "
                f"generator; per-request seed={req.seed} would be "
                f"silently ignored — inject `uniforms`, or build the "
                f"engine with seed=...")

    def _engine_request(self, req: GenerateRequest, **kw) -> "EngineRequest":
        self._validate_request(req)
        self._check_overrides(req)
        return self._build_engine_request(req, **kw)

    def _build_engine_request(self, req: GenerateRequest, **kw
                              ) -> "EngineRequest":
        """Construction only: callers that validated already (``stream``)
        skip the second pass."""
        from repro_torch.serve.engine import Request as EngineRequest
        return EngineRequest(
            tokens=np.asarray(req.tokens, np.int32),
            ages=(np.asarray(req.ages, np.float32)
                  if req.ages is not None else None),
            max_new=req.max_new, uniforms=req.uniforms,
            request_id=req.request_id, **kw)

    def cancel(self, request_id: str) -> bool:
        """Cancellation into the engine: the request leaves its slot (paged
        blocks freed) and its waiters unblock with ``request_cancelled``."""
        return self.engine.cancel(request_id)

    @torch.no_grad()
    def logits(self, tokens, ages=None):
        """A ``forward(mode="train")`` of the engine's own parameters on
        the engine's device, on the calling thread (handler threads run it
        while the loop ticks; both launch on the default stream)."""
        self._validate(tokens, ages)
        # the engine's prompt axis (max_context) may exceed cfg.max_seq_len:
        # pad to whichever is larger
        S = max(self.cfg.max_seq_len, len(tokens))
        t = np.zeros((1, S), np.int32)
        t[0, :len(tokens)] = tokens
        batch = {"tokens": _torch(t, self.engine.device)}
        if self.has_ages:
            a = np.zeros((1, S), np.float32)
            a[0, :len(ages)] = ages
            a[0, len(ages):] = ages[-1]
            batch["ages"] = _torch(a, self.engine.device)
        out = forward(self.engine._wparams, self.cfg, batch, mode="train")
        return out["logits"][0, len(tokens) - 1].float().cpu().numpy()

    def _finish(self, req: GenerateRequest, er: "EngineRequest"
                ) -> TrajectoryResult:
        if er.error is not None:
            raise er.error
        if not er.done:
            raise RuntimeError("engine stopped before completing the "
                               "request (max_ticks exhausted?)")
        return TrajectoryResult(
            tokens=list(er.out_tokens),
            ages=[float(a) for a in er.out_ages],
            prompt_tokens=[int(t) for t in req.tokens],
            prompt_ages=([float(a) for a in req.ages]
                         if req.ages is not None else []),
            backend=self.name)

    def generate_batch(self, reqs: Sequence[GenerateRequest]
                       ) -> List[TrajectoryResult]:
        pairs = [(r, self._engine_request(r)) for r in reqs]
        if self.engine.running:
            # background mode: the loop ticks; wait on completion
            waits = []
            for _, er in pairs:
                evt = threading.Event()
                er.on_done = lambda _r, _evt=evt: _evt.set()
                waits.append(evt)
            for _, er in pairs:
                self.engine.submit(er)
            for evt in waits:
                if not evt.wait(self.request_timeout):
                    raise RequestTimeoutError(
                        f"engine did not complete the request within "
                        f"{self.request_timeout}s")
        else:
            for _, er in pairs:
                self.engine.submit(er)
            self.engine.run()
        return [self._finish(req, er) for req, er in pairs]

    def generate(self, req: GenerateRequest) -> TrajectoryResult:
        return self.generate_batch([req])[0]

    def sample_futures(self, req: FuturesRequest) -> FuturesResult:
        """Monte-Carlo futures through the engine's ``fork``: one prefill of
        the history (a held parent), then N decode slots that share its
        blocks by reference.  Equal to ``ring_reference_futures`` bit for
        bit under injected uniforms.  ``FuturesResult.sharing`` carries the
        pool's counters over the engine's life, snapshotted at
        completion."""
        self._validate_futures(req)
        if req.uniforms is None and req.seed != 0:
            # the engine's generator would ignore a per-request seed: draw
            # the uniforms on the host from it instead
            rng = np.random.default_rng(req.seed)
            uniforms = rng.uniform(
                size=(req.n_futures, req.max_new,
                      self.vocab_size)).astype(np.float32)
        else:
            uniforms = req.uniforms
        children = self.engine.sample_futures(
            np.asarray(req.tokens, np.int32),
            (np.asarray(req.ages, np.float32)
             if req.ages is not None else None),
            n=req.n_futures, max_new=req.max_new, uniforms=uniforms,
            request_id=req.request_id, wait_timeout=self.request_timeout)
        results = []
        for c in children:
            if c.error is not None:
                raise c.error
            if not c.done:
                raise RuntimeError("engine stopped before completing a "
                                   "forked future")
            results.append(TrajectoryResult(
                tokens=list(c.out_tokens),
                ages=[float(a) for a in c.out_ages],
                prompt_tokens=[int(t) for t in req.tokens],
                prompt_ages=([float(a) for a in req.ages]
                             if req.ages is not None else []),
                backend=self.name))
        out = self._futures_result(req, results)
        st = self.engine.pool_stats()
        out.sharing = {k: st[k] for k in
                       ("cache", "forks", "preemptions", "shared_blocks",
                        "shared_blocks_peak", "cow_copies", "prefix_cache")
                       if k in st}
        return out

    def stream(self, req: GenerateRequest) -> Iterator[TrajectoryEvent]:
        # not a generator itself, so that validation raises here
        self._validate_request(req)
        self._check_overrides(req)
        if self.engine.running:
            return self._stream_background(req)
        return self._stream_foreground(req)

    def _stream_foreground(self, req: GenerateRequest
                           ) -> Iterator[TrajectoryEvent]:
        events: List[TrajectoryEvent] = []

        def on_event(token: int, age: Optional[float]) -> None:
            events.append(TrajectoryEvent(index=len(events), token=token,
                                          age=age))

        er = self._build_engine_request(req, on_event=on_event)
        self.engine.submit(er)
        drained = 0
        while not er.done:
            progressed = self.engine.step()
            while drained < len(events):
                yield events[drained]
                drained += 1
            if not progressed and not er.done:
                raise RuntimeError("engine made no progress on an "
                                   "unfinished streaming request")
        while drained < len(events):
            yield events[drained]
            drained += 1
        if er.error is not None:
            raise er.error

    def _stream_background(self, req: GenerateRequest
                           ) -> Iterator[TrajectoryEvent]:
        """Per-event streaming off the background loop: the loop's thread
        pushes each event through a queue as its tick's sync lands."""
        q: "queue.Queue" = queue.Queue()
        n_seen = [0]

        def on_event(token: int, age: Optional[float]) -> None:
            q.put(("event", TrajectoryEvent(index=n_seen[0], token=token,
                                            age=age)))
            n_seen[0] += 1

        def on_done(er: "EngineRequest") -> None:
            q.put(("done", er))

        er = self._build_engine_request(req, on_event=on_event,
                                        on_done=on_done)
        self.engine.submit(er)
        while True:
            try:
                kind, payload = q.get(timeout=self.request_timeout)
            except queue.Empty:
                raise RequestTimeoutError(
                    f"engine produced no event within "
                    f"{self.request_timeout}s") from None
            if kind == "event":
                yield payload
            else:
                if payload.error is not None:
                    raise payload.error
                return


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------
class Client:
    """Unified inference client: ``generate`` / ``generate_batch`` /
    ``stream`` / ``risk`` / ``sample_futures`` over a pluggable backend.

    >>> client = Client.from_artifact("artifact_dir/")       # FAIR artifact
    >>> client = Client.from_params(params, cfg)             # in-process
    >>> client = Client.serving(params, cfg, slots=8)        # batched engine
    >>> client = Client.connect("http://host:8478")          # over the wire
    """

    def __init__(self, backend: InferenceBackend):
        self.backend = backend

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_artifact(cls, artifact_dir: str, **kw) -> "Client":
        """An exported artifact (``sdk.export_model``); ``kw`` are
        :class:`ArtifactBackend`'s (``use_decode_graph``, ``device``)."""
        return cls(ArtifactBackend(artifact_dir, **kw))

    @classmethod
    def from_params(cls, params, cfg: ModelConfig, **kw) -> "Client":
        return cls(LocalBackend(params, cfg, **kw))

    @classmethod
    def from_engine(cls, engine: "BatchedEngine") -> "Client":
        return cls(EngineBackend(engine))

    @classmethod
    def serving(cls, params, cfg: ModelConfig, **engine_kwargs) -> "Client":
        return cls(EngineBackend.create(params, cfg, **engine_kwargs))

    @classmethod
    def connect(cls, url: str, **kw) -> "Client":
        """A ``repro_torch.serve.server`` (or any server of the same wire
        protocol) across the network."""
        from repro_torch.api.remote import RemoteBackend
        return cls(RemoteBackend(url, **kw))

    @staticmethod
    def backends() -> dict:
        """Registered backend name -> class
        (artifact/engine/local/remote)."""
        return dict(InferenceBackend.registry)

    # -- request plumbing ----------------------------------------------------
    @staticmethod
    def _req(req: Optional[GenerateRequest], kw) -> GenerateRequest:
        if req is None:
            return GenerateRequest(**kw)
        if kw:
            raise TypeError("pass either a GenerateRequest or keyword "
                            "arguments, not both")
        return req

    # -- entry points --------------------------------------------------------
    def generate(self, req: Optional[GenerateRequest] = None,
                 **kw) -> TrajectoryResult:
        return self.backend.generate(self._req(req, kw))

    def generate_batch(self, reqs: Sequence[GenerateRequest]
                       ) -> List[TrajectoryResult]:
        return self.backend.generate_batch(list(reqs))

    def stream(self, req: Optional[GenerateRequest] = None,
               **kw) -> Iterator[TrajectoryEvent]:
        return self.backend.stream(self._req(req, kw))

    def risk(self, tokens: Sequence[int],
             ages: Optional[Sequence[float]] = None, *,
             horizon: float = 5.0, top: int = 10) -> RiskReport:
        """Closed-form within-horizon next-event risks, highest first."""
        return self.backend.risk(tokens, ages, horizon=horizon, top=top)

    def sample_futures(self, req: Optional[FuturesRequest] = None,
                       **kw) -> FuturesResult:
        """N Monte-Carlo continuations of one patient history, aggregated
        into a within-horizon ``RiskReport`` (with the trajectories behind
        it).  Engine-backed clients fork the futures from one prefilled
        parent.

        >>> client.sample_futures(tokens=[...], ages=[...], n_futures=32)
        """
        if req is None:
            req = FuturesRequest(**kw)
        elif kw:
            raise TypeError("pass either a FuturesRequest or keyword "
                            "arguments, not both")
        return self.backend.sample_futures(req)

    def cancel(self, request_id: str) -> bool:
        """Cancel an in-flight request by the ``request_id`` it was
        submitted with.  Engine-backed and remote clients evict its slot;
        returns False when nothing was cancelled."""
        return self.backend.cancel(request_id)
