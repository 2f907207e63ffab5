"""Shared request/result schemas for every inference surface.

One vocabulary of dataclasses used by all four ``repro_torch.api`` backends (and by
the ``InferenceSession`` compatibility shim), replacing the divergent
input/result conventions that grew around ``sdk.session``, ``serve.engine``
and ``core.sampler``.  Pure data — no JAX, no model imports — so schemas can
cross any process/serialization boundary the same way the artifact does.

Wire protocol (v1)
------------------
Every schema has a canonical JSON form (``to_json`` / ``from_json``) — the
contract ``repro_torch.serve.server`` and ``repro_torch.api.RemoteBackend`` speak, and
the shape a hand-written client (the paper's thin JS SDK) would produce:

* requests carry ``"protocol_version"`` (:data:`WIRE_PROTOCOL_VERSION`);
  ``from_json`` rejects a different major version with a structured
  ``protocol_version_mismatch`` error instead of mis-parsing;
* numpy arrays (``uniforms``) encode as
  ``{"shape": [...], "dtype": "float32", "b64": <base64 little-endian raw
  bytes>}`` — bit-exact across the wire; ``from_json`` also accepts plain
  nested lists for hand-written clients;
* ``rng`` is live host PRNG state and is *rejected* at serialization time
  (``rng_not_serializable``) — inject ``uniforms`` or pass ``seed`` for
  cross-process determinism.
"""
from __future__ import annotations

import base64
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.api.errors import (InvalidRequestError, ProtocolVersionError,
                              RngNotSerializableError)

#: Major version of the JSON wire contract.  Bump ONLY on breaking schema
#: changes; additive fields are minor and do not bump this.
WIRE_PROTOCOL_VERSION = "1"


def _encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":              # wire order is little-endian
        a = a.astype(a.dtype.newbyteorder("<"))
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def _decode_array(obj, field: str) -> np.ndarray:
    if isinstance(obj, list):                 # hand-written-client form
        return np.asarray(obj, np.float32)
    if not isinstance(obj, dict) or "b64" not in obj:
        raise InvalidRequestError(
            f"{field}: expected base64 array object or nested lists")
    try:
        raw = base64.b64decode(obj["b64"])
        a = np.frombuffer(raw, dtype=np.dtype(obj.get("dtype", "float32")))
        return a.reshape(obj["shape"]).copy()
    except (ValueError, TypeError, KeyError) as e:
        raise InvalidRequestError(f"{field}: undecodable array ({e})") from e


def check_protocol(d: dict) -> None:
    """Refuse a body from a different wire-protocol major version (absent
    version is tolerated for hand-written minimal clients)."""
    v = d.get("protocol_version") if isinstance(d, dict) else None
    if v is not None and str(v) != WIRE_PROTOCOL_VERSION:
        raise ProtocolVersionError(
            f"wire protocol {v!r} != supported {WIRE_PROTOCOL_VERSION!r}")


def _require(d: dict, field: str):
    if field not in d:
        raise InvalidRequestError(f"missing required field {field!r}")
    return d[field]


@dataclasses.dataclass
class GenerateRequest:
    """One trajectory-generation request, backend-agnostic.

    ``tokens``/``ages`` are the patient's known history (ages omitted for
    generic-LM configs).  ``max_age``/``death_token`` of ``None`` defer to the
    backend's defaults (the artifact manifest's sampling block, or the model
    config).  ``uniforms`` — optional pre-drawn (max_new, V) U(0,1), row i
    consumed by the i-th sampled event — makes generation deterministic and
    bit-comparable across backends (claims C2/C3); otherwise draws come from
    ``rng`` (host backends) or a PRNGKey derived from ``seed``.
    """
    tokens: Sequence[int]
    ages: Optional[Sequence[float]] = None
    max_new: int = 64
    max_age: Optional[float] = None
    death_token: Optional[int] = None
    uniforms: Optional[np.ndarray] = None
    seed: int = 0
    # repro-lint: disable=RL004 rng is host-only by design: to_json rejects
    # it (RngNotSerializableError) and from_json can never reconstruct live
    # PRNG state, so it intentionally does not round-trip
    rng: Optional[np.random.Generator] = None
    # client-chosen handle for mid-flight cancellation (``Client.cancel`` /
    # ``POST /v1/cancel``); additive wire field, omitted when unset
    request_id: Optional[str] = None

    def to_json(self) -> dict:
        """Canonical wire form.  ``rng`` cannot cross a process boundary —
        inject ``uniforms`` (bit-exact) or pass ``seed`` instead."""
        if self.rng is not None:
            raise RngNotSerializableError(
                "GenerateRequest.rng holds live host PRNG state and is not "
                "JSON-serializable: inject `uniforms` for bit-exact "
                "cross-process determinism, or pass `seed`")
        d: dict = {
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "tokens": [int(t) for t in self.tokens],
            "max_new": int(self.max_new),
            "seed": int(self.seed),
        }
        if self.ages is not None:
            d["ages"] = [float(a) for a in self.ages]
        if self.max_age is not None:
            d["max_age"] = float(self.max_age)
        if self.death_token is not None:
            d["death_token"] = int(self.death_token)
        if self.uniforms is not None:
            d["uniforms"] = _encode_array(np.asarray(self.uniforms))
        if self.request_id is not None:
            d["request_id"] = str(self.request_id)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "GenerateRequest":
        if not isinstance(d, dict):
            raise InvalidRequestError("request body must be a JSON object")
        check_protocol(d)
        u = d.get("uniforms")
        tokens = _require(d, "tokens")
        try:
            return cls(
                tokens=[int(t) for t in tokens],
                ages=([float(a) for a in d["ages"]]
                      if d.get("ages") is not None else None),
                max_new=int(d.get("max_new", 64)),
                max_age=(float(d["max_age"])
                         if d.get("max_age") is not None else None),
                death_token=(int(d["death_token"])
                             if d.get("death_token") is not None else None),
                uniforms=(_decode_array(u, "uniforms")
                          if u is not None else None),
                seed=int(d.get("seed", 0)),
                request_id=(str(d["request_id"])
                            if d.get("request_id") is not None else None))
        except InvalidRequestError:
            raise
        except (ValueError, TypeError) as e:    # wrong-typed field -> 400,
            raise InvalidRequestError(          # not a 500 internal
                f"malformed request field: {e}") from e


@dataclasses.dataclass
class TrajectoryEvent:
    """One generated event, as yielded by ``Client.stream``."""
    index: int                      # 0-based position in the generated suffix
    token: int
    age: Optional[float] = None     # None for generic-LM configs

    def to_json(self) -> dict:
        d: dict = {"index": int(self.index), "token": int(self.token)}
        if self.age is not None:
            d["age"] = float(self.age)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TrajectoryEvent":
        return cls(index=int(_require(d, "index")),
                   token=int(_require(d, "token")),
                   age=(float(d["age"]) if d.get("age") is not None else None))


@dataclasses.dataclass
class TrajectoryResult:
    """Generated continuation of one trajectory (all backends).

    ``request_id`` echoes the id the request was tracked under when one was
    in play — client-supplied, or assigned by the multi-replica router,
    which pins ``stream``/``cancel``/``futures`` for that id to one replica.
    Additive wire field; omitted when unset.
    """
    tokens: List[int]
    ages: List[float]
    prompt_tokens: List[int]
    prompt_ages: List[float]
    backend: str = ""
    request_id: Optional[str] = None

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def full_tokens(self) -> List[int]:
        return list(self.prompt_tokens) + list(self.tokens)

    @property
    def full_ages(self) -> List[float]:
        return list(self.prompt_ages) + list(self.ages)

    def events(self) -> List[TrajectoryEvent]:
        ages: List[Optional[float]] = (list(self.ages) if self.ages
                                       else [None] * len(self.tokens))
        return [TrajectoryEvent(index=i, token=t, age=a)
                for i, (t, a) in enumerate(zip(self.tokens, ages))]

    def to_json(self) -> dict:
        d: dict = {
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "tokens": [int(t) for t in self.tokens],
            "ages": [float(a) for a in self.ages],
            "prompt_tokens": [int(t) for t in self.prompt_tokens],
            "prompt_ages": [float(a) for a in self.prompt_ages],
            "backend": self.backend,
        }
        if self.request_id is not None:
            d["request_id"] = str(self.request_id)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TrajectoryResult":
        check_protocol(d)
        return cls(tokens=[int(t) for t in _require(d, "tokens")],
                   ages=[float(a) for a in d.get("ages", [])],
                   prompt_tokens=[int(t) for t in d.get("prompt_tokens", [])],
                   prompt_ages=[float(a) for a in d.get("prompt_ages", [])],
                   backend=str(d.get("backend", "")),
                   request_id=(str(d["request_id"])
                               if d.get("request_id") is not None else None))


@dataclasses.dataclass
class FuturesRequest:
    """N Monte-Carlo futures of one patient history — the morbidity-risk
    workload (``Client.sample_futures`` / ``POST /v1/futures``).

    ``uniforms`` — optional pre-drawn (n_futures, max_new, V) U(0,1), row
    ``[i, j]`` consumed by future ``i``'s ``j``-th sampled event — makes
    the whole fan-out deterministic and bit-comparable across backends;
    otherwise draws derive from ``seed``.  ``horizon``/``top`` shape the
    aggregated ``RiskReport``.  On engine-backed servers ``request_id``
    prefixes the forked children's ids (``<id>/fork-<i>``), so individual
    futures can be cancelled mid-flight."""
    tokens: Sequence[int]
    ages: Optional[Sequence[float]] = None
    n_futures: int = 16
    max_new: int = 48
    horizon: float = 5.0
    top: int = 10
    uniforms: Optional[np.ndarray] = None
    seed: int = 0
    request_id: Optional[str] = None

    def to_json(self) -> dict:
        d: dict = {
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "tokens": [int(t) for t in self.tokens],
            "n_futures": int(self.n_futures),
            "max_new": int(self.max_new),
            "horizon": float(self.horizon),
            "top": int(self.top),
            "seed": int(self.seed),
        }
        if self.ages is not None:
            d["ages"] = [float(a) for a in self.ages]
        if self.uniforms is not None:
            d["uniforms"] = _encode_array(np.asarray(self.uniforms))
        if self.request_id is not None:
            d["request_id"] = str(self.request_id)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "FuturesRequest":
        if not isinstance(d, dict):
            raise InvalidRequestError("futures body must be a JSON object")
        check_protocol(d)
        u = d.get("uniforms")
        tokens = _require(d, "tokens")
        try:
            return cls(
                tokens=[int(t) for t in tokens],
                ages=([float(a) for a in d["ages"]]
                      if d.get("ages") is not None else None),
                n_futures=int(d.get("n_futures", 16)),
                max_new=int(d.get("max_new", 48)),
                horizon=float(d.get("horizon", 5.0)),
                top=int(d.get("top", 10)),
                uniforms=(_decode_array(u, "uniforms")
                          if u is not None else None),
                seed=int(d.get("seed", 0)),
                request_id=(str(d["request_id"])
                            if d.get("request_id") is not None else None))
        except InvalidRequestError:
            raise
        except (ValueError, TypeError) as e:
            raise InvalidRequestError(
                f"malformed futures request field: {e}") from e


@dataclasses.dataclass
class RiskItem:
    token: int
    risk: float

    def to_json(self) -> dict:
        return {"token": int(self.token), "risk": float(self.risk)}

    @classmethod
    def from_json(cls, d: dict) -> "RiskItem":
        return cls(token=int(_require(d, "token")),
                   risk=float(_require(d, "risk")))


@dataclasses.dataclass
class RiskReport:
    """Within-horizon next-event risks, highest first (the App's output)."""
    horizon: float
    items: List[RiskItem]
    backend: str = ""

    def top(self, n: int) -> List[RiskItem]:
        return self.items[:n]

    def as_dicts(self) -> List[dict]:
        """Legacy ``InferenceSession.estimate_risk`` schema."""
        return [{"token": it.token, "risk": it.risk} for it in self.items]

    def to_json(self) -> dict:
        return {
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "horizon": float(self.horizon),
            "items": [it.to_json() for it in self.items],
            "backend": self.backend,
        }

    @classmethod
    def from_json(cls, d: dict) -> "RiskReport":
        check_protocol(d)
        return cls(horizon=float(_require(d, "horizon")),
                   items=[RiskItem.from_json(it)
                          for it in d.get("items", [])],
                   backend=str(d.get("backend", "")))


@dataclasses.dataclass
class FuturesResult:
    """Aggregated Monte-Carlo futures: the within-horizon ``RiskReport``
    plus the N sampled continuations behind it (each a
    ``TrajectoryResult``, so parity against any other backend is
    assertable event for event).  ``sharing`` carries the serving engine's
    pool telemetry snapshotted at completion — engine-LIFETIME cumulative
    counters (forks, copy-on-write copies, preemptions, prefix-cache hit
    rate since engine start), not per-request deltas — and is empty for
    host-loop backends."""
    risk: RiskReport
    trajectories: List[TrajectoryResult]
    n_futures: int
    backend: str = ""
    sharing: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "risk": self.risk.to_json(),
            "trajectories": [t.to_json() for t in self.trajectories],
            "n_futures": int(self.n_futures),
            "backend": self.backend,
            "sharing": self.sharing,
        }

    @classmethod
    def from_json(cls, d: dict) -> "FuturesResult":
        check_protocol(d)
        return cls(risk=RiskReport.from_json(_require(d, "risk")),
                   trajectories=[TrajectoryResult.from_json(t)
                                 for t in d.get("trajectories", [])],
                   n_futures=int(d.get("n_futures", 0)),
                   backend=str(d.get("backend", "")),
                   sharing=dict(d.get("sharing") or {}))
