"""InferenceSession of the port — the paper's JavaScript SDK, a thin shim.

DEPRECATED surface: ``InferenceSession`` is kept as a compatibility layer
over the unified client (``repro_torch.api.Client`` with an
``ArtifactBackend``)
and preserves the original call/return conventions exactly:

  loading            -> ``InferenceSession(artifact_dir)``
  tensor creation    -> backend ``_pad_inputs`` (pad to the graph's fixed axes)
  execution          -> ``get_logits`` (alias ``getLogits``, deprecated)
  post-processing    -> ``generate_trajectory`` (alias ``generateTrajectory``)
                        — eq. 1 sampling in *host* NumPy, outside the graph,
                        exactly where the browser SDK samples in JS.

The shim pins the paper-faithful **full-graph-per-token** loop
(``use_decode_graph=False``) so v1 numerics are preserved bit-for-bit; new
code should use ``repro_torch.api.Client`` directly, which on spec-v2
artifacts generates via the exported prefill + KV-cached decode graphs instead.

Termination defaults match the paper: Death token, max age 85 — both
overridable by the SDK user.  ``uniforms`` can be injected for bit-parity
tests against the in-graph sampler (claims C2/C3).  ``device`` is the
runtime's (``"cuda"`` unless the caller passes ``"cpu"``).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np


def _deprecated_alias(old: str, new: str, fn):
    def wrapper(self, *args, **kwargs):
        warnings.warn(f"InferenceSession.{old} is deprecated; use "
                      f"repro_torch.api.Client (or .{new}) instead",
                      DeprecationWarning, stacklevel=2)
        return fn(self, *args, **kwargs)
    wrapper.__name__ = old
    wrapper.__doc__ = f"Deprecated camelCase alias of :meth:`{new}`."
    return wrapper


class InferenceSession:
    def __init__(self, artifact_dir: str, *, device="cuda"):
        # local import: the api imports this package's export module, which
        # imports this one through repro_torch.sdk's __init__
        from repro_torch.api.client import ArtifactBackend, Client
        self.client = Client(ArtifactBackend(
            artifact_dir, use_decode_graph=False, device=device))
        backend = self.client.backend
        self.runtime = backend.runtime
        self.seq_len = backend.seq_len
        self.vocab_size = backend.vocab_size
        self.has_ages = backend.has_ages
        self.death_token = backend.death_token
        self.max_age = backend.max_age

    # -- execution ------------------------------------------------------------
    def get_logits(self, tokens: Sequence[int],
                   ages: Optional[Sequence[float]] = None) -> np.ndarray:
        """Logits for the *next* event given the trajectory so far: (V,)."""
        return self.client.backend.logits(tokens, ages)

    # -- post-processing (eq. 1 sampling, host-side) ---------------------------
    def generate_trajectory(self, tokens: Sequence[int],
                            ages: Sequence[float], *,
                            max_new: int = 64,
                            max_age: Optional[float] = None,
                            death_token: Optional[int] = None,
                            rng: Optional[np.random.Generator] = None,
                            uniforms: Optional[np.ndarray] = None
                            ) -> Dict[str, List]:
        """Iterative client-side generation (the App's right-hand panel)."""
        from repro_torch.api.schemas import GenerateRequest
        res = self.client.generate(GenerateRequest(
            tokens=tokens, ages=ages, max_new=max_new, max_age=max_age,
            death_token=death_token, uniforms=uniforms, rng=rng))
        return {"tokens": res.tokens, "ages": res.ages,
                "full_tokens": res.full_tokens, "full_ages": res.full_ages}

    # -- morbidity-risk estimates (the App's displayed output) -----------------
    def estimate_risk(self, tokens: Sequence[int], ages: Sequence[float], *,
                      horizon: float = 5.0, top: int = 10) -> List[dict]:
        """Closed-form within-horizon next-event risks, client-side.

        P(next = i, t <= h) = softmax(logits)_i * (1 - e^{-Lambda h}).
        Returns the ``top`` risks as {token, risk} dicts, highest first.
        """
        return self.client.risk(tokens, ages, horizon=horizon,
                                top=top).as_dicts()

    # paper SDK naming — deprecated camelCase aliases
    getLogits = _deprecated_alias("getLogits", "get_logits", get_logits)
    generateTrajectory = _deprecated_alias(
        "generateTrajectory", "generate_trajectory", generate_trajectory)
    estimateRisk = _deprecated_alias("estimateRisk", "estimate_risk",
                                     estimate_risk)
