"""Competing-exponential time-to-event sampling (paper eq. 1).

For each vocabulary entry a candidate waiting time

    t_i = -exp(-logit_i) * ln(u_i),    u_i ~ U(0,1)

is drawn and the argmin is the next event; patient age advances by t_min.
Generation stops at the Death token or when age would pass ``max_age``.
Uniforms are explicit inputs (injected, or drawn from a ``torch.Generator``)
so runs are reproducible and comparable across devices and with the JAX
package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import decode_step, forward


def sample_waiting_times(logits, u):
    """t_i = -exp(-logit_i) * ln(u_i).  logits, u: (..., V) fp32."""
    u = u.clamp(1e-12, 1.0 - 1e-12)
    return -torch.exp(-logits) * torch.log(u)


def sample_next_event(logits, u):
    """(B, V) logits and uniforms -> (event id (B,) int32, waiting time
    t_min (B,) fp32): the ``tte_sample`` kernel on the card, its plain
    version on the CPU."""
    return ops.tte_sample(logits, u)


def sample_next_event_np(logits, u):
    """Host-side NumPy twin of :func:`sample_next_event` for one trajectory:
    the eq.-1 sampler of every host-side client loop (``repro_torch.api``).
    ``u`` keeps its incoming dtype (injected fp32 uniforms stay fp32 through
    the log); logits are promoted to fp64.  Returns (event id, waiting time
    t_min) as Python scalars."""
    lg = np.asarray(logits).astype(np.float64)
    u = np.clip(u, 1e-12, 1 - 1e-12)
    t = -np.exp(-lg) * np.log(u)
    evt = int(np.argmin(t))
    return evt, float(t[evt])


def advance_trajectory_state(evt, tmin, age, n_emitted, max_new, next_pos,
                             active, *, max_age: float, death_token: int,
                             max_context: int):
    """Per-step termination and emission: an event whose waiting time takes
    age past ``max_age`` is censored — the trajectory ends BEFORE the event
    is emitted; Death is emitted, then terminates.  All inputs/outputs are
    (B,) tensors; ``next_pos`` is the absolute position where each row's
    next decode write would land.

    Returns dict with ``evt`` (0 where not emitted), ``age``, ``emit``,
    ``finished``, ``n_emitted``.
    """
    new_age = age + tmin
    over = new_age > max_age
    emit = active & ~over
    evt = torch.where(emit, evt, torch.zeros_like(evt))
    age_out = torch.where(emit, new_age, age)
    n_out = n_emitted + emit.to(n_emitted.dtype)
    ctx_full = next_pos + 1 >= max_context
    finished = active & (over | (emit & (evt == death_token))
                         | (n_out >= max_new) | ctx_full)
    return {"evt": evt, "age": age_out, "emit": emit, "finished": finished,
            "n_emitted": n_out}


def generate_trajectories(params, cfg: ModelConfig, tokens, ages, *,
                          max_new: int = 64, max_age: Optional[float] = None,
                          death_token: Optional[int] = None,
                          uniforms: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          cache_width: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
    """Straight-line batched generation (the engine's oracle).

    tokens/ages: (B, S) prompts on the parameters' device.  Returns dict
    with ``tokens``/``ages`` (B, S+max_new) (0 / last age after
    termination), ``n_generated`` (B,), ``alive_mask`` (B, max_new).

    uniforms: optional (B, max_new, V) pre-drawn U(0,1); otherwise drawn
    from ``generator`` on the device.
    """
    max_age = cfg.max_age if max_age is None else max_age
    death = cfg.death_token if death_token is None else death_token
    B, S = tokens.shape
    V = cfg.vocab_size
    dev = tokens.device
    W = cache_width or (S + max_new)

    pre = forward(params, cfg, {"tokens": tokens, "ages": ages},
                  mode="prefill", cache_width=W)
    cache = pre["cache"]
    logits = pre["logits"][:, -1]

    tok_buf = torch.cat([tokens.to(torch.int32),
                         torch.zeros((B, max_new), dtype=torch.int32,
                                     device=dev)], dim=1)
    age_buf = torch.cat([ages.float(), ages[:, -1:].float().expand(B, max_new)],
                        dim=1).clone()
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    alive_hist = torch.zeros((B, max_new), dtype=torch.bool, device=dev)
    n_gen = torch.zeros((B,), dtype=torch.int32, device=dev)
    for i in range(max_new):
        if uniforms is not None:
            u = uniforms[:, i]
        else:
            u = torch.rand((B, V), generator=generator, device=dev)
        evt, tmin = sample_next_event(logits, u)
        prev_age = age_buf[:, S + i - 1]
        new_age = prev_age + tmin
        emit = alive & ~(new_age > max_age)
        evt = torch.where(emit, evt, torch.zeros_like(evt))
        new_age = torch.where(emit, new_age, prev_age)
        tok_buf[:, S + i] = torch.where(emit, evt, tok_buf[:, S + i])
        age_buf[:, S + i] = new_age
        alive_hist[:, i] = emit
        n_gen += emit.to(torch.int32)
        alive = emit & (evt != death)
        step = torch.full((B,), S + i, dtype=torch.int32, device=dev)
        d = decode_step(params, cfg, cache,
                        {"tokens": evt[:, None], "ages": new_age[:, None]},
                        step)
        cache = d["cache"]
        logits = d["logits"][:, 0]
    return {"tokens": tok_buf, "ages": age_buf, "n_generated": n_gen,
            "alive_mask": alive_hist}
