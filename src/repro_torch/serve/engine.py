"""Batched serving engine: device-resident continuous batching over a
per-slot decode cache (the JAX package's ``serve/engine.py``,
``cache="ring"``), for Delphi and for generic LMs (Mamba2).

* Each tick runs ONE batched ``decode_step`` over all slots, each at its own
  absolute position, then samples, then ``advance_trajectory_state``.
  Delphi samples eq. 1 (``sample_next_event``: the ``tte_sample`` CUDA
  kernel on the card); a generic LM samples by Gumbel-argmax,
  ``argmax(logits / temperature + g)``, with no age and no Death token.
  Slot state (last token, age, step, emitted count, budget, active) stays
  on the device.
* The host sees exactly ONE packed (4, slots) device->host copy per tick and
  one per admission batch, counted in ``host_syncs``.  Nothing else in a
  tick reads device values on the host.
* Admission of an attention model runs a bucketed-padding batched prefill:
  prompt lengths are right-padded to power-of-two buckets and admission
  groups to power-of-two batch buckets, the prefill builds rings of width
  ``max_context``, padded positions are invalidated
  (``mask_padded_positions``) and the rows are inserted into the slot
  cache.  Recurrent state (SSM) cannot mask padding, so such a model admits
  each prompt solo at its exact length.
* Uniforms are injected per request (rows of inactive slots are 0.5) or
  drawn from a ``torch.Generator`` on the device.

Out of scope for this slice, and refused: the paged cache, prefix caching,
chunked prefill and hold/fork/sample_futures.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import base as cb
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sampler import (advance_trajectory_state,
                                      sample_next_event)
from repro_torch.models import (cast_params, decode_step, forward,
                                make_decode_cache, mask_padded_positions)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """The engine's only device->host copy (tests count calls to it)."""
    return x.cpu().numpy()


class RequestCancelledError(RuntimeError):
    """The request was cancelled before it finished."""


class RequestTimeoutError(RuntimeError):
    """The request passed the engine's ``request_timeout``."""


@dataclasses.dataclass(eq=False)        # identity, not ndarray comparison
class Request:
    tokens: np.ndarray                  # (S,) prompt
    ages: Optional[np.ndarray] = None   # (S,) event ages in years (Delphi)
    max_new: int = 64
    # optional pre-drawn U(0,1) of shape (max_new, V): row i is consumed by
    # the i-th sampled event (row 0 at admission, from the prefill logits)
    uniforms: Optional[np.ndarray] = None
    request_id: Optional[str] = None    # autogenerated at submit when unset
    hold: bool = False                  # prefill-only parking: not ported
    # filled by the engine:
    out_tokens: Optional[List[int]] = None
    out_ages: Optional[List[float]] = None   # Delphi only; empty otherwise
    done: bool = False
    error: Optional[BaseException] = None
    _seq: int = dataclasses.field(default=0, repr=False)
    _deadline: Optional[float] = dataclasses.field(default=None, repr=False)


MIN_SEQ_BUCKET = 8       # smallest padded prompt width of a prefill


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


def _pack(adv) -> torch.Tensor:
    return torch.stack([adv["evt"].float(), adv["age"],
                        adv["emit"].float(), adv["finished"].float()])


def gumbel_sample(lg: torch.Tensor, u: torch.Tensor, inv_temp: float):
    """Generic-LM sampling: ``argmax(lg * inv_temp + g)`` with Gumbel noise
    ``g = -log(-log(clip(u, 1e-12, 1 - 1e-12)))`` from the uniforms.
    Returns (token (B,) int32, zero waiting times (B,) fp32)."""
    g = -torch.log(-torch.log(u.float().clamp(1e-12, 1.0 - 1e-12)))
    evt = torch.argmax(lg * inv_temp + g, dim=-1).to(torch.int32)
    return evt, torch.zeros(evt.shape, dtype=torch.float32, device=lg.device)


def _insert_rows(cache, rows, ids: torch.Tensor, n: int) -> None:
    """Write the first ``n`` prefill rows of every cache leaf into the slot
    cache at slots ``ids`` (leaves are (L, slots, ...)), in place."""
    for kind, big in cache.items():
        for buf, new in zip(big, rows[kind]):
            buf[:, ids] = new[:, :n].to(buf.dtype)


class BatchedEngine:
    """Slot-based continuous batching over a per-slot decode cache (a ring
    KV cache, or a Mamba2 model's SSM state).

    ``params`` are the fp32 flat parameters (``models.params``); they move
    to ``device`` (``cuda`` unless the caller passes another), and the
    matrix-product weights are cast once to ``cfg.dtype`` for compute.
    ``temperature`` scales a generic LM's logits (Delphi ignores it).
    """

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_context: int = 512, temperature: float = 1.0,
                 seed: int = 0, cache: str = "ring",
                 request_timeout: Optional[float] = None,
                 prefix_cache: bool = False,
                 prefill_chunk_tokens: Optional[int] = None,
                 device="cuda"):
        if cache != "ring":
            raise NotImplementedError(
                f"cache={cache!r}: only the ring cache is ported")
        if prefix_cache:
            raise NotImplementedError("prefix_cache is not ported")
        if prefill_chunk_tokens is not None:
            raise NotImplementedError("chunked prefill is not ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_context = max_context
        self.inv_temp = 1.0 / max(temperature, 1e-6)
        self.is_delphi = cfg.age_encoding
        # right-padding a prefill is sound only where padded positions can
        # be masked out of the state: KV-cache attention (pos = -1), not
        # recurrent SSM state, which admits unbucketed
        self.bucketed = cfg.arch_type in (cb.DENSE, cb.MOE, cb.VLM)
        self.request_timeout = request_timeout
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self._wparams = cast_params(self.params, cfg)
        self.cache = make_decode_cache(self._wparams, cfg, slots, max_context)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        dev = self.device
        self._state: Dict[str, torch.Tensor] = {
            "last": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "age": torch.zeros((slots,), dtype=torch.float32, device=dev),
            "step": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "n_emitted": torch.zeros((slots,), dtype=torch.int32, device=dev),
            "max_new": torch.ones((slots,), dtype=torch.int32, device=dev),
            "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
        }
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.pending: List[Request] = []               # guarded-by: _lock
        self.completed: List[Request] = []
        self._by_id: Dict[str, Request] = {}           # guarded-by: _lock
        self._cancel_ids: set = set()                  # guarded-by: _lock
        self._deactivate: List[int] = []
        self._seq_counter = itertools.count(1)
        self._lock = threading.Lock()
        # instrumentation (asserted on by tests and chip_smoke.py)
        self.ticks = 0
        self.host_syncs = 0
        self.admit_batches = 0
        self.prefill_shapes: set = set()

    # -- device->host boundary (the only one) -------------------------------
    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        self.host_syncs += 1
        return _to_host(x)

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Thread-safe enqueue."""
        if len(req.tokens) == 0:
            raise ValueError("empty prompt")
        if req.hold:
            raise NotImplementedError("hold/fork is not ported")
        if self.is_delphi and req.ages is None:
            raise ValueError("Delphi requests need ages")
        req.out_tokens, req.out_ages = [], []
        req._seq = next(self._seq_counter)
        if req.request_id is None:
            req.request_id = f"req-{id(self):x}-{req._seq}"
        if self.request_timeout is not None and req._deadline is None:
            req._deadline = time.monotonic() + self.request_timeout
        with self._lock:
            if req.request_id in self._by_id:
                raise ValueError(f"request_id {req.request_id!r} is already "
                                 f"in flight on this engine")
            self._by_id[req.request_id] = req
            self.pending.append(req)

    def cancel(self, request_id: str) -> bool:
        """Flag a pending or in-flight request for cancellation; the next
        tick drops it and it finishes with ``RequestCancelledError``.
        Returns False for unknown or finished ids."""
        with self._lock:
            req = self._by_id.get(request_id)
            if req is None or req.done:
                return False
            self._cancel_ids.add(request_id)
        return True

    def fork(self, *args, **kwargs):
        raise NotImplementedError("fork is not ported")

    def sample_futures(self, *args, **kwargs):
        raise NotImplementedError("sample_futures is not ported")

    # -- request lifecycle ----------------------------------------------------
    def _finalize(self, req: Request,
                  error: Optional[BaseException] = None) -> None:
        if error is not None:
            req.error = error
        req.done = True
        with self._lock:
            self._by_id.pop(req.request_id, None)
            self._cancel_ids.discard(req.request_id)
        if req.error is None:
            self.completed.append(req)

    def _evict(self, slot: int, error: BaseException) -> None:
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self._deactivate.append(slot)
        self._finalize(req, error)

    def _apply_control(self) -> None:
        """Tick-start pass: apply cancellations and expire deadlines, for
        queued and in-flight requests."""
        if not self._cancel_ids and self.request_timeout is None:
            return
        now = time.monotonic()

        def why(r: Request) -> Optional[BaseException]:
            if r.request_id in ids:
                return RequestCancelledError("request cancelled")
            if r._deadline is not None and now > r._deadline:
                return RequestTimeoutError("request exceeded its deadline")
            return None

        with self._lock:
            ids = set(self._cancel_ids)
            drop = [(r, why(r)) for r in self.pending]
            self.pending[:] = [r for r, e in drop if e is None]
        for r, err in drop:
            if err is not None:
                self._finalize(r, err)
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                err = why(r)
                if err is not None:
                    self._evict(slot, err)
        with self._lock:
            self._cancel_ids -= ids

    def _flush_deactivations(self) -> None:
        if self._deactivate:
            keep = np.ones(self.slots, bool)
            keep[self._deactivate] = False
            self._state["active"] &= torch.from_numpy(keep).to(self.device)
            self._deactivate.clear()

    # -- admission: bucketed batched prefill --------------------------------
    def _seq_bucket(self, n: int) -> int:
        return max(_next_pow2(n), MIN_SEQ_BUCKET)

    def _select_admission(self):
        """Pop the next admission cohort off ``pending`` (lock held): up to
        the free slots (one for a recurrent model), all injected or all
        generator-sampled (one tick draws from one uniform source); an
        over-width prompt admits solo."""
        if not self.pending:
            return None
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not free:
            return None
        injected = self.pending[0].uniforms is not None
        occupied = [r for r in self.slot_req if r is not None]
        if occupied and (occupied[0].uniforms is not None) != injected:
            return None
        limit = len(free) if self.bucketed else 1
        if len(self.pending[0].tokens) > self.max_context:
            limit = 1
        group: List[Request] = []
        while self.pending and len(group) < limit \
                and (self.pending[0].uniforms is not None) == injected:
            if group and len(self.pending[0].tokens) > self.max_context:
                break
            group.append(self.pending.pop(0))
        return group, free[:len(group)], injected

    def _admit(self) -> None:
        while True:
            with self._lock:
                sel = self._select_admission()
            if sel is None:
                return
            group, slot_ids, injected = sel
            try:
                self._admit_group(group, slot_ids, injected)
            except Exception:
                # a failed admission puts its un-slotted cohort back first
                with self._lock:
                    self.pending[:0] = [r for r in group
                                        if r not in self.slot_req]
                raise

    def _admit_group(self, group: List[Request], slot_ids: List[int],
                     injected: bool) -> None:
        n = len(group)
        lens = [len(r.tokens) for r in group]
        if self.bucketed and max(lens) <= self.max_context:
            # never bucket past the ring width: a pad-rounded S > W would
            # evict valid prompt context through the S > W ring pack
            sb = min(self._seq_bucket(max(lens)), self.max_context)
            nb = min(_next_pow2(n), self.slots)
        else:
            # exact shape: a solo over-width prompt, or recurrent state
            sb, nb = max(lens), n
        self.prefill_shapes.add((nb, sb))

        tokens = np.zeros((nb, sb), np.int32)
        ages = np.zeros((nb, sb), np.float32)
        age0 = np.zeros((nb,), np.float32)
        lengths = np.full((nb,), lens[0], np.int32)
        max_new = np.full((nb,), 1, np.int32)
        for j, r in enumerate(group):
            S = lens[j]
            tokens[j, :S] = r.tokens
            if self.is_delphi:
                ags = np.asarray(r.ages, np.float32)
                ages[j, :S] = ags
                ages[j, S:] = ags[-1]
                age0[j] = ags[-1]
            lengths[j] = S
            max_new[j] = r.max_new
        tokens[n:] = tokens[0]       # padded admission rows: clones of row 0,
        ages[n:] = ages[0]           # computed and discarded
        last_idx = lengths - 1
        if injected:
            u = np.full((nb, self.cfg.vocab_size), 0.5, np.float32)
            for j, r in enumerate(group):
                u[j] = r.uniforms[0]
            u_t = torch.from_numpy(u).to(self.device)
        else:
            u_t = self._rand(nb)

        dev = self.device
        lengths_t = torch.from_numpy(lengths).to(dev)
        last_t = torch.from_numpy(last_idx).to(dev)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        if self.is_delphi:
            batch["ages"] = torch.from_numpy(ages).to(dev)
        out = forward(self._wparams, self.cfg, batch, mode="prefill",
                      cache_width=self.max_context, last_index=last_t)
        rows_cache = mask_padded_positions(out["cache"], last_t)
        lg = out["logits"][:, 0]
        active = torch.ones((nb,), dtype=torch.bool, device=dev)
        max_new_t = torch.from_numpy(max_new).to(dev)
        adv = self._advance(lg, u_t, torch.from_numpy(age0).to(dev),
                            torch.zeros((nb,), dtype=torch.int32, device=dev),
                            max_new_t, lengths_t, active)
        rows = {
            "last": torch.where(adv["emit"], adv["evt"],
                                torch.zeros_like(adv["evt"])),
            "age": adv["age"],
            "step": lengths_t,
            "n_emitted": adv["n_emitted"],
            "max_new": max_new_t,
            "active": active & ~adv["finished"],
        }
        # one scatter per leaf writes the admitted rows into the slot cache
        ids = torch.tensor(slot_ids, dtype=torch.long, device=dev)
        _insert_rows(self.cache, rows_cache, ids, n)
        for key, val in rows.items():
            self._state[key][ids] = val[:n].to(self._state[key].dtype)

        self.admit_batches += 1
        arr = self._fetch(_pack(adv))    # ONE sync per admission batch
        for j, (req, slot) in enumerate(zip(group, slot_ids)):
            self.slot_req[slot] = req
            self._apply_host(req, slot, arr[:, j])

    # -- device math of a tick / an admission --------------------------------
    def _rand(self, rows: int) -> torch.Tensor:
        return torch.rand((rows, self.cfg.vocab_size), generator=self._gen,
                          device=self.device)

    def _advance(self, lg, u, age, n_emitted, max_new, next_pos, active):
        if self.is_delphi:
            evt, tmin = sample_next_event(lg, u)
        else:
            evt, tmin = gumbel_sample(lg, u, self.inv_temp)
        return advance_trajectory_state(
            evt, tmin, age, n_emitted, max_new, next_pos, active,
            max_age=self.cfg.max_age if self.is_delphi else float("inf"),
            death_token=self.cfg.death_token if self.is_delphi else -1,
            max_context=self.max_context)

    def _tick(self, u: torch.Tensor) -> torch.Tensor:
        st = self._state
        batch = {"tokens": st["last"][:, None]}
        if self.is_delphi:
            batch["ages"] = st["age"][:, None]
        d = decode_step(self._wparams, self.cfg, self.cache, batch,
                        st["step"])
        lg = d["logits"][:, 0]
        next_step = torch.where(st["active"], st["step"] + 1, st["step"])
        adv = self._advance(lg, u, st["age"], st["n_emitted"], st["max_new"],
                            next_step, st["active"])
        self._state = {
            "last": torch.where(adv["emit"], adv["evt"], st["last"]),
            "age": adv["age"],
            "step": next_step,
            "n_emitted": adv["n_emitted"],
            "max_new": st["max_new"],
            "active": st["active"] & ~adv["finished"],
        }
        return _pack(adv)

    def _apply_host(self, req: Request, slot: int, col: np.ndarray) -> None:
        evt, age, emit, finished = col
        if emit >= 0.5:
            req.out_tokens.append(int(evt))
            if self.is_delphi:
                req.out_ages.append(float(age))
        if finished >= 0.5:
            self.slot_req[slot] = None
            self._finalize(req)

    # -- the tick ------------------------------------------------------------
    def step(self) -> bool:
        """One engine tick: control pass (cancel/timeout), admit pending,
        then decode + sample every active slot on the device."""
        self._apply_control()
        self._flush_deactivations()   # deactivations BEFORE slots are reused
        self._admit()
        self._flush_deactivations()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        self.ticks += 1
        injected = [i for i in active if self.slot_req[i].uniforms is not None]
        if injected and len(injected) != len(active):
            raise ValueError("cannot mix uniform-injected and generator-"
                             "sampled requests in one tick")
        if injected:
            u = np.full((self.slots, self.cfg.vocab_size), 0.5, np.float32)
            for i in active:
                r = self.slot_req[i]
                u[i] = r.uniforms[len(r.out_tokens)]
            u_t = torch.from_numpy(u).to(self.device)
        else:
            u_t = self._rand(self.slots)
        arr = self._fetch(self._tick(u_t))    # ONE sync per tick
        for slot in active:
            self._apply_host(self.slot_req[slot], slot, arr[:, slot])
        return True

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until every submitted request has finished."""
        ticks = 0
        while (self.pending or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.completed
