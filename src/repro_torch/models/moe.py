"""Mixture-of-experts MLP of the port (the JAX package's ``models/moe.py``):
a top-k router over ``E`` routed experts, optional shared experts, and the
Switch load-balance loss.

Routing follows the reference: router logits in fp32, softmax, top-k,
the k weights renormalised to sum to 1, and the aux loss ``E * sum_e f_e *
p_e`` (``f_e`` the share of routed slots that chose expert ``e``, ``p_e``
its mean probability).  The router weight stays fp32 (it is not a
``MATMUL_KEYS`` leaf); the experts' weights enter their products in the
activation dtype.

Dispatch (:func:`apply_moe`'s ``impl``, the reference's four names):

* ``"dense_scan"`` (the default; what the engine, the SDK graphs and the
  training route run) computes the function of the reference's
  ``moe_dense_scan`` (every expert over every token, combined with the
  mostly-zero router weights) as batched products over the whole expert
  stack, ``(E, t, d) x (E, d, f)`` for gate and up, SiLU(gate) * up, ``x
  (E, f, d)``, then the combine over the experts with the ``(t, E)``
  router weights.  Each of these gives a token's row the same bits
  whatever the number of tokens t beside it (measured on the H100 from 8
  to 1,024 rows), which keeps a prompt prefilled in chunks bit-equal to
  the same prompt prefilled whole; one product ``(t, E f) x (E f, d)``
  that summed over the experts as it contracted did not (cuBLAS splits its
  84,480-long contraction by t).  Tokens go through in chunks of fixed
  length (:func:`token_chunk`), so that each ``(E, t, .)`` intermediate
  holds at most ``CHUNK_ELEMENTS`` elements.  Nothing here reads a value
  back to the host or takes a shape from the data, so a serving tick keeps
  its one host copy and ``torch.export`` traces the route.
* ``"dense_einsum"`` is the same function: the reference keeps a second
  dense form only for its expert-sharded all-reduce over a mesh's model
  axis, which one card does not have, so it runs the batched route above.
* ``"ragged"`` (:func:`moe_ragged`) runs the routed experts' products
  only, as the reference's ``moe_ragged``: the T·k (token, expert) pairs
  stably sorted by expert, group offsets from a count of fixed shape
  ``(E,)`` kept on the device, the rows gathered, grouped products for
  gate, up and down (see :func:`grouped_route` for which product runs),
  each row scaled by its weight, and the sort inverted, each token's k
  rows summed in a fixed order (no atomics: ``index_add_`` on the card
  would change the bits from run to run).
* ``"ragged_local"`` takes ``"ragged"`` off a mesh, as the reference does.

Any other name raises ``ValueError`` (the reference's ``else`` takes
``dense_scan`` silently).

On DTensors (a sharded step) the dense routes run
:func:`_dense_sharded`: each rank routes its own tokens (the router's
products, softmax, top-k and the combine weights, through ``local_map``;
the aux loss from the expert shares and mean probabilities summed over
the data axes), and the expert products run on DTensors in one chunk,
the experts (or, where their count does not divide the model axis, each
expert's hidden width) split over ``model`` by ``launch.sharding``'s
specs, so the combine ends in a partial sum over ``model``.

The ragged routes run :func:`_ragged_sharded`, two ``local_map`` calls
on the local tensors: the routing (every rank of the model axis routes
the same rows), then the sort, gather, grouped products and combine on
the rank's own expert weights, which stay where ``launch.sharding`` put
them.  Where the experts split over ``model`` a rank sorts its own
experts' rows first and multiplies only those (the grouped product's
offsets end at them; the rows past them are zeroed going into every
grouped product and coming out of it); where their hidden
width splits, it multiplies every row by its slice of each expert.  The
output is a partial sum over ``model``, which the block's
``sharded.reduce_rows`` all-reduces.  ``"ragged_local"`` routes each data
shard's own rows, and its aux loss is the mean over the data shards of
each shard's aux, as the reference's ``shard_map`` (``out_specs=P(da)``,
then the mean); ``"ragged"`` first gathers the tokens over the data axes,
so that every rank sorts the whole batch and the aux is the one over all
tokens, as GSPMD partitions the reference's global sort; each rank keeps
its own rows of the output.  On a mesh of one device both are the plain
``"ragged"`` route, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharded
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_swiglu

# the fp32 router product runs in blocks of this many rows (the last one
# zero-padded): cuBLAS's fp32 kernels sum an (M, d) x (d, E) product's row
# in another order as M changes (measured on the H100 at E 60 and 64 from
# M 8 to 8,192, batched or not), and a token routed by other bits in a
# chunked prefill than in a whole one can flip an expert and part the two;
# at one shape every row gets the same bits
ROUTER_ROWS = 256

# the names apply_moe takes (the reference's)
IMPLS = ("dense_scan", "ragged", "ragged_local", "dense_einsum")

# the (E, t, f) and (E, t, d) intermediates of one token chunk: 2^27
# elements each at most, 256 MB in bf16 (Qwen2-MoE: 1,092 tokens a chunk,
# OLMoE: 1,024)
CHUNK_ELEMENTS = 1 << 27


def router_logits(router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (T, d) @ router (d, E) in fp32, in products of ``ROUTER_ROWS``
    rows each, so that a row's logits do not depend on T."""
    T = x.shape[0]
    xf = F.pad(x.float(), (0, 0, 0, (-T) % ROUTER_ROWS))
    r = router.float()
    out = [xf[i:i + ROUTER_ROWS] @ r
           for i in range(0, xf.shape[0], ROUTER_ROWS)]
    return (out[0] if len(out) == 1 else torch.cat(out))[:T]


def _top_k(probs: torch.Tensor, top_k: int):
    """(weights, experts) of :func:`route`: a stable descending sort's
    first k, the weights renormalised."""
    weights, experts = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    weights, experts = weights[:, :top_k], experts[:, :top_k]
    return weights / weights.sum(dim=-1, keepdim=True), experts


def route(router: torch.Tensor, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> (weights (T, k) fp32, experts (T, k) int64, aux fp32
    scalar).

    ``lax.top_k`` puts the lower index first among equal values.
    ``torch.topk`` does not promise any order among them (on the CPU it
    returned experts 1 and 3 of four equal probabilities, not 0 and 1), so
    the experts are taken from a stable descending sort, which keeps the
    lower index first."""
    probs = torch.softmax(router_logits(router, x), dim=-1)         # (T, E)
    weights, experts = _top_k(probs, top_k)
    E = probs.shape[-1]
    chosen = torch.zeros_like(probs).scatter_add_(
        1, experts, torch.ones_like(weights))                      # (T, E)
    aux = E * (chosen.mean(dim=0) * probs.mean(dim=0)).sum()
    return weights, experts, aux


def token_chunk(cfg: ModelConfig) -> int:
    """Tokens a chunk of :func:`apply_moe`'s products takes."""
    return max(1, CHUNK_ELEMENTS // (cfg.n_experts
                                     * max(cfg.d_model, cfg.moe_d_ff)))


def grouped_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The grouped product :func:`grouped_mm` runs for rows ``x`` (M, K)
    against a stack ``w`` (E, K, N): ``"torch._grouped_mm"`` where torch
    has it, both are bf16 and both row widths K and N are multiples of 8
    elements (its 16-byte stride rule; OLMoE's and Qwen2-MoE's widths meet
    it); else ``"plain"``, a loop over the experts that reads the group
    offsets to the host once a call.  The choice depends on dtypes, widths
    and torch alone, never on a failed call: a grouped call that fails
    raises."""
    if (hasattr(torch, "_grouped_mm") and x.dtype == torch.bfloat16
            and w.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and w.shape[-1] % 8 == 0):
        return "torch._grouped_mm"
    return "plain"


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor, *,
               bounds: Optional[list] = None) -> torch.Tensor:
    """Rows ``x`` (M, K) sorted by group against ``w`` (E, K, N): row r of
    group e (``offs[e-1] <= r < offs[e]``, ``offs`` the int32 cumulative
    group sizes) times ``w[e]``; (M, N) in x's dtype.  Rows past
    ``offs[-1]`` meet no group: the plain loop writes zeros there,
    ``torch._grouped_mm`` leaves whatever its output held (callers mask
    them).  ``bounds`` is ``offs`` on the host where the caller already
    read it (the plain route reads it once a call).  On the meta device
    (the dry run) the loop cannot read its offsets, and the product is
    one (M, K) x (K, N): every row meets one expert."""
    if grouped_route(x, w) == "torch._grouped_mm":
        return torch._grouped_mm(x, w, offs=offs)
    if x.device.type == "meta":
        return x @ w[0]
    if bounds is None:
        bounds = offs.tolist()
    outs, lo = [], 0
    for e, hi in enumerate(bounds):
        if hi > lo:
            outs.append(x[lo:hi] @ w[e])
        lo = hi
    if lo < x.shape[0]:
        outs.append(x.new_zeros((x.shape[0] - lo, w.shape[-1])))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def expert_rows(flat: torch.Tensor, weights: torch.Tensor,
                experts: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, n_experts: int, first: int = 0
                ) -> torch.Tensor:
    """The routed experts' output (T, d) in flat's dtype for tokens
    ``flat`` (T, d) routed to ``experts`` (T, k) with ``weights`` (T, k),
    through the expert stack ``wg``/``wu`` (E_l, d, f_l), ``wd`` (E_l,
    f_l, d): experts ``first .. first + E_l - 1`` of ``n_experts`` (all of
    them, or one rank's share where they split over ``model``; f_l the
    whole hidden width or a rank's slice of it).  The (token, expert)
    pairs are stably sorted by expert, counted from ``first`` (so a
    rank's own experts' rows come first, in expert and token order), the
    row count stays T·k and only the group boundaries come from the data;
    rows of another rank's experts meet no group and add zeros."""
    T, d = flat.shape
    dt = flat.dtype
    k = experts.shape[1]
    n_local = wg.shape[0]
    flat_expert = experts.reshape(-1)                               # (T k,)
    flat_weight = weights.reshape(-1)
    flat_token = torch.arange(T, device=flat.device).repeat_interleave(k)
    sorted_key, order = torch.sort(
        torch.remainder(flat_expert - first, n_experts), stable=True)
    sorted_token = flat_token[order]
    counts = torch.zeros(n_experts, dtype=torch.int64,
                         device=flat.device).scatter_add_(
        0, sorted_key, torch.ones_like(sorted_key))
    offs = torch.cumsum(counts[:n_local], 0).to(torch.int32)
    plain = grouped_route(flat, wg) == "plain" and flat.device.type != "meta"
    bounds = offs.tolist() if plain else None
    xs = flat[sorted_token]                                         # (T k, d)
    mine = (sorted_key < n_local)[:, None] if n_local < n_experts else None

    def own(t):
        # the rows past the last own group, zero: the grouped product
        # leaves them unwritten, forward and backward, and a value read
        # there (a NaN, or an inf times a zero gradient) would reach x's
        # and the routing weights' gradients
        return t if mine is None else torch.where(mine, t, 0)

    def product(a, w):
        return own(grouped_mm(a, w, offs, bounds=bounds))
    xs = own(xs)
    h = F.silu(product(xs, wg)) * product(xs, wu)
    ys = product(h, wd) * flat_weight[order][:, None].to(dt)
    # the sort inverted by a gather, then each token's k rows summed in
    # slot order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    per = ys[inv].reshape(T, k, d).float()
    out = per[:, 0]
    for j in range(1, k):
        out = out + per[:, j]
    return out.to(dt)


def moe_ragged(blk, flat: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_ragged`` on tokens ``flat`` (T, d): (routed
    experts' output (T, d) in flat's dtype, aux loss), through
    :func:`expert_rows` on the whole expert stack."""
    dt = flat.dtype
    weights, experts, aux = route(blk["moe/router"], flat, cfg.top_k)
    wg, wu, wd = (blk[n].to(dt) for n in ("moe/w_gate", "moe/w_up",
                                          "moe/w_down"))
    return expert_rows(flat, weights, experts, wg, wu, wd,
                       cfg.n_experts), aux


def _ragged_sharded(blk, flat, cfg: ModelConfig, local: bool):
    """:func:`moe_ragged` on DTensors (module docstring): ``local`` the
    reference's ``ragged_local`` (each data shard's rows, the mean of the
    shards' aux losses), else its ``ragged`` (the tokens gathered over the
    data axes first, the aux over all of them).  (T, d) in flat's row
    layout, a partial sum over ``model`` where the experts split there;
    aux loss."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = flat.device_mesh
    E, dt = cfg.n_experts, flat.dtype
    whole = [Replicate()] * dm.ndim
    own = sharded.batch_placements(flat.placements, dm)
    rows = own if local else whole
    flat = sharded.redistribute(flat, rows)
    summed = [Partial() if p == Shard(0) else Replicate() for p in rows]

    def route_local(router, x):
        weights, experts, aux = route(router, x, cfg.top_k)
        return weights, experts, aux.reshape(1)
    router = sharded.redistribute(blk["moe/router"], whole)
    weights, experts, aux = local_map(
        route_local, out_placements=(rows, rows, rows),
        in_placements=(whole, rows), in_grad_placements=(summed, rows),
        device_mesh=dm)(router, flat)
    wg, wu, wd = (blk[n].to(dt) for n in ("moe/w_gate", "moe/w_up",
                                          "moe/w_down"))
    # a rank of the model axis holds a split of the experts or of their
    # hidden width (its output a partial sum), or all of them whole
    out = [Partial() if ax == sharded.MODEL and isinstance(pw, Shard) else p
           for ax, pw, p in zip(dm.mesh_dim_names, wg.placements, rows)]

    def grads(w):
        return [Partial() if s == Shard(0) else p
                for s, p in zip(rows, w.placements)]

    def experts_local(x, w, e, g, u, d):
        first = sharded.model_rank(dm) * g.shape[0] if g.shape[0] < E else 0
        return expert_rows(x, w, e, g, u, d, E, first)
    y = local_map(
        experts_local, out_placements=out,
        in_placements=(rows, rows, rows, wg.placements, wu.placements,
                       wd.placements),
        in_grad_placements=(out, out, rows, grads(wg), grads(wu), grads(wd)),
        device_mesh=dm)(flat, weights, experts, wg, wu, wd)
    if not local:
        y = sharded.redistribute(y, [Shard(0) if p == Shard(0) else q
                                     for p, q in zip(own, out)])
    return y, aux.mean()


def _dense(blk, flat: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert over every token, the batched route of the module's
    docstring: (T, d) in flat's dtype, aux loss."""
    T = flat.shape[0]
    dt = flat.dtype
    weights, experts, aux = route(blk["moe/router"], flat, cfg.top_k)
    combine = torch.zeros((T, cfg.n_experts), dtype=dt,
                          device=flat.device).scatter_(1, experts,
                                                       weights.to(dt))
    wg, wu, wd = (blk[k].to(dt) for k in ("moe/w_gate", "moe/w_up",
                                          "moe/w_down"))
    E = wg.shape[0]
    step = token_chunk(cfg)
    outs = []
    for lo in range(0, T, step):
        xs = flat[lo:lo + step]
        xe = xs.unsqueeze(0).expand(E, *xs.shape)                   # (E, t, d)
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)           # (E, t, f)
        y = torch.bmm(h, wd)                                        # (E, t, d)
        outs.append(torch.einsum("etd,te->td", y, combine[lo:lo + step]))
    return (outs[0] if len(outs) == 1 else torch.cat(outs)), aux


def _dense_sharded(blk, flat, cfg: ModelConfig):
    """:func:`_dense` on DTensors (module docstring): (T, d), aux loss."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = flat.device_mesh
    T, dt, E = flat.shape[0], flat.dtype, cfg.n_experts
    rows = sharded.batch_placements(flat.placements, dm)
    flat = sharded.redistribute(flat, rows)
    whole = [Replicate()] * dm.ndim
    summed = [Partial() if p == Shard(0) else Replicate() for p in rows]

    def local(router, x):
        probs = torch.softmax(x.float() @ router.float(), dim=-1)
        weights, experts = _top_k(probs, cfg.top_k)
        combine = torch.zeros((x.shape[0], E), dtype=dt,
                              device=x.device).scatter_(1, experts,
                                                        weights.to(dt))
        chosen = torch.zeros_like(probs).scatter_add_(
            1, experts, torch.ones_like(weights))
        return combine, chosen.sum(dim=0), probs.sum(dim=0)
    router = sharded.redistribute(blk["moe/router"], whole)
    combine, chosen, psum = local_map(
        local, out_placements=(rows, summed, summed),
        in_placements=(whole, rows), in_grad_placements=(summed, rows),
        device_mesh=dm)(router, flat)
    aux = E * ((sharded.replicated(chosen) / T)
               * (sharded.replicated(psum) / T)).sum()
    wg, wu, wd = (blk[k].to(dt) for k in ("moe/w_gate", "moe/w_up",
                                          "moe/w_down"))
    xe = flat.unsqueeze(0).expand(E, *flat.shape)                   # (E, T, d)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)               # (E, T, f)
    y = torch.bmm(h, wd)                                            # (E, T, d)
    return torch.einsum("etd,te->td", y, combine), aux


def apply_moe(blk, x: torch.Tensor, cfg: ModelConfig,
              impl: str = "dense_scan") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss fp32 scalar).
    ``blk`` is a block's weights by name (``models.model.Block``):
    ``moe/router`` (d, E), ``moe/w_gate``/``moe/w_up`` (E, d, f),
    ``moe/w_down`` (E, f, d) and, with shared experts, the SwiGLU MLP
    ``moe/shared/*`` of width ``n_shared_experts * f``, added after every
    dispatch.  ``impl`` picks the dispatch (module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}: one of {IMPLS}")
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    if sharded.is_dtensor(flat):
        if impl in ("ragged", "ragged_local"):
            y, aux = _ragged_sharded(blk, flat, cfg, impl == "ragged_local")
        else:
            y, aux = _dense_sharded(blk, flat, cfg)
    elif impl in ("ragged", "ragged_local"):
        y, aux = moe_ragged(blk, flat, cfg)
    else:
        y, aux = _dense(blk, flat, cfg)
    if "moe/shared/w_gate" in blk:
        y = y + apply_swiglu(flat, blk["moe/shared/w_gate"],
                             blk["moe/shared/w_up"], blk["moe/shared/w_down"])
    return y.reshape(B, S, d), aux
