"""The port's Delphi dual loss and its training attention against the JAX
package's.

* ``event_ce``, ``time_nll``, ``joint_nll`` and ``dual_loss`` on the same
  fp32 logits (hypothesis cases as in ``tests/test_losses.py``): two
  libraries' fp32 ``logsumexp`` and ``exp``, measured on the CPU over 2,000
  random cases (V 2-40, logits in [-6, 6], dt in [1/128, 10]) to agree
  within 2.9e-6 relative (to max(|value|, 1)); the tests allow 1e-5.
* The port's own factorization identity ``joint == ce + time``, masking,
  ``time_weight`` and the time-NLL optimum, as the JAX package's tests.
* ``models.attention.chunked_attention`` (the training route's attention)
  against JAX's ``chunked_attention`` on the same fp32 inputs: its dense
  branch, and its online-softmax branch (forced with 16-token blocks);
  causal, windowed, GQA, invalid keys (every row keeps a valid key).
  Measured < 6e-7; allowed 2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypcompat import given, hnp, settings, st

from repro.core import losses as jl
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.core import losses as tl
from repro_torch.models.attention import chunked_attention

torch.set_num_threads(2)

RTOL = 1e-5       # relative to max(|value|, 1)
ATTN_ATOL = 2e-6


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= rtol, err.max()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


LOGITS = hnp.arrays(np.float32, (3, 5, 11),
                    elements=st.floats(-6, 6, width=32,
                                       allow_subnormal=False))
DT = hnp.arrays(np.float32, (3, 5),
                elements=st.floats(0.0078125, 10, width=32,
                                   allow_subnormal=False))
TARGETS = hnp.arrays(np.int64, (3, 5), elements=st.integers(0, 10))
MASK = hnp.arrays(np.float32, (3, 5), elements=st.sampled_from([0.0, 1.0]))


@settings(max_examples=25, deadline=None)
@given(logits=LOGITS, dt=DT, targets=TARGETS, mask=MASK)
def test_losses_vs_jax(logits, dt, targets, mask):
    _close(tl.event_ce(_t(logits), _t(targets)),
           jl.event_ce(_j(logits), _j(targets)))
    _close(tl.time_nll(_t(logits), _t(dt)), jl.time_nll(_j(logits), _j(dt)))
    _close(tl.joint_nll(_t(logits), _t(targets), _t(dt)),
           jl.joint_nll(_j(logits), _j(targets), _j(dt)))
    got = tl.dual_loss(_t(logits), _t(targets), _t(dt), _t(mask),
                       time_weight=0.5)
    want = jl.dual_loss(_j(logits), _j(targets), _j(dt), _j(mask),
                        time_weight=0.5)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


@settings(max_examples=25, deadline=None)
@given(logits=LOGITS, dt=DT, targets=TARGETS)
def test_factorization_identity(logits, dt, targets):
    """joint NLL == event CE + time NLL in the port, for any inputs."""
    lhs = tl.joint_nll(_t(logits), _t(targets), _t(dt))
    rhs = tl.event_ce(_t(logits), _t(targets)) + tl.time_nll(_t(logits),
                                                             _t(dt))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_masking():
    logits = torch.zeros((1, 4, 7))
    targets = torch.tensor([[1, 2, 3, 4]])
    dt = torch.ones((1, 4))
    m_all = tl.dual_loss(logits, targets, dt, torch.ones((1, 4)))
    m_half = tl.dual_loss(logits, targets, dt,
                          torch.tensor([[1.0, 1.0, 0.0, 0.0]]))
    # uniform logits: CE = log(V) whatever the mask covers
    np.testing.assert_allclose(float(m_all["event_ce"]), np.log(7), rtol=1e-5)
    np.testing.assert_allclose(float(m_half["event_ce"]), np.log(7),
                               rtol=1e-5)
    # a fully masked batch must not NaN, and masked positions do not count
    m_none = tl.dual_loss(logits, targets, dt, torch.zeros((1, 4)))
    assert bool(torch.isfinite(m_none["loss"]))
    big = logits.clone()
    big[0, 3] = 50.0
    m_big = tl.dual_loss(big, targets, dt,
                         torch.tensor([[1.0, 1.0, 1.0, 0.0]]))
    m_ref = tl.dual_loss(logits, targets, dt,
                         torch.tensor([[1.0, 1.0, 1.0, 0.0]]))
    assert float(m_big["loss"]) == float(m_ref["loss"])


def test_time_nll_optimum():
    """Exp-NLL is minimized when the total rate equals 1/dt."""
    dt = torch.tensor(2.0)
    rates = torch.linspace(0.1, 2.0, 200)
    nll = tl.time_nll(torch.log(rates)[:, None], dt)
    best = float(rates[int(torch.argmin(nll))])
    np.testing.assert_allclose(best, 0.5, rtol=0.05)


def test_time_weight():
    logits = torch.zeros((1, 3, 5))
    targets = torch.zeros((1, 3), dtype=torch.int32)
    dt = torch.ones((1, 3))
    mask = torch.ones((1, 3))
    m0 = tl.dual_loss(logits, targets, dt, mask, time_weight=0.0)
    m2 = tl.dual_loss(logits, targets, dt, mask, time_weight=2.0)
    assert float(m0["loss"]) == float(m0["event_ce"])
    np.testing.assert_allclose(
        float(m2["loss"]), float(m2["event_ce"] + 2.0 * m2["time_nll"]),
        rtol=1e-6)


ATTN_CASES = [
    # (B, Sq, Skv, Hkv, G, hd, causal, window, invalid keys, note)
    pytest.param(2, 24, 24, 3, 1, 10, True, None, 0, id="causal"),
    pytest.param(2, 24, 24, 2, 2, 8, True, 6, 0, id="window-gqa"),
    pytest.param(1, 20, 20, 2, 1, 16, False, None, 5, id="bidir-invalid"),
    pytest.param(2, 40, 40, 3, 1, 10, True, None, 3, id="causal-invalid"),
]


@pytest.mark.parametrize("B,Sq,Skv,Hkv,G,hd,causal,window,n_bad", ATTN_CASES)
@pytest.mark.parametrize("q_block", [512, 16], ids=["dense", "blocked"])
def test_chunked_attention_vs_jax(B, Sq, Skv, Hkv, G, hd, causal, window,
                                  n_bad, q_block):
    rng = np.random.default_rng(Sq * 7 + hd)
    q = rng.standard_normal((B, Sq, Hkv * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    q_pos = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    k_pos = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    if n_bad:
        k_pos[:, rng.choice(Skv, n_bad, replace=False)] = -1
    want = jax_chunked(_j(q), _j(k), _j(v), _j(q_pos), _j(k_pos),
                       causal=causal, window=window, q_per_kv=G,
                       q_block=q_block, kv_block=q_block)
    got = chunked_attention(_t(q), _t(k), _t(v), _t(q_pos), _t(k_pos),
                            causal=causal, window=window, q_per_kv=G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL, rtol=0)


def test_chunked_attention_is_differentiable():
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.standard_normal((1, 6, 2, 4)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    pos = torch.arange(6)
    chunked_attention(q, k, v, pos, pos).square().sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)
