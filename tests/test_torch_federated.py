"""The port's federated fine-tuning (FedAvg) against the JAX package's.

* ``aggregate`` with the noise off: the same sample-weighted fp32 mean of
  the same deltas, in the same order, plus ``server_lr`` times it: equal
  to JAX's within 1e-7 (measured: equal).  With DP noise on, the port
  draws it from an explicit ``torch.Generator`` (reproducible per seed,
  refused without one): its shapes, finiteness and std are checked.
* ``make_local_update``: two local AdamW steps from the same params on the
  same two ``pack_trajectories`` batches.  The forwards differ by one ulp
  of XLA's age-encoding ``exp`` (``test_torch_train.py``), and Adam's first
  steps move each parameter by about ``lr * sign(g)``, so elements whose
  gradient is below that error flip: measured over three seeds, the final
  loss within 1.2e-6 relative (allowed 1e-5), the delta within 1.03e-2 of
  its norm (allowed 3e-2), 99% of its elements within 1.7e-3 of the
  largest |delta| (allowed 5e-3), every element within 2 lr per step (the
  flip bound); with clipping the delta's global norm is the clip norm.
* Federated descent, as ``tests/test_federated.py``: validation loss falls
  below 0.97 of its start and the mean client loss falls.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.federated import fedavg as jfed
from repro_torch.configs import get_config
from repro_torch.core import loss_fn
from repro_torch.data import (SimulatorConfig, batches, generate_dataset,
                              pack_trajectories)
from repro_torch.federated import (FedConfig, aggregate, federated_finetune,
                                   make_local_update)
from repro_torch.models import init_params, to_flat_numpy
from repro_torch.train import global_norm

torch.set_num_threads(2)

LR = 1e-3


def jax_params(flat):
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return out


def jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _cfgs():
    return (get_config("delphi-2m", reduced=True).replace(
                dtype="float32", vocab_size=1289),
            jax_config("delphi-2m", reduced=True).replace(
                dtype="float32", vocab_size=1289))


@pytest.mark.parametrize("server_lr,clip", [(1.0, None), (0.5, 0.3)])
def test_aggregate_vs_jax_noise_off(server_lr, clip):
    rng = np.random.default_rng(0)
    shapes = {"a/w": (4, 3), "a/b": (3,), "c": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    deltas = [{k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()} for _ in range(3)]
    weights = [16.0, 48.0, 32.0]
    fed = dict(server_lr=server_lr, clip_delta_norm=clip)
    got = aggregate({k: torch.from_numpy(v) for k, v in params.items()},
                    [{k: torch.from_numpy(v) for k, v in d.items()}
                     for d in deltas], weights, FedConfig(**fed))
    want = jax_flat(jfed.aggregate(jax_params(params),
                                   [jax_params(d) for d in deltas], weights,
                                   jfed.FedConfig(**fed)))
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-7,
                                   rtol=0)
    # the weighted mean itself, as the JAX package's test states it
    out = aggregate({"w": torch.zeros(4)},
                    [{"w": torch.ones(4)}, {"w": torch.full((4,), 3.0)}],
                    [1.0, 3.0], FedConfig())
    np.testing.assert_allclose(out["w"].numpy(), 2.5)


def test_aggregate_clip_and_noise():
    params = {"w": torch.zeros(4096)}
    deltas = [{"w": torch.ones(4096)}]
    fed = FedConfig(clip_delta_norm=1.0, dp_noise_mult=0.1)
    with pytest.raises(ValueError, match="Generator"):
        aggregate(params, deltas, [1.0], fed)

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return aggregate(params, deltas, [1.0], fed, generator=g)["w"]
    out = run(3)
    assert out.shape == (4096,) and bool(torch.isfinite(out).all())
    assert torch.equal(out, run(3)) and not torch.equal(out, run(4))
    np.testing.assert_allclose(float((out - 1.0).std()), 0.1, rtol=0.1)


@pytest.mark.parametrize("clip", [None, 0.01], ids=["no-clip", "clip"])
def test_local_update_delta_vs_jax(clip):
    cfg, jcfg = _cfgs()
    params = init_params(cfg, seed=0, device="cpu")
    train, _ = generate_dataset(SimulatorConfig(n_train=16, n_val=1, seed=0))
    packed = pack_trajectories(train, 32)
    bs = [{k: v[i * 8:(i + 1) * 8] for k, v in packed.items()}
          for i in range(2)]
    fed = dict(local_steps=2, local_lr=LR, clip_delta_norm=clip)
    delta, loss = make_local_update(cfg, FedConfig(**fed))(
        params, [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs])
    stacked = {k: jnp.stack([jnp.asarray(b[k]) for b in bs]) for k in bs[0]}
    jdelta, jloss = jfed.make_local_update(jcfg, jfed.FedConfig(**fed))(
        jax_params(to_flat_numpy(params)), stacked)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jdelta = jax_flat(jdelta)
    assert set(delta) == set(jdelta)
    assert not any(d.requires_grad for d in delta.values())
    diff = np.concatenate([np.abs(delta[k].numpy() - jdelta[k]).ravel()
                           for k in delta])
    want = np.concatenate([jdelta[k].ravel() for k in delta])
    top = float(np.abs(want).max())
    assert np.linalg.norm(diff) <= 3e-2 * np.linalg.norm(want)
    assert np.quantile(diff, 0.99) <= 5e-3 * top
    if clip is None:
        assert diff.max() <= 2 * LR * fed["local_steps"]
    else:
        np.testing.assert_allclose(float(global_norm(delta)), clip,
                                   rtol=1e-5)
        assert diff.max() <= 2 * top


def test_federated_descent():
    cfg, _ = _cfgs()
    params = init_params(cfg, seed=0, device="cpu")
    train, val = generate_dataset(SimulatorConfig(n_train=96, n_val=32,
                                                  seed=4))
    k = 4                       # 4 clients, 24 patients each: never pooled
    client_iters = [batches(pack_trajectories(train[i::k], 48), 8, seed=i)
                    for i in range(k)]
    pv = pack_trajectories(val, 48)
    vb = {kk: torch.from_numpy(v[:16]) for kk, v in pv.items()}

    @torch.no_grad()
    def val_loss(p):
        return loss_fn(p, cfg, vb)["loss"]

    v0 = float(val_loss(params))
    fed = FedConfig(n_rounds=3, local_steps=5, local_lr=2e-3)
    out, hist = federated_finetune(params, cfg, client_iters, fed,
                                   eval_fn=val_loss, log_fn=lambda s: None,
                                   device="cpu")
    assert min(hist["val"]) < v0 * 0.97, (v0, hist["val"])
    assert hist["client_loss"][-1] < hist["client_loss"][0]
    assert hist["round"] == [0, 1, 2]
    assert not any(v.requires_grad for v in out.values())


def test_federated_finetune_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        federated_finetune(init_params(cfg, seed=0, device="cpu"), cfg, [],
                           FedConfig(n_rounds=1))
