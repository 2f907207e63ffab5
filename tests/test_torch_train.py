"""The port's training substrate against the JAX package's.

* ``cosine_lr`` at every step of a schedule: the same fp32 expression;
  the two libraries' fp32 ``cos`` differ by up to one ulp (measured), so
  3e-7 relative is allowed (warmup steps are equal exactly);
  ``global_norm``: the same fp32 sum over the same leaves, in another
  reduction order (measured within 2e-6 relative; allowed 1e-5).
* ``_decay_mask`` over every parameter name of Delphi-2M and Mamba2-780M:
  equal to JAX's on the nested path.
* One ``adamw_update`` from the same params, grads and state (step 3,
  clipping active): params measured within 3e-8, moments within 4e-9 (the
  clip scale comes from the two global norms); allowed 1e-7 and 1e-8.
* One ``make_train_step`` on reduced Delphi from the same params and the
  same ``pack_trajectories`` batch, fp32.  The port's forward differs from
  JAX's by one ulp of XLA's fp32 ``exp`` in the age-encoding table (ROADMAP
  C), which moves logits by up to ~8e-4 at ages near 85; it does not shrink
  with smaller histories, and ages are not shrunk to hide it (at 1/100 of
  the ages the gradients agree to 1.2e-5 of each leaf's largest).  Over
  four seeds: loss within 1.1e-6 relative (allowed 1e-5); every gradient
  within 3.4e-3 of its leaf's largest |g| (allowed 1e-2).  Adam's first
  step moves each parameter by about ``lr * sign(g)``, so an element whose
  gradient is smaller than that error may flip: the updated params agree
  within 6e-8 wherever JAX's |g| > 2e-4 (allowed 1e-6), and everywhere
  within 2 lr.  The ``lm`` objective (JAX's ``lm_loss``) on the same
  backbone: loss measured 2.1e-6 relative, gradients 2.7e-3 of the leaf
  maximum; the same allowances.
* The loss falls over 20 steps; checkpoints cross both ways (JAX ``save``
  -> port ``restore``/``load_config`` and port ``save`` -> JAX ``restore``
  and ``load_config``); the training CLI writes a directory that the
  port's server serves and JAX reads.
* The no-backward guard: every kernel entry point raises under grad, the
  training route calls no kernel and nothing of ``kernels.ref``, a
  just-trained parameter dict serves at once, Mamba2 training raises.
"""
import ast
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.delphi import loss_fn as jax_loss_fn
from repro.models import init_params as jax_init_params
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jopt
from repro.train.trainer import lm_loss as jax_lm_loss
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.api import GenerateRequest
from repro_torch.api.client import EngineBackend
from repro_torch.configs import get_config
from repro_torch.data import (SimulatorConfig, batches, generate_dataset,
                              pack_trajectories)
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, init_params, to_flat_numpy
from repro_torch.serve import server
from repro_torch.train import (OptimizerConfig, adamw_update, checkpoint,
                               cosine_lr, global_norm, init_opt_state,
                               loss_and_grads, make_loss_fn, make_train_step,
                               train_loop)
from repro_torch.train.optimizer import _decay_mask

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-2          # of each leaf's largest |g|
PARAM_ATOL = 1e-6        # where JAX's |g| > GRAD_SIGNIFICANT
GRAD_SIGNIFICANT = 2e-4
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


def _delphi_cfgs():
    cfg = get_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=1289)
    jcfg = jax_config("delphi-2m", reduced=True).replace(
        dtype="float32", vocab_size=1289)
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def _batch(seed):
    train, _ = generate_dataset(SimulatorConfig(n_train=8, n_val=1,
                                                seed=seed))
    return pack_trajectories(train, 48)


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_cosine_lr_vs_jax():
    for kw in (dict(lr=1e-3, warmup_steps=2, total_steps=10),
               dict(lr=1.0, min_lr_ratio=0.1, warmup_steps=10,
                    total_steps=110),
               dict(lr=5e-4, warmup_steps=0, total_steps=5,
                    min_lr_ratio=1.0)):
        for s in range(0, kw["total_steps"] + 4):
            got = cosine_lr(OptimizerConfig(**kw),
                            torch.tensor(s, dtype=torch.int32))
            want = jopt.cosine_lr(jopt.OptimizerConfig(**kw),
                                  jnp.asarray(s, jnp.int32))
            assert got.dtype == torch.float32
            if s < kw["warmup_steps"]:
                assert float(got) == float(want), (kw, s)
            np.testing.assert_allclose(float(got), float(want), rtol=3e-7,
                                       err_msg=str((kw, s)))


def test_global_norm_vs_jax():
    rng = np.random.default_rng(0)
    tree = {f"l{i}/w": rng.standard_normal((i + 1, 997)).astype(np.float32)
            for i in range(6)}
    got = float(global_norm({k: torch.from_numpy(v)
                             for k, v in tree.items()}))
    want = float(jopt.global_norm(jax_params(tree)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == 5.0


@pytest.mark.parametrize("arch", ["delphi-2m", "mamba2-780m"])
def test_decay_mask_vs_jax_over_every_name(arch):
    jcfg = jax_config(arch)
    shapes = jax.eval_shape(functools.partial(jax_init_params, jcfg),
                            jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    names = set()
    for path, _ in paths:
        key = "/".join(p.key for p in path)
        names.add(key)
        assert _decay_mask(key) == jopt._decay_mask(path), key
    # the port's parameters are exactly JAX's names
    assert names == set(init_params(get_config(arch, reduced=True),
                                    device="cpu"))


def test_adamw_update_vs_jax():
    cfg, _ = _delphi_cfgs()
    params = init_params(cfg, seed=0, device="cpu")
    flat = to_flat_numpy(params)
    kw = dict(lr=LR, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(1)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01
             for k, v in flat.items()}
    mu = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01
          for k, v in flat.items()}
    nu = {k: rng.random(v.shape).astype(np.float32) * 1e-4
          for k, v in flat.items()}
    got_p, got_s, got_m = adamw_update(
        _tensors(grads), {"mu": _tensors(mu), "nu": _tensors(nu),
                          "step": torch.tensor(3, dtype=torch.int32)},
        params, OptimizerConfig(**kw))
    want_p, want_s, want_m = jax.jit(jopt.adamw_update, static_argnums=3)(
        jax_params(grads), {"mu": jax_params(mu), "nu": jax_params(nu),
                            "step": jnp.asarray(3, jnp.int32)},
        jax_params(flat), jopt.OptimizerConfig(**kw))
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=3e-7)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-5)
    assert int(got_s["step"]) == int(want_s["step"]) == 4
    for name, got, want, atol in (
            ("params", got_p, jax_flat(want_p), 1e-7),
            ("mu", got_s["mu"], jax_flat(want_s["mu"]), 1e-8),
            ("nu", got_s["nu"], jax_flat(want_s["nu"]), 1e-8)):
        for k in got:
            assert not got[k].requires_grad
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=atol,
                                       rtol=0, err_msg=f"{name} {k}")


def test_grad_clip_and_decay_mask_semantics():
    w = {"w": torch.ones((4,))}
    _, _, m = adamw_update({"w": torch.full((4,), 100.0)},
                           init_opt_state(w), w,
                           OptimizerConfig(clip_norm=1.0))
    assert float(m["grad_norm"]) == 200.0          # reported pre-clip
    params = {"w_gate": torch.ones((2, 2)), "scale": torch.ones((2,))}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = adamw_update(zeros, init_opt_state(params), params,
                             OptimizerConfig(lr=0.1, weight_decay=1.0,
                                             warmup_steps=0, total_steps=1))
    assert float((new["scale"] - 1.0).abs().max()) < 1e-6     # no decay
    assert float((new["w_gate"] - 1.0).abs().max()) > 1e-3    # decayed


# ---------------------------------------------------------------------------
# one train step against JAX's
# ---------------------------------------------------------------------------
def _check_grads(got, want):
    assert set(got) == set(want)
    for k in got:
        g = got[k].numpy()
        scale = float(np.abs(want[k]).max())
        assert scale > 0 and float(np.abs(g).max()) > 0, k
        err = float(np.abs(g - want[k]).max())
        assert err <= GRAD_REL * scale, (k, err, scale)


@pytest.mark.parametrize("seed", [0, 2])
def test_train_step_vs_jax(seed):
    cfg, jcfg = _delphi_cfgs()
    params = init_params(cfg, seed=seed, device="cpu")
    jp = jax_params(to_flat_numpy(params))
    b = _batch(seed)
    grads, metrics = loss_and_grads(make_loss_fn(cfg, "delphi"), params,
                                    _tensors(b))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: (lambda m: (m["loss"], m))(jax_loss_fn(p, jcfg, jb)),
        has_aux=True))(jp)
    for k in ("loss", "event_ce", "time_nll"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)
    jgrads = jax_flat(jg)
    _check_grads(grads, jgrads)

    kw = dict(lr=LR, warmup_steps=0, total_steps=10)
    new, state, m = make_train_step(cfg, OptimizerConfig(**kw), "delphi")(
        params, init_opt_state(params), _tensors(b))
    jnew, _, jm2 = jax.jit(jax_make_train_step(
        jcfg, jopt.OptimizerConfig(**kw), "delphi"))(
        jp, jopt.init_opt_state(jp), jb)
    np.testing.assert_allclose(float(m["loss"]), float(jm2["loss"]),
                               rtol=LOSS_RTOL)
    assert int(state["step"]) == 1
    jnew = jax_flat(jnew)
    for k in new:
        assert not new[k].requires_grad
        d = np.abs(new[k].numpy() - jnew[k])
        sig = np.abs(jgrads[k]) > GRAD_SIGNIFICANT
        assert d[sig].max(initial=0.0) <= PARAM_ATOL, k
        assert d.max() <= 2 * LR * 1.01, k


def test_lm_loss_vs_jax():
    cfg, jcfg = _delphi_cfgs()
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    b = {"tokens": rng.integers(3, cfg.vocab_size, (2, 24)).astype(np.int32),
         "ages": np.sort(rng.uniform(30, 84, (2, 24)),
                         axis=1).astype(np.float32)}
    grads, m = loss_and_grads(make_loss_fn(cfg, "lm"), params, _tensors(b))
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: (lambda m: (m["loss"], m))(
            jax_lm_loss(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})),
        has_aux=True))(jax_params(to_flat_numpy(params)))
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)
    _check_grads(grads, jax_flat(jg))


def test_loss_falls_over_20_steps():
    cfg, _ = _delphi_cfgs()
    train, _ = generate_dataset(SimulatorConfig(n_train=64, n_val=1, seed=5))
    it = batches(pack_trajectories(train, 48), 16, seed=0)
    logged = []
    params, hist = train_loop(
        init_params(cfg, seed=0, device="cpu"), cfg,
        OptimizerConfig(lr=2e-3, warmup_steps=3, total_steps=20), it,
        objective="delphi", steps=20, log_every=1, log_fn=logged.append,
        device="cpu")
    assert set(hist) == {"step", "loss", "event_ce", "time_nll",
                         "val_loss", "val_step"}
    assert hist["step"] == list(range(20)) and len(logged) == 20
    assert np.isfinite(hist["loss"]).all()
    assert np.mean(hist["loss"][-3:]) < 0.85 * np.mean(hist["loss"][:3]), \
        hist["loss"][::4]
    assert not any(v.requires_grad for v in params.values())


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["delphi-2m", "mamba2-780m"])
def test_checkpoint_jax_save_port_restore(tmp_path, arch):
    jcfg = jax_config(arch, reduced=True)
    jp = jax.jit(functools.partial(jax_init_params, jcfg))(
        jax.random.PRNGKey(3))
    jax_ckpt.save(str(tmp_path), jp, jcfg, extra={"step": 7})
    cfg, extra = checkpoint.load_config(str(tmp_path))
    assert cfg == get_config(arch, reduced=True) and extra == {"step": 7}
    got = checkpoint.restore(str(tmp_path),
                             init_params(cfg, seed=0, device="cpu"))
    want = jax_flat(jp)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k])


@pytest.mark.parametrize("arch", ["delphi-2m", "mamba2-780m"])
def test_checkpoint_port_save_jax_restore(tmp_path, arch):
    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, seed=4, device="cpu")
    checkpoint.save(str(tmp_path), params, cfg, extra={"round": 2})
    jcfg, extra = jax_ckpt.load_config(str(tmp_path))
    assert jcfg == jax_config(arch, reduced=True) and extra == {"round": 2}
    template = jax_params({k: np.zeros_like(v)
                           for k, v in to_flat_numpy(params).items()})
    got = jax_flat(jax_ckpt.restore(str(tmp_path), template))
    for k, v in params.items():
        np.testing.assert_array_equal(got[k], v.numpy())
    back = checkpoint.restore(str(tmp_path), params)
    assert all(torch.equal(back[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), init_params(
            cfg.replace(d_model=128), seed=0, device="cpu"))


def test_cli_writes_a_checkpoint_the_server_serves(tmp_path, capsys):
    out = str(tmp_path / "run")
    res = launch_train.main([
        "--arch", "delphi-2m", "--reduced", "--steps", "4",
        "--patients", "24", "--batch", "8", "--seq-len", "32",
        "--device", "cpu", "--out", out])
    assert "saved to" in capsys.readouterr().out
    hist = json.load(open(tmp_path / "run" / "history.json"))
    assert hist["step"] == [0, 3] and len(hist["loss"]) == 2
    # the JAX package reads the directory
    jcfg, extra = jax_ckpt.load_config(out)
    assert jcfg.vocab_size == 1289 and jcfg.n_layers == 2
    assert extra["history"]["loss"] == hist["loss"]
    # the port's server serves it (shapes from meta.json: the reduced
    # width with the simulator's 1289 events, activations fp32)
    backend = server._build_backend(server.parse_args(
        ["--config", "delphi-2m", "--reduced", "--ckpt", out,
         "--device", "cpu", "--cache", "paged", "--slots", "2",
         "--max-context", "64"]))
    assert isinstance(backend, EngineBackend)
    assert backend.cfg.vocab_size == 1289 and backend.cfg.dtype == "float32"
    for k, v in res["params"].items():
        assert torch.equal(backend.params[k], v)
    r = backend.generate(GenerateRequest(tokens=[3, 40, 300],
                                         ages=[0.0, 30.0, 41.0], max_new=4))
    assert 1 <= len(r.tokens) <= 4 and len(r.ages) == len(r.tokens)
    with pytest.raises(SystemExit, match="holds delphi-2m"):
        server._build_backend(server.parse_args(
            ["--config", "mamba2-780m", "--ckpt", out, "--device", "cpu"]))


# ---------------------------------------------------------------------------
# the guard: no kernel entry point may silently cut a gradient
# ---------------------------------------------------------------------------
def _kernel_calls():
    rng = np.random.default_rng(0)

    def t(*shape, grad=True):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            requires_grad=grad)
    table = torch.zeros((2, 1), dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32)[None].expand(2, 8)
    return {
        "flash_attention": lambda: ops.flash_attention(
            t(1, 2, 4, 8), t(1, 2, 4, 8), t(1, 2, 4, 8)),
        "suffix_prefill_attention": lambda: ops.suffix_prefill_attention(
            t(1, 2, 2, 8), t(1, 2, 2, 8), t(1, 2, 2, 8), t(1, 3, 2, 8),
            t(1, 3, 2, 8), torch.tensor([[3, 4]]), torch.tensor([[0, 1, 2]])),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            t(2, 2, 8), t(2, 2, 8, 8, grad=False), t(2, 2, 8, 8), table,
            pos.contiguous(), torch.tensor([7, 7])),
        "tte_sample": lambda: ops.tte_sample(
            t(2, 16), torch.rand(2, 16)),
        "ssd_intra": lambda: ops.ssd_intra(
            t(2, 1, 4, 3), t(2, 1, 4, 5), t(2, 1, 4, 5),
            -torch.rand(2, 1, 4).cumsum(-1)),
        "ssd_intra_heads": lambda: ops.ssd_intra_heads(
            t(1, 1, 4, 2, 3), t(1, 1, 4, 2, 5), t(1, 1, 4, 2, 5),
            -torch.rand(1, 1, 4, 2).cumsum(2)),
    }


@pytest.mark.parametrize("name", list(_kernel_calls()))
def test_kernel_entry_points_refuse_grad(name):
    call = _kernel_calls()[name]
    with pytest.raises(RuntimeError, match="has no backward"):
        call()
    with torch.no_grad():
        call()                              # inference is unaffected
    with torch.inference_mode():
        call()


def test_training_route_reaches_no_kernel_and_nothing_of_ref(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the training route reached a kernel")
    for name in ("flash_attention", "suffix_prefill_attention",
                 "paged_decode_attention", "tte_sample", "ssd_intra",
                 "ssd_intra_heads"):
        monkeypatch.setattr(ops, name, refuse)
    for name in dir(ref):
        if name.endswith("_ref"):
            monkeypatch.setattr(ref, name, refuse)
    cfg, _ = _delphi_cfgs()
    params = init_params(cfg, seed=0, device="cpu")
    grads, _ = loss_and_grads(make_loss_fn(cfg, "delphi"), params,
                              _tensors(_batch(0)))
    assert all(float(g.abs().max()) > 0 for g in grads.values())
    # Mamba2 and the hybrid train through the plain SSD route
    gen = torch.Generator().manual_seed(1)
    toks = {"tokens": torch.randint(0, 512, (2, 40), generator=gen)}
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        lm = get_config(arch, reduced=True).replace(dtype="float32")
        grads, _ = loss_and_grads(make_loss_fn(lm, "lm"),
                                  init_params(lm, seed=0, device="cpu"), toks)
        assert all(float(g.abs().max()) > 0 for g in grads.values()), arch
    # and no module of the training route imports the kernels
    for rel in ("core/losses.py", "core/delphi.py", "train/optimizer.py",
                "train/trainer.py", "train/checkpoint.py",
                "federated/fedavg.py", "launch/train.py"):
        tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert not (node.module or "").startswith(
                    "repro_torch.kernels"), rel


def test_a_just_trained_dict_serves_at_once():
    cfg, _ = _delphi_cfgs()
    train, _ = generate_dataset(SimulatorConfig(n_train=16, n_val=1, seed=1))
    params, _ = train_loop(
        init_params(cfg, seed=0, device="cpu"), cfg,
        OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=2),
        batches(pack_trajectories(train, 32), 8, seed=0), steps=2,
        log_fn=lambda s: None, device="cpu")
    assert torch.is_grad_enabled()
    be = EngineBackend.create(params, cfg, slots=2, max_context=64,
                              device="cpu")
    r = be.generate(GenerateRequest(tokens=[3, 40], ages=[0.0, 30.0],
                                    max_new=3))
    assert len(r.tokens) >= 1
    # parameters that still required grad would be refused by the kernels
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    be2 = EngineBackend.create(leaves, cfg, slots=2, max_context=64,
                               device="cpu")
    with pytest.raises(RuntimeError, match="has no backward"):
        be2.generate(GenerateRequest(tokens=[3, 40], ages=[0.0, 30.0],
                                     max_new=3))


def test_mamba2_training_raises():
    """Mamba2's training route once raised here; it is ported (the plain
    SSD route, ``tests/test_torch_ssm_train.py``), so this now holds it
    running: the differentiable logits equal the kernel route's (its plain
    version on the CPU) within 1e-5, nothing raises, and the training CLI
    takes a step with a finite loss."""
    cfg = get_config("mamba2-780m", reduced=True).replace(dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 40),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = forward(params, cfg, {"tokens": toks})["logits"]
        got = forward(params, cfg, {"tokens": toks},
                      differentiable=True)["logits"]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    out = launch_train.main(["--arch", "mamba2-780m", "--reduced", "--steps",
                             "1", "--batch", "1", "--seq-len", "8",
                             "--device", "cpu"])
    assert np.isfinite(out["history"]["loss"]).all()


def test_training_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _delphi_cfgs()
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(params, cfg, OptimizerConfig(), iter([]), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "delphi-2m", "--steps", "1"])
