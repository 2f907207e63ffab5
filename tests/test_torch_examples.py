"""The port's eight examples (``examples/torch_*.py``) on the CPU.

Every twin's ``main`` runs in process with the fast arguments of
``scripts/torch_examples_smoke.py`` plus ``--device cpu`` and returns 0
(the export twin's in ``tests/test_torch_examples_jax.py``, with its
training cut to 2 steps: the smoke runner's table cannot cut it).  The
twins' pieces are held against the JAX examples' own (``examples/*.py``,
imported by path, and ``repro``):

* the quickstart, serve-batched and cohort twins build the same packed
  arrays and prompts as their JAX twins from the same simulator seeds,
  exactly;
* the ablation twin's evaluation at step 0, on JAX's
  ``init_delphi(cfg, PRNGKey(0))`` carried across by ``from_jax_flat``,
  equals the JAX example's ``evaluate`` (event CE and time NLL within
  1e-5 relative, the implied rate within 1e-4 relative).

The generation steps of the quickstart and serve-batched twins are held
against ``repro`` in ``tests/test_torch_examples_jax.py``.
"""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import init_delphi as jax_init_delphi
from repro.data import SimulatorConfig as JaxSimulatorConfig
from repro.data import batches as jax_batches
from repro.data import generate_dataset as jax_generate_dataset
from repro.data import pack_trajectories as jax_pack
from repro.data.synthetic import patient as jax_patient
from repro_torch.data import batches
from repro_torch.models import from_jax_flat

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(rel: str):
    """A module from a file of the repo (the examples are not a package)."""
    path = ROOT / rel
    name = "_ex_" + path.stem
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(jax_flat(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


SMOKE = load("scripts/torch_examples_smoke.py")
TWINS = sorted(SMOKE.EXAMPLES)


def test_every_example_has_a_twin_in_the_smoke_table():
    jax_examples = {p.name for p in (ROOT / "examples").glob("*.py")
                    if not p.name.startswith("torch_")}
    twins = {p.name for p in (ROOT / "examples").glob("torch_*.py")}
    assert twins == {"torch_" + n for n in jax_examples} == set(TWINS)
    assert set(SMOKE.KERNELS) == twins


def run_main(name, capsys, monkeypatch=None) -> None:
    """A twin's ``main`` with the smoke runner's fast arguments on the CPU
    returns 0 and reports no kernel launch (CPU tensors take the plain
    versions)."""
    mod = load(f"examples/{name}")
    if name == "torch_export_and_serve.py":
        monkeypatch.setattr(mod, "STEPS", 2)
    assert mod.main(SMOKE.EXAMPLES[name] + ["--device", "cpu"]) == 0
    counts = SMOKE.launch_counts(capsys.readouterr().out)
    assert counts == {"tte_sample": 0, "flash_attention": 0,
                      "paged_decode_attention": 0, "ssd_intra": 0}


# the export twin's main runs in tests/test_torch_examples_jax.py (time)
@pytest.mark.parametrize("name", [n for n in TWINS
                                  if n != "torch_export_and_serve.py"])
def test_twin_main_returns_0_on_the_cpu(name, capsys):
    run_main(name, capsys)


def _assert_packed_equal(mine, theirs):
    assert set(mine) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]),
                                      err_msg=k)
        assert mine[k].dtype == np.asarray(theirs[k]).dtype, k


def test_quickstart_data_equals_the_jax_twins():
    tq = load("examples/torch_quickstart.py")
    train, val, pt, pv = tq.make_data(64, 96)
    jtrain, jval = jax_generate_dataset(JaxSimulatorConfig(n_train=64,
                                                           n_val=32))
    _assert_packed_equal(pt, jax_pack(jtrain, 96))
    _assert_packed_equal(pv, jax_pack(jval, 96))
    assert len(train) == len(jtrain) and len(val) == len(jval)


def test_serve_batched_data_and_prompts_equal_the_jax_twins():
    ts = load("examples/torch_serve_batched.py")
    jtrain, _ = jax_generate_dataset(JaxSimulatorConfig(n_train=512,
                                                        n_val=8))
    _assert_packed_equal(ts.make_data(), jax_pack(jtrain, 96))
    jreqs, _ = jax_generate_dataset(JaxSimulatorConfig(n_train=4, n_val=1,
                                                       seed=99))
    mine = ts.make_requests(4)
    assert len(mine) == len(jreqs)
    for (t, a), (jt, ja) in zip(mine, jreqs):
        h = max(len(jt) // 2, 2)
        np.testing.assert_array_equal(t, jt[:h])
        np.testing.assert_array_equal(a, ja[:h])


def test_cohort_sweep_data_and_patients_equal_the_jax_twins():
    tc = load("examples/torch_cohort_sweep.py")
    jtrain, _ = jax_generate_dataset(JaxSimulatorConfig(n_train=512,
                                                        n_val=8))
    _assert_packed_equal(tc.make_data(), jax_pack(jtrain, 96))
    for i, (t, a) in enumerate(tc.make_patients(6)):
        jt, ja = jax_patient(i, JaxSimulatorConfig(seed=7))
        k = min(12, max(len(jt) - 1, 2))
        np.testing.assert_array_equal(t, jt[:k])
        np.testing.assert_array_equal(a, ja[:k])


def test_ablation_evaluation_at_step_0_equals_the_jax_examples():
    ta = load("examples/torch_ablation_dual_loss.py")
    ja = load("examples/ablation_dual_loss.py")
    cfg = ta.make_config()
    jcfg = jax_config("delphi-2m").replace(dtype="float32", max_seq_len=96)
    _, pv = ta.make_data(64)
    _, jval = jax_generate_dataset(JaxSimulatorConfig(n_train=64,
                                                      n_val=128))
    _assert_packed_equal(pv, jax_pack(jval, 96))
    jp = jax_init_delphi(jcfg, jax.random.PRNGKey(0))
    params = from_jax_flat(jax_flat(jp), cfg, device="cpu")
    ce, tn, lam = ta.evaluate(cfg, params, batches(pv, 32, seed=1),
                              n_batches=2)
    jce, jtn, jlam = ja.evaluate(jcfg, jp, jax_batches(jax_pack(jval, 96),
                                                       32, seed=1),
                                 n_batches=2)
    np.testing.assert_allclose([ce, tn], [jce, jtn], rtol=1e-5)
    np.testing.assert_allclose(lam, jlam, rtol=1e-4)


def test_zoo_twin_hands_the_kernels_the_layouts_their_launchers_take(
        monkeypatch):
    """Every reduced architecture of the zoo twin through the kernel route
    (``ops._on_cuda`` forced), each CUDA launcher replaced by a check of
    the inputs it refuses on the card (contiguity, unit strides) before
    the plain version: a ``decode_step`` given one int step must hand the
    paged kernel a contiguous (B,) step, as the card requires."""
    from repro_torch.configs import ASSIGNED_ARCHS
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ssd_scan as sk
    seen = {"flash": 0, "paged": 0, "ssd": 0}

    def flash(q, k, v, **kw):
        assert q.stride(3) == k.stride(3) == v.stride(3) == 1
        seen["flash"] += 1
        return ref.flash_attention_ref(q, k, v, **kw)

    def paged(q, k_pool, v_pool, table, pos, step, *, window=None):
        for name, t in dict(q=q, k_pool=k_pool, v_pool=v_pool, table=table,
                            pos=pos, step=step).items():
            assert t.is_contiguous(), f"{name} {t.shape} {t.stride()}"
        seen["paged"] += 1
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, table, pos,
                                              step, window=window)

    def ssd(xdt, Bm, Cm, cum):
        assert xdt.stride(4) == Bm.stride(4) == Cm.stride(4) == 1
        seen["ssd"] += 1
        return ref.ssd_intra_heads_ref(xdt, Bm, Cm, cum)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(fk, "flash_attention_cuda", flash)
    monkeypatch.setattr(pk, "paged_decode_attention_cuda", paged)
    monkeypatch.setattr(sk, "ssd_intra_cuda", ssd)
    zoo = load("examples/torch_arch_zoo.py")
    rows = [zoo.run_one(a, "cpu") for a in ASSIGNED_ARCHS]
    assert all(r["finite"] for r in rows)
    assert min(seen.values()) > 0, seen
