"""The grouped MoE dispatches on a mesh: the port's ``apply_moe(impl=
"ragged" | "ragged_local")`` on DTensors over a 2 x 2 (data x model) gloo
group of 4 CPU processes, against the JAX package's on a 2 x 2 JAX mesh of
4 host devices (a subprocess), in fp32, on the same inputs drawn from a
numpy seed.

* One MoE layer of reduced OLMoE-1B-7B (d 256, f 128, top-k 2) at 4 x 16
  tokens: E 4 (the experts split over ``model``: 2 a rank) and E 3 (3 does
  not divide 2, so each expert's hidden width splits: 64 a rank).  The
  output, the aux loss and the gradients of ``sum(y * ct) + aux`` with
  respect to x and every weight.
* ``ragged_local``'s aux loss is the mean over the 2 data shards of each
  shard's own aux (the reference's ``shard_map`` with ``out_specs=P(da)``,
  then the mean): the port's equals JAX's and differs from the aux over
  all tokens, which ``ragged`` returns on both sides.
* One train step's loss and gradients of reduced OLMoE (2 layers, E 4) on
  the 2 x 2 mesh through ``lm_loss(moe_impl=...)``.

Tolerances, measured on the CPU and written here with ~5-15x room for
another CPU's summation order: outputs within ``Y_ATOL`` 1e-5 (measured
1.1e-6; largest |y| 2.7), the aux within rtol ``AUX_RTOL`` 1e-6 (measured
1.2e-7), each gradient within ``GRAD_REL`` 1e-5 of its leaf's largest |g|
(measured 6.6e-7); ``lm_loss``'s loss within rtol ``LOSS_RTOL`` 1e-6
(measured 6.9e-8) and its gradients within ``LM_GRAD_REL`` 1e-5 of each
leaf's largest |g| (measured 1.5e-6).  ~35 s: the JAX process runs while
the gloo group does.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import init_params, moe
from repro_torch.models.model import Block
from repro_torch.train.trainer import loss_and_grads, make_loss_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = Mesh(("data", "model"), (2, 2))
WORLD = 4
IMPLS = ("ragged", "ragged_local")
EXPERTS = (4, 3)
B, S = 4, 16                 # the layer's tokens
LM_B, LM_S = 4, 32           # the train step's batch
WEIGHTS = ("router", "w_gate", "w_up", "w_down")
SPAWN_TIMEOUT = 300
Y_ATOL = 1e-5
AUX_RTOL = 1e-6
GRAD_REL = 1e-5
LOSS_RTOL = 1e-6
LM_GRAD_REL = 1e-5


def _cfg(n_experts=4):
    return get_config("olmoe-1b-7b", reduced=True).replace(
        dtype="float32", n_experts=n_experts)


def _inputs(path):
    """Every input, drawn from numpy seeds and written to ``path`` (.npz)
    for the JAX process: per E the layer's weights; x and the cotangent
    ct (B, S, d); reduced OLMoE's parameters (the port's seeded
    ``init_params``) and a token batch."""
    rng = np.random.default_rng(2024)
    cfg = _cfg()
    d, f = cfg.d_model, cfg.moe_d_ff
    arrs = {}
    for E in EXPERTS:
        arrs[f"E{E}/router"] = rng.standard_normal((d, E)) * d ** -0.5
        arrs[f"E{E}/w_gate"] = rng.standard_normal((E, d, f)) * d ** -0.5
        arrs[f"E{E}/w_up"] = rng.standard_normal((E, d, f)) * d ** -0.5
        arrs[f"E{E}/w_down"] = rng.standard_normal((E, f, d)) * f ** -0.5
    arrs["x"] = rng.standard_normal((B, S, d))
    arrs["ct"] = rng.standard_normal((B, S, d))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    for k, v in init_params(cfg, seed=5, device="cpu").items():
        arrs["lm/" + k] = v.numpy()
    arrs["tokens"] = rng.integers(3, cfg.vocab_size,
                                  (LM_B, LM_S)).astype(np.int32)
    np.savez(path, **arrs)
    return {k: torch.from_numpy(v) for k, v in arrs.items()}


_JAX_CODE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.sharding import batch_shardings, param_shardings
from repro.models.moe import apply_moe
from repro.train.trainer import lm_loss

d = dict(np.load(sys.argv[1]))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}


def nest(flat):
    tree = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def flat(tree, prefix=""):
    res = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            res.update(flat(v, prefix + k + "/"))
        else:
            res[prefix + k] = np.asarray(v)
    return res


for E in (4, 3):
    cfg = get_config("olmoe-1b-7b", reduced=True).replace(
        dtype="float32", n_experts=E)
    p = {"moe": {k: jnp.asarray(d[f"E{E}/{k}"])
                 for k in ("router", "w_gate", "w_up", "w_down")}}
    ps = param_shardings(mesh, p)
    xs = NamedSharding(mesh, P("data", None, None))
    for impl in ("ragged", "ragged_local"):
        def f(p, x):
            y, aux = apply_moe(p["moe"], x, cfg, impl=impl)
            return jnp.sum(y * d["ct"]) + aux, (y, aux)
        with mesh:
            (gp, gx), (y, aux) = jax.jit(
                jax.grad(f, argnums=(0, 1), has_aux=True),
                in_shardings=(ps, xs))(p, jnp.asarray(d["x"]))
        tag = f"E{E}/{impl}/"
        out[tag + "y"], out[tag + "aux"] = np.asarray(y), np.asarray(aux)
        out[tag + "grad/x"] = np.asarray(gx)
        for k, v in flat(gp).items():
            out[tag + "grad/" + k.split("/")[-1]] = v

cfg = get_config("olmoe-1b-7b", reduced=True).replace(dtype="float32")
params = nest({k[3:]: v for k, v in d.items() if k.startswith("lm/")})
batch = {"tokens": jnp.asarray(d["tokens"])}
ps, bs = param_shardings(mesh, params), batch_shardings(mesh, batch)
for impl in ("ragged", "ragged_local"):
    def loss(p, b):
        m = lm_loss(p, cfg, b, moe_impl=impl)
        return m["loss"], m
    with mesh:
        g, m = jax.jit(jax.grad(loss, has_aux=True),
                       in_shardings=(ps, bs))(params, batch)
    out[f"lm/{impl}/loss"] = np.asarray(m["loss"])
    out[f"lm/{impl}/aux"] = np.asarray(m["aux_loss"])
    for k, v in flat(g).items():
        out[f"lm/{impl}/grad/{k}"] = v
np.savez(sys.argv[2], **out)
"""


def _jax_run(inputs_path, out_path):
    """The reference's results on a 2 x 2 mesh of 4 host devices (the
    device count is fixed when JAX starts: a process of its own)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen(
        [sys.executable, "-c", _JAX_CODE, inputs_path, out_path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)


def _layer_loss(w, x, ct, cfg, impl):
    """``apply_moe``'s (y, aux) and the gradients of sum(y * ct) + aux
    with respect to x and the weights (DTensors or plain tensors)."""
    from repro_torch import sharded
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    xl = x.detach().requires_grad_(True)
    with sharded.plain_as_replicated(xl):
        y, aux = moe.apply_moe(Block(leaves, prefix=""), xl, cfg,
                               impl=impl)
        y = sharded.reduce_rows(y)
        loss = sharded.replicated((y * ct).sum() + aux)
    loss.backward()
    return y, aux, xl.grad, {k: v.grad for k, v in leaves.items()}


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def _worker(rank, store_path, inputs_path, out_path):
    """One rank of the gloo group: every case on DTensors laid out by
    ``launch.sharding``'s specs; rank 0 saves the gathered results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        dm = init_device_mesh("cpu", MESH.sizes,
                              mesh_dim_names=MESH.axis_names)
        d = {k: torch.from_numpy(v) for k, v in np.load(inputs_path).items()}
        io = {"x": d["x"], "ct": d["ct"]}
        dio = sh.distribute_tree(io, sh.batch_shardings(MESH, io), dm)
        out = {}
        for E in EXPERTS:
            w = {"moe/" + k: d[f"E{E}/{k}"] for k in WEIGHTS}
            dw = sh.distribute_tree(w, sh.param_shardings(MESH, w), dm)
            for impl in IMPLS:
                y, aux, gx, gw = _layer_loss(dw, dio["x"], dio["ct"],
                                             _cfg(E), impl)
                tag = f"E{E}/{impl}/"
                out[tag + "y"], out[tag + "aux"] = _full(y), _full(aux)
                out[tag + "grad/x"] = _full(gx)
                out[tag + "placement"] = str(dw["moe/w_gate"].placements)
                for k, g in gw.items():
                    out[tag + "grad/" + k.split("/")[-1]] = _full(g)
        cfg = _cfg()
        params = {k[3:]: v for k, v in d.items() if k.startswith("lm/")}
        batch = {"tokens": d["tokens"]}
        dp = sh.distribute_tree(params, sh.param_shardings(MESH, params), dm)
        db = sh.distribute_tree(batch, sh.batch_shardings(MESH, batch), dm)
        for impl in IMPLS:
            g, m = loss_and_grads(make_loss_fn(cfg, "lm", moe_impl=impl), dp,
                                  db)
            out[f"lm/{impl}/loss"] = _full(m["loss"])
            out[f"lm/{impl}/aux"] = _full(m["aux_loss"])
            for k, v in g.items():
                out[f"lm/{impl}/grad/{k}"] = _full(v)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the port's gloo results, JAX's results): the JAX process
    runs while the gloo group does."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("sharded_moe")
    inputs_path, jax_out = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    inputs = _inputs(inputs_path)
    jax_proc = _jax_run(inputs_path, jax_out)
    try:
        port_out = str(tmp / "port.pt")
        ctx = mp.spawn(_worker, args=(str(tmp / "store"), inputs_path,
                                      port_out),
                       nprocs=WORLD, join=False)
        deadline = time.monotonic() + SPAWN_TIMEOUT
        while not ctx.join(timeout=5):      # raises if a rank failed
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                pytest.fail(f"the gloo run did not end in {SPAWN_TIMEOUT} s")
        _, err = jax_proc.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    port = torch.load(port_out, weights_only=False)
    ref = {k: torch.from_numpy(np.asarray(v))
           for k, v in np.load(jax_out).items()}
    return inputs, port, ref


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n_experts", EXPERTS)
def test_apply_moe_on_2x2_matches_the_reference(runs, n_experts, impl):
    """The output, the aux loss and every gradient, the port's DTensors
    against JAX's 2 x 2 mesh; E 4 splits the experts over ``model``, E 3
    each expert's hidden width."""
    _, port, ref = runs
    tag = f"E{n_experts}/{impl}/"
    want = "Shard(dim=0)" if n_experts == 4 else "Shard(dim=2)"
    assert port[tag + "placement"] == f"(Replicate(), {want})"
    y, y_ref = port[tag + "y"], ref[tag + "y"]
    assert y.shape == y_ref.shape == (B, S, _cfg().d_model)
    assert float((y - y_ref).abs().max()) <= Y_ATOL, tag
    assert torch.allclose(port[tag + "aux"], ref[tag + "aux"], rtol=AUX_RTOL,
                          atol=0), tag
    for leaf in ("x",) + WEIGHTS:
        g, g_ref = port[tag + "grad/" + leaf], ref[tag + "grad/" + leaf]
        assert g.shape == g_ref.shape, (tag, leaf)
        assert _rel(g, g_ref) <= GRAD_REL, (tag, leaf, _rel(g, g_ref))


@pytest.mark.parametrize("n_experts", EXPERTS)
def test_ragged_local_aux_is_the_mean_of_the_data_shards(runs, n_experts):
    """``ragged``'s aux is the aux over all B x S tokens (the plain route's
    on the whole batch); ``ragged_local``'s is the mean of the plain
    route's aux on each data shard's rows (batch rows 0-1 and 2-3), as
    the reference's, and differs from the global one."""
    inputs, port, ref = runs
    cfg = _cfg(n_experts)
    w = {"moe/" + k: inputs[f"E{n_experts}/{k}"] for k in WEIGHTS}
    x = inputs["x"]
    with torch.no_grad():
        whole = moe.apply_moe(Block(w, prefix=""), x, cfg,
                              impl="ragged")[1]
        shards = [moe.apply_moe(Block(w, prefix=""), x[i:i + 2], cfg,
                                impl="ragged")[1] for i in (0, 2)]
    tag = f"E{n_experts}/"
    assert torch.allclose(port[tag + "ragged/aux"], whole, rtol=AUX_RTOL,
                          atol=0)
    local = port[tag + "ragged_local/aux"]
    assert torch.allclose(local, (shards[0] + shards[1]) / 2, rtol=AUX_RTOL,
                          atol=0)
    assert abs(float(local) - float(whole)) > 100 * AUX_RTOL * float(whole)
    assert abs(float(ref[tag + "ragged_local/aux"])
               - float(ref[tag + "ragged/aux"])) \
        > 100 * AUX_RTOL * float(whole)


@pytest.mark.parametrize("impl", IMPLS)
def test_lm_loss_on_2x2_matches_the_reference(runs, impl):
    """One reduced-OLMoE train step's loss, aux and every gradient through
    ``lm_loss(moe_impl=...)`` on the 2 x 2 mesh, the port against JAX."""
    _, port, ref = runs
    tag = f"lm/{impl}/"
    assert torch.allclose(port[tag + "loss"], ref[tag + "loss"],
                          rtol=LOSS_RTOL, atol=0), impl
    assert torch.allclose(port[tag + "aux"], ref[tag + "aux"],
                          rtol=AUX_RTOL, atol=0), impl
    keys = sorted(k for k in ref if k.startswith(tag + "grad/"))
    assert keys == sorted(k for k in port if k.startswith(tag + "grad/"))
    for k in keys:
        assert port[k].shape == ref[k].shape, k
        assert _rel(port[k], ref[k]) <= LM_GRAD_REL, (k, _rel(port[k],
                                                              ref[k]))
