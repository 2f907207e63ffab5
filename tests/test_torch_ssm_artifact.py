"""The SDK artifact of the recurrent families on the CPU: reduced Mamba2
(``mamba2-780m``) and reduced Zamba2 (``zamba2-1.2b``: the shared block
before each of its 2 layers) in fp32, exported at ``seq_len`` 32 and 64.

The artifact right-pads a prompt to ``seq_len``, so its prefill graph masks
the padding: ``dt = 0`` past ``last_index`` and the conv tail gathered
there (``models.ssm.ssm_forward``'s masked prefill), the hybrid's rings by
``mask_padded_positions``.  Held here, on prompts under one chunk (the
reduced chunk is 32), across a chunk boundary and exactly ``seq_len``
long:

* the masked prefill's state and last logits against the port's
  exact-length prefill, within ``MASK_ATOL``; at ``last_index = S - 1``
  (what the engine passes: it prefills at the exact length) against the
  unmasked route bit for bit;
* the masked prefill and the decode steps after it against the JAX
  package's eager ``forward(mode="prefill")`` on the exact prompt and its
  ``decode_step``, within ``LOGITS_ATOL`` (``tests/test_torch_hybrid.py``'s);
* the JAX package's own padded prefill (its ``build_inference_fns``, whose
  ``mask_padded_positions`` passes a recurrent state through) farther than
  ``LOGITS_ATOL`` from its exact one: the reference's artifact decodes from
  the state after the padding.  A finding about the reference, recorded;
* export (spec v1 and v2): the graphs equal the eager functions bit for
  bit, the manifest's inputs and cache leaves equal the reference's
  (``resolve``: ``[h, conv]``, and ``[k, v, pos, h, conv]`` for the
  hybrid), the decode graph updates its leaves in place, and
  ``ArtifactBackend`` equals ``LocalBackend.stream`` bit for bit under
  injected uniforms.

Tolerances, measured on these inputs (CPU, fp32): the masked prefill
against the exact-length one within 2.3e-6 (logits and conv tail) and
1.6e-7 (state): the padded graph's products have other row counts, so
their sums round apart by an ulp here and there (bit-equal at 9 of the 20
measured prompts, the Mamba2 state at 4 of them); allowed 1e-5.  Against
JAX within ``LOGITS_ATOL`` = 1e-4, as the Mamba2 and Zamba2 model tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.sdk.export import build_inference_fns as jax_build_inference_fns
from repro_torch.api import ArtifactBackend, Client, GenerateRequest
from repro_torch.api.client import LocalBackend
from repro_torch.configs import get_config
from repro_torch.models import forward, init_params, to_flat_numpy
from repro_torch.sdk import (Runtime, build_inference_fns, export_model,
                             read_manifest, verify_checksums)

torch.set_num_threads(2)

ARCHS = ("mamba2-780m", "zamba2-1.2b")
LOGITS_ATOL = 1e-4
MASK_ATOL = 1e-5
# (seq_len, prompt length): under one chunk, across a chunk boundary,
# exactly seq_len
CASES = [(32, 5), (32, 32), (64, 5), (64, 40), (64, 64)]
DECODE_STEPS = 4


def jax_params(flat):
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return out


_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        cfg = get_config(arch, reduced=True).replace(dtype="float32")
        jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
        params = init_params(cfg, seed=4, device="cpu")
        _SETUPS[arch] = (cfg, jcfg, params,
                         jax_params(to_flat_numpy(params)))
    return _SETUPS[arch]


def _prompt(cfg, L, S, seed):
    """(the exact prompt (1, L), the padded one (1, S), last_index (1,))."""
    rng = np.random.default_rng(seed)
    t = np.zeros((1, S), np.int32)
    t[0, :L] = rng.integers(3, cfg.vocab_size, L)
    return t[:, :L], t, np.asarray([L - 1], np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the masked prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,L", CASES)
def test_masked_prefill_equals_exact_length(arch, S, L):
    """The padded prompt's prefill with ``last_index`` against the exact
    prompt's: the state (every Mamba layer's h and conv tail) and the last
    logits; the hybrid's rings hold the prompt's positions and nothing
    past them."""
    cfg, _, params, _ = _setup(arch)
    exact, padded, li = _prompt(cfg, L, S, seed=L)
    with torch.no_grad():
        lg, leaves = build_inference_fns(cfg, S)["prefill"](
            params, _t(padded), _t(li))
        ex = forward(params, cfg, {"tokens": _t(exact)}, mode="prefill",
                     cache_width=S)
    ssm = ex["cache"]["ssm"]
    np.testing.assert_allclose(lg.numpy(), ex["logits"][:, 0].numpy(),
                               atol=MASK_ATOL, rtol=0)
    np.testing.assert_allclose(leaves[-2].numpy(), ssm.h.numpy(),
                               atol=MASK_ATOL, rtol=0)
    np.testing.assert_allclose(leaves[-1].numpy(), ssm.conv.numpy(),
                               atol=MASK_ATOL, rtol=0)
    if arch == "zamba2-1.2b":
        pos = leaves[2]
        assert (pos[:, 0, :L] == torch.arange(L, dtype=torch.int32)).all()
        assert (pos[:, 0, L:] == -1).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("L", [3, 40])
def test_last_index_at_the_end_changes_no_bit(arch, L):
    """The engine prefills a recurrent prompt at its exact length and
    passes no ``last_index`` (the sliced conv tail, no mask); the masked
    route at ``last_index = S - 1`` gives its bits (a conv tail shorter
    than ``ssm_conv`` included)."""
    cfg, _, params, _ = _setup(arch)
    exact = _prompt(cfg, L, L, seed=L)[0]
    batch = {"tokens": _t(exact)}
    with torch.no_grad():
        a = forward(params, cfg, batch, mode="prefill")
        b = forward(params, cfg, batch, mode="prefill",
                    last_index=torch.tensor([L - 1]))
    assert torch.equal(a["logits"], b["logits"])
    assert torch.equal(a["cache"]["ssm"].h, b["cache"]["ssm"].h)
    assert torch.equal(a["cache"]["ssm"].conv, b["cache"]["ssm"].conv)


def _jax_exact(arch, exact, S, tokens):
    """JAX's eager exact-length prefill, then a decode step per token of
    ``tokens``: the logits (V,) of each."""
    _, jcfg, _, jp = _setup(arch)
    L = exact.shape[1]
    out = jax_forward(jp, jcfg, {"tokens": jnp.asarray(exact)},
                      mode="prefill", cache_width=S)
    rows, cache = [_np(out["logits"])[0, 0]], out["cache"]
    for i, tok in enumerate(tokens):
        d = jax_decode_step(jp, jcfg, cache,
                            {"tokens": jnp.asarray([[tok]], jnp.int32)},
                            jnp.int32(L + i))
        rows.append(_np(d["logits"])[0, 0])
        cache = d["cache"]
    return rows


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,L", [(32, 5), (64, 40)])
def test_masked_prefill_and_decode_match_jax_exact(arch, S, L):
    """The padded prompt's prefill and ``DECODE_STEPS`` decode steps (the
    artifact's functions, eagerly) against JAX's eager prefill of the
    exact prompt and its decode steps."""
    cfg, _, params, _ = _setup(arch)
    exact, padded, li = _prompt(cfg, L, S, seed=L + 1)
    fns = build_inference_fns(cfg, S)
    toks = list(range(7, 7 + DECODE_STEPS))
    with torch.no_grad():
        lg, cache = fns["prefill"](params, _t(padded), _t(li))
        got = [lg.numpy()[0]]
        for i, tok in enumerate(toks):
            lg, cache = fns["decode"](params, cache, _t([[tok]]),
                                      _t(np.asarray([L + i], np.int32)))
            got.append(lg.numpy()[0])
    for g, w in zip(got, _jax_exact(arch, exact, S, toks)):
        np.testing.assert_allclose(g, w, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_padded_prefill_decodes_from_the_padding(arch):
    """The finding about the reference: the JAX package's own artifact
    prefill (``build_inference_fns(...)["prefill"]``, jitted) on a padded
    prompt leaves its recurrent state after the padding, farther than
    ``LOGITS_ATOL`` from its exact-length prefill at the first decode step,
    where the port's masked prefill agrees within it."""
    cfg, jcfg, params, jp = _setup(arch)
    S, L = 64, 5
    exact, padded, li = _prompt(cfg, L, S, seed=9)
    jfns = jax_build_inference_fns(jcfg, S)
    _, jleaves = jax.jit(jfns["prefill"])(jp, jnp.asarray(padded),
                                          jnp.asarray(li))
    jfns["resolve"](jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jp))
    jlg, _ = jax.jit(jfns["decode"])(jp, jleaves,
                                     jnp.asarray([[7]], jnp.int32),
                                     jnp.asarray([L], jnp.int32))
    want = _jax_exact(arch, exact, S, [7])[1]
    assert np.abs(_np(jlg)[0] - want).max() > LOGITS_ATOL
    fns = build_inference_fns(cfg, S)
    with torch.no_grad():
        _, leaves = fns["prefill"](params, _t(padded), _t(li))
        lg, _ = fns["decode"](params, leaves, _t([[7]]),
                              _t(np.asarray([L], np.int32)))
    np.testing.assert_allclose(lg.numpy()[0], want, atol=LOGITS_ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------
_ARTIFACTS = {}


def _artifact(arch, S, spec, tmp_path_factory):
    key = (arch, S, spec)
    if key not in _ARTIFACTS:
        cfg, _, params, _ = _setup(arch)
        d = str(tmp_path_factory.mktemp(f"{arch}-{S}-v{spec}"))
        export_model(params, cfg, d, seq_len=S, spec_version=spec)
        _ARTIFACTS[key] = d
    return _ARTIFACTS[key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", ["1", "2"])
def test_manifest_matches_the_reference(arch, spec, tmp_path_factory):
    """The manifest's signature (and, for v2, its graphs' inputs and cache
    leaves) equal the reference's for the same config and ``seq_len``."""
    cfg, jcfg, _, jp = _setup(arch)
    S = 32
    d = _artifact(arch, S, spec, tmp_path_factory)
    assert verify_checksums(d, strict=True)
    m = read_manifest(d)
    assert m["signature"]["inputs"] == [
        {"name": "tokens", "shape": [1, S], "dtype": "int32"}]
    if spec == "1":
        assert "graphs" not in m or not m["graphs"]
        return
    specs = jax_build_inference_fns(jcfg, S)["resolve"](
        jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jp))
    want = [{"shape": list(l.shape), "dtype": str(l.dtype)}
            for l in specs["cache_leaves"]]
    g = m["graphs"]
    assert g["cache"]["leaves"] == want and g["cache"]["width"] == S
    n = 5 if arch == "zamba2-1.2b" else 2
    assert g["cache"]["n_leaves"] == len(want) == n
    assert [i["name"] for i in g["prefill"]["inputs"]] == ["tokens",
                                                           "last_index"]
    assert [i["name"] for i in g["decode_step"]["inputs"]] == [
        "cache", "token", "step"]
    assert [i["shape"] for i in g["prefill"]["inputs"]] == [
        [1, S], [int(s) for s in specs["prefill"][2].shape]]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,L", [(32, 5), (64, 40), (64, 64)])
def test_artifact_equals_eager_bit_for_bit(arch, S, L, tmp_path_factory):
    """The full graph, the prefill graph and ``DECODE_STEPS`` decode steps
    equal the same functions run eagerly (logits and every cache leaf); the
    decode graph updates the leaves it is given in place."""
    cfg, _, params, _ = _setup(arch)
    rt = Runtime(_artifact(arch, S, "2", tmp_path_factory), device="cpu")
    fns = build_inference_fns(cfg, S)
    _, padded, li = _prompt(cfg, L, S, seed=L + 2)
    with torch.no_grad():
        want = fns["full"](params, _t(padded)).numpy()
        assert (rt.run(padded) == want).all()
        lg, cache = rt.prefill(padded, li)
        elg, ecache = fns["prefill"](params, _t(padded), _t(li))
        assert (lg == elg.numpy()).all()
        assert all(torch.equal(a, b) for a, b in zip(cache, ecache))
        for i in range(DECODE_STEPS):
            tok = np.asarray([[11 + i]], np.int32)
            step = np.asarray([L + i], np.int32)
            before = [c.clone() for c in cache]
            lg, out = rt.decode_step(cache, tok, step)
            elg, ecache = fns["decode"](params, ecache, _t(tok), _t(step))
            assert all(o is c for o, c in zip(out, cache))
            assert (lg == elg.numpy()).all()
            assert all(torch.equal(a, b) for a, b in zip(cache, ecache))
            # the state moves every step, in the tensors given
            assert not torch.equal(before[-2], cache[-2])


@pytest.mark.parametrize("arch", ARCHS)
def test_artifact_equals_local_stream(arch, tmp_path_factory):
    """``ArtifactBackend`` (v2: prefill, then the decode graph) equals
    ``LocalBackend.stream`` token for token under injected uniforms, and
    the v1 artifact's full graph gives ``LocalBackend.logits``' bits."""
    cfg, _, params, _ = _setup(arch)
    S = 32
    art = ArtifactBackend(_artifact(arch, S, "2", tmp_path_factory),
                          device="cpu")
    v1 = ArtifactBackend(_artifact(arch, S, "1", tmp_path_factory),
                         device="cpu")
    assert v1.runtime.graphs == ["full"] and not v1.use_decode_graph
    local = LocalBackend(params, cfg, seq_len=S, device="cpu")
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, cfg.vocab_size, 9).tolist()
    u = rng.uniform(size=(8, cfg.vocab_size)).astype(np.float32)
    req = GenerateRequest(tokens=prompt, max_new=8, uniforms=u)
    a = Client(art).generate(req)
    s = [e.token for e in local.stream(req)]
    assert len(s) == 8 and a.tokens == s and not a.ages
    assert (v1.logits(prompt) == local.logits(prompt)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_graphs_call_the_operators(arch, tmp_path_factory):
    """The full and prefill graphs call ``repro_torch::ssd_intra`` once a
    Mamba layer, with B and C as the model's ``expand`` over the heads (no
    H copies), and the hybrid's shared block through
    ``repro_torch::flash_attention`` once an application; the decode graph
    calls ``repro_torch::paged_decode_attention`` once an application and
    no SSD kernel."""
    cfg = _setup(arch)[0]
    d = _artifact(arch, 32, "2", tmp_path_factory)
    apps = cfg.n_layers if arch == "zamba2-1.2b" else 0
    want = {"model.bin": (cfg.n_layers, apps, 0),
            "prefill.bin": (cfg.n_layers, apps, 0),
            "decode.bin": (0, 0, apps)}
    for fname, (n_ssd, n_flash, n_paged) in want.items():
        with open(f"{d}/{fname}", "rb") as f:
            ep = torch.export.load(f)
        calls = [n for n in ep.graph.nodes if n.op == "call_function"]
        names = [str(n.target) for n in calls]
        assert names.count("repro_torch.ssd_intra.default") == n_ssd
        assert names.count("repro_torch.flash_attention.default") == n_flash
        assert names.count(
            "repro_torch.paged_decode_attention.default") == n_paged
        for n in calls:
            if str(n.target) == "repro_torch.ssd_intra.default":
                assert [str(a.target) for a in n.args[1:3]] == [
                    "aten.expand.default"] * 2
