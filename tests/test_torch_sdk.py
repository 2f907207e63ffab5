"""The port's SDK artifact on the CPU (``repro_torch.sdk``): the ports of
``tests/test_sdk.py`` and of the artifact tests of ``tests/test_api.py``,
the artifact held against the JAX package's, and the exportable attention
operators of ``repro_torch.kernels.library``.

Weights come from the JAX package's ``init_delphi`` and cross over with
``from_jax_flat`` (reduced Delphi, vocabulary 96, fp32).

Bit for bit only where one device runs one graph (ROADMAP rule 6): the
artifact's full graph == eager ``forward``; v2 prefill/decode ==
``LocalBackend.stream`` (one function by construction); the session ==
``ArtifactBackend(use_decode_graph=False)``; v1 == v2's full graph.  The v1
and v2 trajectories run different kernels (flash over the whole sequence
against the paged decode), so they, and the SDK against the core sampler,
are held margin-aware (``repro_torch.core.parity``, margin and age tolerance
2e-3 as in ``tests/test_torch_api.py``).

Against the JAX package, logits agree within ``JAX_ATOL``.  Measured on
the CPU over four weight seeds of these inputs (ages 30-84), the largest
disagreement was 7.2e-4 (full graph), 3.6e-4 (prefill) and 8.2e-4 (decode,
at age 84): XLA's fp32 ``exp`` is one ulp off at a few entries of the
age-encoding table (ROADMAP §C).  The tests allow 2e-3, as
``tests/test_torch_model.py`` does.
"""
import ast
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import get_logits as jax_get_logits
from repro.core import init_delphi
from repro.sdk import Runtime as JaxRuntime
from repro.sdk import export_model as jax_export_model
from repro.sdk.export import nest as jax_nest
from repro_torch.api import ArtifactBackend, Client, GenerateRequest
from repro_torch.configs import get_config
from repro_torch.core import generate_trajectories
from repro_torch.core.parity import (check_trajectories, compare_runs,
                                     port_logits_fn)
from repro_torch.kernels import library, ref
from repro_torch.models import forward, from_jax_flat, init_params
from repro_torch.sdk import (ChecksumError, InferenceSession, Runtime,
                             export_model, read_manifest, verify_checksums)
from repro_torch.sdk import runtime as runtime_mod

torch.set_num_threads(2)

TOKS = [3, 10, 20]
AGES = [0.0, 15.0, 28.0]
JAX_ATOL = 2e-3
MARGIN = 2e-3


def jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _cfgs(seq):
    kw = dict(dtype="float32", vocab_size=96, max_seq_len=seq)
    return (get_config("delphi-2m", reduced=True).replace(**kw),
            jax_config("delphi-2m", reduced=True).replace(**kw))


def _uniforms(max_new, V, seed=42):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(max_new, V)).astype(np.float32)


def _padded(toks, ages, S):
    t = np.zeros((1, S), np.int32)
    t[0, :len(toks)] = toks
    a = np.zeros((1, S), np.float32)
    a[0, :len(ages)] = ages
    a[0, len(ages):] = ages[-1]
    return t, a


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A v2 artifact at max_seq_len 32 (the fixture of tests/test_sdk.py),
    and the JAX package's artifact of the same weights."""
    cfg, jcfg = _cfgs(32)
    jparams = init_delphi(jcfg, jax.random.PRNGKey(11))
    params = from_jax_flat(jax_flat(jparams), cfg, device="cpu")
    d = str(tmp_path_factory.mktemp("artifact"))
    export_model(params, cfg, d)
    jd = str(tmp_path_factory.mktemp("jax_artifact"))
    jax_export_model(jparams, jcfg, jd)
    return d, params, cfg, jd, jparams


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """v2 and v1 artifacts at max_seq_len 48 (the fixture of
    tests/test_api.py)."""
    cfg, jcfg = _cfgs(48)
    params = from_jax_flat(jax_flat(init_delphi(jcfg, jax.random.PRNGKey(7))),
                           cfg, device="cpu")
    d2 = str(tmp_path_factory.mktemp("artifact_v2"))
    export_model(params, cfg, d2)
    d1 = str(tmp_path_factory.mktemp("artifact_v1"))
    export_model(params, cfg, d1, spec_version="1")
    return params, cfg, d2, d1


def _held(params, cfg, trajs, uniforms, max_age=1e9):
    return check_trajectories(
        [(TOKS, AGES)] * len(trajs), trajs, uniforms,
        port_logits_fn(params, cfg), margin_tol=MARGIN, age_rtol=MARGIN,
        max_age=max_age, death_token=cfg.death_token,
        max_context=cfg.max_seq_len)


# ---------------------------------------------------------------------------
# The ports of tests/test_sdk.py
# ---------------------------------------------------------------------------
def test_files_and_checksums(artifact):
    d = artifact[0]
    assert sorted(os.listdir(d)) == ["decode.bin", "manifest.json",
                                     "model.bin", "params.npz", "prefill.bin"]
    assert verify_checksums(d)


def test_tamper_detection(artifact, tmp_path):
    d, params, cfg = artifact[:3]
    d2 = str(tmp_path / "tampered")
    export_model(params, cfg, d2, spec_version="1")
    with open(os.path.join(d2, "params.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    assert not verify_checksums(d2)


def test_manifest_fair_fields(artifact):
    d, _, cfg, jd, _ = artifact
    m = read_manifest(d)
    for field in ("name", "identifier", "files", "interchange_format",
                  "signature", "provenance", "license", "sampling",
                  "privacy"):
        assert field in m, field
    assert m["sampling"]["termination"]["max_age_years"] == cfg.max_age
    assert m["sampling"]["termination"]["death_token"] == cfg.death_token
    assert m["interchange_format"] == "torch.export"
    assert any("repro_torch.kernels.library" in r for r in m["requires"])
    # the JAX manifest's FAIR blocks, field for field
    jm = read_manifest(jd)
    assert set(m) == set(jm)
    for k in ("signature", "sampling", "privacy", "provenance", "license",
              "spec_version"):
        assert m[k] == jm[k], k
    assert m["identifier"].startswith(f"repro/{cfg.name}@sha256:")
    assert m["graphs"]["cache"] == {**m["graphs"]["cache"], "n_leaves": 3,
                                    "width": cfg.max_seq_len}


def test_bitwise_logit_parity(artifact):
    """Claim C2: the artifact reproduces the eager logits bit for bit (one
    device, one graph)."""
    d, params, cfg = artifact[:3]
    sess = InferenceSession(d, device="cpu")
    t, a = _padded(TOKS, AGES, cfg.max_seq_len)
    with torch.no_grad():
        eager = forward(params, cfg, {"tokens": torch.from_numpy(t),
                                      "ages": torch.from_numpy(a)},
                        mode="train")["logits"].numpy()
    assert (sess.get_logits(TOKS, AGES) == eager[0, 2]).all()
    assert (sess.runtime.run(t, a) == eager).all()


def test_runtime_is_decoupled():
    """The runtime imports no model code (the ONNX property): an AST walk
    of its imports."""
    tree = ast.parse(open(runtime_mod.__file__).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "repro_torch.kernels.library" in names
    for banned in ("models", "core", "configs", "train", "serve", "api"):
        mod = f"repro_torch.{banned}"
        assert not any(n == mod or n.startswith(mod + ".") for n in names), \
            f"runtime imports {mod}"
    assert not any(n == "repro" or n.startswith("repro.") for n in names)


def test_sdk_vs_core_trajectory_parity(artifact):
    """Claim C2/C3: host-side SDK generation and the core sampler consume
    the same uniforms.  They run different kernels (the session's full
    graph against prefill + paged decode), so each is held to the model on
    its own prefix and the two agree up to their first divergence."""
    d, params, cfg = artifact[:3]
    sess = InferenceSession(d, device="cpu")
    max_new = 6
    runs_sdk, runs_core, us = [], [], []
    for seed in range(3):
        u = _uniforms(max_new, cfg.vocab_size, seed=40 + seed)
        sdk = sess.generate_trajectory(TOKS, AGES, max_new=max_new,
                                       uniforms=u, max_age=1e9)
        with torch.no_grad():
            core = generate_trajectories(
                params, cfg, torch.tensor([TOKS], dtype=torch.int32),
                torch.tensor([AGES], dtype=torch.float32), max_new=max_new,
                max_age=1e9, death_token=cfg.death_token,
                uniforms=torch.from_numpy(u)[None])
        n = int(core["n_generated"][0])
        runs_sdk.append((sdk["tokens"], sdk["ages"]))
        runs_core.append((core["tokens"][0, 3:3 + n].tolist(),
                          core["ages"][0, 3:3 + n].tolist()))
        us.append(u)
    assert sum(len(t) for t, _ in runs_sdk) > 0
    _held(params, cfg, runs_sdk, us)
    _held(params, cfg, runs_core, us)
    # free-running ages drift before the events part (the parity module's
    # note): each run is held on its own prefix above, and the loose bound
    # of tests/test_torch_api.py applies between them
    assert compare_runs(runs_core, runs_sdk, age_rtol=0.25)["compared"] >= 3


def test_make_inputs_rejects_bad_calls(artifact):
    sess = InferenceSession(artifact[0], device="cpu")
    with pytest.raises(ValueError, match="ages"):
        sess.get_logits([3, 10, 20], None)
    with pytest.raises(ValueError, match="empty"):
        sess.get_logits([], [])
    with pytest.raises(ValueError, match="mismatch"):
        sess.get_logits([3, 10], [0.0])
    with pytest.raises(ValueError, match="longer than"):
        sess.get_logits(list(range(3, 3 + sess.seq_len + 1)),
                        [0.0] * (sess.seq_len + 1))


def test_runtime_offline(artifact, monkeypatch):
    """C5: loading and running the artifact touches no network API."""
    def no_net(*a, **k):
        raise AssertionError("network access attempted")
    monkeypatch.setattr(socket, "create_connection", no_net)
    monkeypatch.setattr(socket.socket, "connect", no_net)
    rt = Runtime(artifact[0], device="cpu")
    S = rt.input_signature[0]["shape"][1]
    out = rt.run(np.zeros((1, S), np.int32), np.zeros((1, S), np.float32))
    assert out.shape == (1, S, 96)


def test_runtime_needs_a_card_unless_asked_for_the_cpu(artifact,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runtime(artifact[0])


def test_decode_step_updates_the_cache_in_place(artifact):
    d, _, cfg = artifact[:3]
    rt = Runtime(d, device="cpu")
    t, a = _padded(TOKS, AGES, cfg.max_seq_len)
    _, cache = rt.prefill(t, a, np.asarray([2], np.int32))
    assert [c.shape for c in cache] == [
        tuple(l["shape"]) for l in rt.manifest["graphs"]["cache"]["leaves"]]
    assert (cache[2][:, 0, 3:] == -1).all()       # the padding is masked
    _, out = rt.decode_step(cache, np.asarray([[40]], np.int32),
                            np.asarray([[30.0]], np.float32),
                            np.asarray([3], np.int32))
    assert all(o is c for o, c in zip(out, cache))
    assert (cache[2][:, 0, 3] == 3).all()


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------
def test_full_logits_match_jax(artifact):
    d, _, cfg, _, jparams = artifact
    rt = Runtime(d, device="cpu")
    rng = np.random.default_rng(3)
    for S0 in (5, cfg.max_seq_len):
        toks = rng.integers(3, cfg.vocab_size, S0).tolist()
        ages = np.sort(rng.uniform(30, 84, S0)).astype(np.float32).tolist()
        t, a = _padded(toks, ages, cfg.max_seq_len)
        jcfg = _cfgs(cfg.max_seq_len)[1]
        want = np.asarray(jax_get_logits(jparams, jcfg, jnp.asarray(t),
                                         jnp.asarray(a)))
        np.testing.assert_allclose(rt.run(t, a), want, atol=JAX_ATOL,
                                   rtol=0)


def test_prefill_and_decode_match_jax_runtime(artifact):
    """The port artifact's prefill and four decode steps against the JAX
    artifact's runtime on the same weights and inputs."""
    d, _, cfg, jd, _ = artifact
    mine, theirs = Runtime(d, device="cpu"), JaxRuntime(jd)
    toks, ages = [3, 17, 40, 52, 8], [30.0, 41.5, 55.0, 63.25, 70.0]
    t, a = _padded(toks, ages, cfg.max_seq_len)
    last = np.asarray([len(toks) - 1], np.int32)
    lg, cache = mine.prefill(t, a, last)
    jlg, jcache = theirs.prefill(t, a, last)
    np.testing.assert_allclose(lg, jlg, atol=JAX_ATOL, rtol=0)
    for i, (tok, age) in enumerate([(60, 72.5), (11, 75.0), (2, 79.5),
                                    (33, 84.0)]):
        step = np.asarray([len(toks) + i], np.int32)
        tk = np.asarray([[tok]], np.int32)
        ag = np.asarray([[age]], np.float32)
        lg, cache = mine.decode_step(cache, tk, ag, step)
        jlg, jcache = theirs.decode_step(jcache, tk, ag, step)
        np.testing.assert_allclose(lg, jlg, atol=JAX_ATOL, rtol=0,
                                   err_msg=f"decode step {i}")


def test_runtime_refuses_a_jax_artifact(artifact):
    jd = artifact[3]
    with pytest.raises(ValueError, match="stablehlo"):
        Runtime(jd, device="cpu")


def test_params_npz_nests_as_jax(artifact):
    """The weight file is the JAX package's layout: its ``nest`` rebuilds
    the JAX parameters array for array."""
    d, jparams = artifact[0], artifact[4]
    with np.load(os.path.join(d, "params.npz")) as data:
        tree = jax_nest({k: data[k] for k in data.files})
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        assert x.dtype == y.dtype and (x == np.asarray(y)).all(), path


# ---------------------------------------------------------------------------
# The ports of the artifact tests of tests/test_api.py
# ---------------------------------------------------------------------------
def test_v1_artifact_still_loads_and_matches_v2_logits(setup):
    _, cfg, d2, d1 = setup
    rt1, rt2 = Runtime(d1, device="cpu"), Runtime(d2, device="cpu")
    assert rt1.spec_version == "1.0" and not rt1.has_decode_graph
    assert rt2.spec_version == "2.0" and rt2.has_decode_graph
    assert rt1.graphs == ["full"]
    assert rt2.graphs == ["decode_step", "full", "prefill"]
    t, a = _padded(TOKS, AGES, cfg.max_seq_len)
    assert (rt1.run(t, a) == rt2.run(t, a)).all()
    with pytest.raises(ValueError, match="re-export with spec v2"):
        rt1.prefill(t, a, np.asarray([2], np.int32))
    assert "graphs" not in read_manifest(d1)


def test_v1_artifact_generates_via_full_graph_fallback(setup):
    """v1 falls back to the full graph per token; v2 decodes.  Two kernels
    (flash against paged decode), so the runs are held margin-aware."""
    params, cfg, d2, d1 = setup
    c1 = Client.from_artifact(d1, device="cpu")
    assert c1.backend.use_decode_graph is False       # auto fallback
    c2 = Client.from_artifact(d2, device="cpu")
    assert c2.backend.use_decode_graph is True
    runs1, runs2, us = [], [], []
    for seed in range(3):
        u = _uniforms(5, cfg.vocab_size, seed=seed)
        r1 = c1.generate(tokens=TOKS, ages=AGES, max_new=5, uniforms=u,
                         max_age=1e9)
        r2 = c2.generate(tokens=TOKS, ages=AGES, max_new=5, uniforms=u,
                         max_age=1e9)
        runs1.append((r1.tokens, r1.ages))
        runs2.append((r2.tokens, r2.ages))
        us.append(u)
    _held(params, cfg, runs1, us)
    _held(params, cfg, runs2, us)
    assert compare_runs(runs2, runs1, age_rtol=0.25)["compared"] >= 3
    with pytest.raises(ValueError, match="decode graph"):
        ArtifactBackend(d1, use_decode_graph=True, device="cpu")


def test_artifact_equals_local_backend_stream(setup):
    """ArtifactBackend (v2) == LocalBackend's stream token for token and
    age for age: the same prefill and decode functions, exported and
    eager, on one device."""
    params, cfg, d2, _ = setup
    art = Client.from_artifact(d2, device="cpu")
    local = Client.from_params(params, cfg, device="cpu")
    n = 0
    for seed in range(3):
        u = _uniforms(8, cfg.vocab_size, seed=10 + seed)
        req = GenerateRequest(tokens=TOKS, ages=AGES, max_new=8, uniforms=u,
                              max_age=1e9)
        a = art.generate(req)
        s = list(local.stream(req))
        assert a.tokens == [e.token for e in s]
        assert a.ages == [e.age for e in s]
        assert a.backend == "artifact"
        n += len(a.tokens)
    assert n > 0


def test_decode_path_max_age_censoring(setup):
    _, cfg, d2, _ = setup
    u = _uniforms(6, cfg.vocab_size)
    client = Client.from_artifact(d2, device="cpu")
    free = client.generate(tokens=TOKS, ages=AGES, max_new=6, uniforms=u,
                           max_age=1e9)
    assert len(free.ages) >= 3
    k = 2
    boundary = (free.ages[k - 1] + free.ages[k]) / 2
    cut = client.generate(tokens=TOKS, ages=AGES, max_new=6, uniforms=u,
                          max_age=boundary)
    assert cut.tokens == free.tokens[:k]
    assert all(a <= boundary for a in cut.ages)


def test_session_is_a_client_shim(setup):
    """The session pins the full-graph loop and equals
    ``ArtifactBackend(use_decode_graph=False)`` bit for bit."""
    _, cfg, d2, _ = setup
    sess = InferenceSession(d2, device="cpu")
    assert isinstance(sess.client, Client)
    assert sess.client.backend.use_decode_graph is False
    with pytest.warns(DeprecationWarning, match="deprecated"):
        lg = sess.getLogits(TOKS, AGES)
    full = ArtifactBackend(d2, use_decode_graph=False, device="cpu")
    assert (lg == full.logits(TOKS, AGES)).all()
    u = _uniforms(6, cfg.vocab_size, seed=3)
    with pytest.warns(DeprecationWarning):
        out = sess.generateTrajectory(TOKS, AGES, max_new=6, uniforms=u,
                                      max_age=1e9)
    ref_out = Client(full).generate(tokens=TOKS, ages=AGES, max_new=6,
                                    uniforms=u, max_age=1e9)
    assert out["tokens"] == ref_out.tokens and out["ages"] == ref_out.ages
    with pytest.warns(DeprecationWarning):
        risk = sess.estimateRisk(TOKS, AGES, horizon=5.0, top=8)
    assert risk == Client(full).risk(TOKS, AGES, horizon=5.0,
                                     top=8).as_dicts()


def test_checksum_report_states(setup, tmp_path):
    params, cfg, _, _ = setup
    d = str(tmp_path / "art")
    export_model(params, cfg, d)
    rep = verify_checksums(d)
    assert rep and rep.ok and set(rep.files.values()) == {"ok"}
    with open(os.path.join(d, "params.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    os.remove(os.path.join(d, "prefill.bin"))
    rep = verify_checksums(d)
    assert not rep
    assert rep.bad_files == {"params.npz": "mismatch",
                             "prefill.bin": "missing"}
    assert rep.files["model.bin"] == "ok"
    with pytest.raises(ChecksumError, match="params.npz"):
        verify_checksums(d, strict=True)
    with pytest.raises(ChecksumError, match="prefill.bin"):
        verify_checksums(d, strict=True)


def test_export_validation(setup, tmp_path):
    params, cfg, _, _ = setup
    bad = str(tmp_path / "bad")
    with pytest.raises(ValueError, match="max_seq_len"):
        export_model(params, cfg, bad, seq_len=cfg.max_seq_len + 1)
    with pytest.raises(ValueError, match="logits_fn"):
        export_model(params, cfg, bad, logits_fn=lambda p, t, a: t)
    with pytest.raises(ValueError, match="spec_version"):
        export_model(params, cfg, bad, spec_version="3")
    assert not os.path.exists(bad)


def test_custom_logits_fn_exports_v1(setup, tmp_path):
    params, cfg, _, _ = setup
    d = str(tmp_path / "custom")

    def doubled(p, tokens, ages):
        return 2.0 * forward(p, cfg, {"tokens": tokens, "ages": ages},
                             mode="train")["logits"]
    export_model(params, cfg, d, spec_version="1", logits_fn=doubled)
    full = ArtifactBackend(d, device="cpu")
    assert full.runtime.graphs == ["full"]
    with torch.no_grad():
        t, a = _padded(TOKS, AGES, cfg.max_seq_len)
        want = doubled(params, torch.from_numpy(t), torch.from_numpy(a))
    assert (full.logits(TOKS, AGES) == want[0, 2].numpy()).all()


@pytest.mark.parametrize("arch,match", [
    ("mamba2-780m", "recurrent state"),
    ("zamba2-1.2b", "recurrent state"),
    ("rope", "RoPE")])
def test_export_refuses_what_it_cannot_serve(tmp_path, arch, match):
    """Generic-LM signatures, exported (only a VLM and an encoder-decoder
    are refused: ``tests/test_torch_vlm.py``, ``tests/test_torch_encdec.py``).
    Mamba2 and the hybrid Zamba2, which were refused until the prefill
    graph masked a recurrent state at ``last_index``, and a dense model
    with RoPE (reduced Delphi with no age encoding).  ``match`` names what
    the cache carries besides rings: a recurrent state (``[h, conv]``
    after the hybrid's ``[k, v, pos]``), or RoPE'd keys only.  Each exports
    at ``seq_len`` 32: its graphs take no ages, its full graph equals eager
    ``forward`` bit for bit, and v2 decode gives the full graph's tokens
    (Gumbel sampling, injected uniforms)."""
    if arch == "rope":
        cfg = _cfgs(32)[0].replace(age_encoding=False, dual_head=False)
        params = init_params(cfg, seed=5, device="cpu")
    else:
        cfg = get_config(arch, reduced=True).replace(dtype="float32")
        params = init_params(cfg, seed=5, device="cpu")
    d = str(tmp_path / arch)
    export_model(params, cfg, d, seq_len=32)
    m = read_manifest(d)
    leaves = m["graphs"]["cache"]["leaves"]
    if match == "recurrent state":
        h, conv = leaves[-2:]
        assert h["dtype"] == "float32" and len(h["shape"]) == 5
        assert conv["shape"][2] == cfg.ssm_conv
        assert len(leaves) == (5 if cfg.arch_type == "hybrid" else 2)
    else:
        assert [l["dtype"] for l in leaves] == ["float32", "float32",
                                                "int32"]
    assert [i["name"] for i in m["signature"]["inputs"]] == ["tokens"]
    assert [i["name"] for i in m["graphs"]["decode_step"]["inputs"]] == [
        "cache", "token", "step"]
    full = ArtifactBackend(d, use_decode_graph=False, device="cpu")
    dec = ArtifactBackend(d, device="cpu")
    t = np.zeros((1, 32), np.int32)
    t[0, :3] = TOKS
    with torch.no_grad():
        want = forward(params, cfg, {"tokens": torch.from_numpy(t)},
                       mode="train")["logits"][0, 2].numpy()
    assert (full.logits(TOKS) == want).all()
    u = _uniforms(6, cfg.vocab_size, seed=13)
    a = Client(full).generate(tokens=TOKS, max_new=6, uniforms=u)
    b = Client(dec).generate(tokens=TOKS, max_new=6, uniforms=u)
    assert len(b.tokens) == 6 and b.tokens == a.tokens and not b.ages


def test_bf16_artifact_equals_eager(tmp_path):
    """A bf16 artifact (traced on the CPU at the config's dtype) against
    eager bf16 on the CPU, bit for bit."""
    cfg = _cfgs(16)[0].replace(dtype="bfloat16")
    params = from_jax_flat(
        jax_flat(init_delphi(_cfgs(16)[1], jax.random.PRNGKey(2))), cfg,
        device="cpu")
    d = str(tmp_path / "bf16")
    export_model(params, cfg, d)
    m = read_manifest(d)
    assert [l["dtype"] for l in m["graphs"]["cache"]["leaves"]] == \
        ["bfloat16", "bfloat16", "int32"]
    art = Client.from_artifact(d, device="cpu")
    local = Client.from_params(params, cfg, device="cpu")
    assert (art.backend.logits(TOKS, AGES)
            == local.backend.logits(TOKS, AGES)).all()
    u = _uniforms(4, cfg.vocab_size, seed=9)
    req = GenerateRequest(tokens=TOKS, ages=AGES, max_new=4, uniforms=u,
                          max_age=1e9)
    a = art.generate(req)
    s = list(local.stream(req))
    assert a.tokens == [e.token for e in s] and a.ages == [e.age for e in s]


# ---------------------------------------------------------------------------
# The exportable operators
# ---------------------------------------------------------------------------
def _flash_inputs(seed=0, B=2, S=7, H=3, hd=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, B, S, H, hd, generator=g)
    return [t.transpose(1, 2) for t in x]        # the model's views


def _paged_inputs(seed=0, B=2, Hkv=3, G=2, hd=5, NB=4, bs=4):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hkv, G, hd, generator=g)
    kp = torch.randn(NB, Hkv, bs, hd, generator=g)
    vp = torch.randn(NB, Hkv, bs, hd, generator=g)
    table = torch.tensor([[1, 2], [3, -1]], dtype=torch.int32)
    pos = torch.arange(NB * bs, dtype=torch.int32).reshape(NB, bs) - 4
    step = torch.tensor([6, 9], dtype=torch.int32)
    return q, kp, vp, table, pos, step


def _ssd_inputs(seed=0, b=2, c=3, Q=8, H=4, P=5, N=6):
    """The model's layout: B and C one tile per batch row, broadcast over
    the heads by a stride-0 axis."""
    g = torch.Generator().manual_seed(seed)
    xdt = torch.randn(b, c, Q, H, P, generator=g)
    Bm = torch.randn(b, c, Q, 1, N, generator=g).expand(b, c, Q, H, N)
    Cm = torch.randn(b, c, Q, 1, N, generator=g).expand(b, c, Q, H, N)
    cum = -torch.cumsum(0.2 * torch.rand(b, c, Q, H, generator=g), dim=2)
    return xdt, Bm, Cm, cum


@pytest.mark.parametrize("op", ["flash", "paged", "ssd"])
def test_operator_fake_matches_the_real_output(op):
    from torch._subclasses.fake_tensor import FakeTensorMode
    if op == "flash":
        fn, args = library.flash_attention, (*_flash_inputs(), True, None)
    elif op == "paged":
        fn, args = library.paged_decode_attention, (*_paged_inputs(), None)
    else:
        fn, args = library.ssd_intra, _ssd_inputs()
    real = fn(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = fn(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args])
    for f, r in (zip(fake, real) if op == "ssd" else [(fake, real)]):
        assert (f.shape, f.dtype, f.stride()) == \
            (r.shape, r.dtype, r.stride())
    if op == "flash":       # the kernel's layout: q's strides
        assert real.stride() == args[0].stride()


def test_operator_equals_ref_on_the_cpu():
    q, k, v = _flash_inputs(seed=1)
    for causal, window in ((True, None), (True, 3), (False, None)):
        got = library.flash_attention(q, k, v, causal, window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        assert torch.equal(got, want)
    args = _paged_inputs(seed=2)
    for window in (None, 3):
        got = library.paged_decode_attention(*args, window)
        want = ref.paged_decode_attention_ref(*args, window=window)
        assert torch.equal(got, want)
    args = _ssd_inputs(seed=3)
    for got, want in zip(library.ssd_intra(*args),
                         ref.ssd_intra_heads_ref(*args)):
        assert got.is_contiguous() and torch.equal(got, want)


def test_export_holds_the_operator_nodes():
    """A toy caller through ``kernels.ops`` exports with one
    ``repro_torch::`` node per call, and runs the same after a save/load
    round trip."""
    from repro_torch.kernels import ops

    class Toy(torch.nn.Module):
        def forward(self, q, k, v, kp, vp, table, pos, step):
            o = ops.flash_attention(q, k, v, causal=True)
            d = ops.paged_decode_attention(o[:, :, -1], kp, vp, table, pos,
                                           step)
            return o, d

    q, k, v = _flash_inputs(B=2, H=6)
    _, kp, vp, table, pos, step = _paged_inputs(Hkv=3)
    args = (q, k, v, kp, vp, table, pos, step)
    with torch.no_grad():
        ep = torch.export.export(Toy(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("repro_torch.flash_attention.default") == 1
    assert targets.count("repro_torch.paged_decode_attention.default") == 1
    eager = Toy()(*args)
    with torch.no_grad():
        got = ep.module()(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
