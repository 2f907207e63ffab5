"""The port's checkpoint files read and written one leaf at a time, on the
CPU: ``models.params.load_checkpoint`` (each leaf into its use dtype, a
stacked leaf one layer slice at a time) and ``train.checkpoint.save``
(``np.savez``'s file, written leaf by leaf), against the JAX package's
``save``/``restore`` and numpy's ``savez``/``load``, at the reduced
OLMoE-1B-7B, InternVL2-26B and SeamlessM4T-large-v2.  Every comparison is
bit for bit: the loader rounds each fp32 value once, to bf16 where
``use_dtype`` says so, as JAX's ``restore`` does into a bf16 template.
"""
import os
import tracemalloc
import zipfile
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.train import checkpoint as jax_ckpt
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch
from repro_torch.models import (init_params_on_device, load_checkpoint,
                                to_flat_numpy)
from repro_torch.models.params import STACKS, param_shapes, use_dtype
from repro_torch.train import checkpoint

torch.set_num_threads(2)

ARCHS = ["olmoe-1b-7b", "internvl2-26b", "seamless-m4t-large-v2"]
# host bytes the loader may allocate beyond one piece (headers, zip
# entries, Python objects), against pieces of 512 KiB
HOST_SLACK = 64 * 1024


def _cut(cfg, layers):
    enc = {"n_encoder_layers": layers} if cfg.n_encoder_layers else {}
    return cfg.replace(n_layers=layers, **enc)


def _bits(x):
    """A bf16 or fp32 array (torch or numpy, ml_dtypes' bf16 included) as
    its raw integer bits."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16
                   else torch.int32).numpy()
        return x
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _jax_template(jcfg, cfg):
    """JAX ``init_params``' tree as shapes, each leaf in the port's use
    dtype under ``cfg`` (bf16 or fp32)."""
    shapes = jax.eval_shape(lambda: jax_init_params(
        jcfg, jax.random.PRNGKey(0)))

    def leaf(path, s):
        key = "/".join(p.key for p in path)
        dt = jnp.bfloat16 if use_dtype(cfg, key) == torch.bfloat16 \
            else jnp.float32
        return jax.ShapeDtypeStruct(s.shape, dt)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _infos(path):
    with zipfile.ZipFile(path) as zf:
        return [(i.filename, i.compress_type, i.file_size, i.CRC, i.extra)
                for i in zf.infolist()], \
            {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_save_loads_in_use_dtype(arch, tmp_path):
    """The JAX package's ``save`` of its fp32 ``init_params``, read by the
    port's ``load_checkpoint`` under the bf16 config: ``MATMUL_KEYS``
    leaves bf16, the rest fp32, each bit-equal to JAX's ``restore`` into a
    template of those dtypes; under the fp32 config every leaf is the
    file's fp32."""
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    cfg = get_config(arch, reduced=True)
    assert cfg.dtype == "bfloat16"
    jax_ckpt.save(str(tmp_path), jax_init_params(jcfg, jax.random.PRNGKey(3)),
                  jcfg)
    mine = load_checkpoint(str(tmp_path), cfg, device="cpu")
    theirs = _jax_flat(jax_ckpt.restore(str(tmp_path),
                                        _jax_template(jcfg, cfg)))
    assert set(mine) == set(theirs) == set(param_shapes(cfg))
    assert {k for k, v in mine.items() if v.dtype == torch.bfloat16} \
        == {k for k in mine if use_dtype(cfg, k) == torch.bfloat16} != set()
    for k, v in mine.items():
        assert v.dtype == use_dtype(cfg, k), k
        assert np.array_equal(_bits(v), _bits(theirs[k])), k
    f32 = load_checkpoint(str(tmp_path), cfg.replace(dtype="float32"),
                          device="cpu")
    with np.load(tmp_path / "params.npz") as data:
        for k, v in f32.items():
            assert v.dtype == torch.float32
            assert np.array_equal(v.numpy(), data[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_save_is_np_savez_file_read_by_jax(arch, tmp_path):
    """The port's ``save`` writes ``np.savez``'s members (names, stored
    uncompressed, ZIP64 extra, sizes, CRC-32s, bytes); ``np.load`` and the
    JAX package's ``restore`` and ``load_config`` read it bit for bit."""
    cfg = get_config(arch, reduced=True)
    params = init_params_on_device(cfg.replace(dtype="float32"), seed=5,
                                   device="cpu")
    checkpoint.save(str(tmp_path / "port"), params, cfg)
    np.savez(tmp_path / "ref.npz", **to_flat_numpy(params))
    mine, mine_bytes = _infos(tmp_path / "port" / "params.npz")
    ref, ref_bytes = _infos(tmp_path / "ref.npz")
    assert mine == ref
    assert all(i[1] == zipfile.ZIP_STORED for i in mine)
    assert mine_bytes == ref_bytes
    with np.load(tmp_path / "port" / "params.npz") as data:
        assert set(data.files) == set(params)
        for k, v in params.items():
            assert np.array_equal(data[k], v.numpy()), k
    jcfg, _ = jax_ckpt.load_config(str(tmp_path / "port"))
    assert (jcfg.name, jcfg.n_layers, jcfg.n_encoder_layers) == (
        cfg.name, cfg.n_layers, cfg.n_encoder_layers)
    back = _jax_flat(jax_ckpt.restore(
        str(tmp_path / "port"),
        _jax_template(jcfg, cfg.replace(dtype="float32"))))
    for k, v in params.items():
        assert back[k].dtype == np.float32
        assert np.array_equal(back[k], v.numpy()), k


@pytest.mark.parametrize("arch", ARCHS)
def test_device_init_saved_and_loaded_in_bf16(arch, tmp_path):
    """``init_params_on_device`` in fp32, saved and loaded under the bf16
    config, equals ``init_params_on_device`` in bf16 (the same draws
    rounded) leaf for leaf, dtypes included; so does the same file written
    compressed (``np.savez_compressed``: read whole, a leaf at a time)."""
    cfg = get_config(arch, reduced=True)
    want = init_params_on_device(cfg, seed=7, device="cpu")
    p32 = init_params_on_device(cfg.replace(dtype="float32"), seed=7,
                                device="cpu")
    checkpoint.save(str(tmp_path / "stored"), p32, cfg)
    os.makedirs(tmp_path / "packed")
    np.savez_compressed(tmp_path / "packed" / "params.npz",
                        **to_flat_numpy(p32))
    for d in ("stored", "packed"):
        got = load_checkpoint(str(tmp_path / d), cfg, device="cpu")
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (d, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_leaf_read_one_slice_at_a_time(arch, tmp_path):
    """At 6 layers the largest stacked leaf is 3 MiB and every piece the
    loader reads (a layer slice, or an unstacked leaf whole) at most 512
    KiB: the host arrays the load allocates (``tracemalloc``, which numpy
    reports to) peak at one piece plus ``HOST_SLACK``, never a whole
    stacked leaf; the tree loaded equals the saved one."""
    cfg = _cut(get_config(arch, reduced=True), 6).replace(dtype="float32")
    params = init_params_on_device(cfg, seed=9, device="cpu")
    checkpoint.save(str(tmp_path), params, cfg)
    shapes = param_shapes(cfg)
    piece = 4 * max(int(np.prod(s[1:] if k.startswith(STACKS) else s))
                    for k, s in shapes.items())
    leaf = 4 * max(int(np.prod(s)) for k, s in shapes.items()
                   if k.startswith(STACKS))
    assert piece == 512 * 1024 and leaf == 6 * piece
    tracemalloc.start()
    try:
        got = load_checkpoint(str(tmp_path), cfg, device="cpu")
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert piece <= peak <= piece + HOST_SLACK, peak
    assert all(torch.equal(got[k], v) for k, v in params.items())


@pytest.mark.parametrize("nbytes", [0, 1, 4095, 4096, 4097, 3 * 4096 + 17,
                                    10 * 4096])
def test_parallel_crc32_equals_zlib(nbytes):
    """The loader's CRC-32 over 1 KiB chunks on 4 threads, combined, equals
    ``zlib.crc32`` from any starting value."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.models.params import crc32
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                  dtype=np.uint8)
    with ThreadPoolExecutor(4) as pool:
        for start in (0, 0x1234567, 0xFFFFFFFF):
            assert crc32(data, start, pool, chunk=1024) == \
                zlib.crc32(data, start)


def test_other_byte_order_and_fortran_order_load(tmp_path):
    """A file whose arrays are big-endian (read in place, swapped) or
    Fortran-ordered (read whole) loads to the same tree."""
    cfg = get_config("internvl2-26b", reduced=True).replace(dtype="float32")
    params = init_params_on_device(cfg, seed=2, device="cpu")
    flat = to_flat_numpy(params)
    np.savez(tmp_path / "params.npz",
             **{k: (v.astype(">f4") if i % 2 else np.asfortranarray(v))
                for i, (k, v) in enumerate(flat.items())})
    got = load_checkpoint(str(tmp_path), cfg, device="cpu")
    for k, v in params.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k


def test_load_refuses_bad_files(tmp_path):
    """Key and shape errors raise as ``from_jax_flat``'s do, and a stored
    member whose bytes changed fails its CRC-32, as under ``np.load``."""
    cfg = get_config("olmoe-1b-7b", reduced=True).replace(dtype="float32")
    params = init_params_on_device(cfg, seed=1, device="cpu")
    flat = to_flat_numpy(params)
    bad = dict(flat)
    bad.pop("embed/embed")
    np.savez(tmp_path / "params.npz", **bad)
    with pytest.raises(ValueError, match="missing \\['embed/embed'\\]"):
        load_checkpoint(str(tmp_path), cfg, device="cpu")
    bad = dict(flat, **{"layers/moe/w_up": flat["layers/moe/w_up"][:1]})
    np.savez(tmp_path / "params.npz", **bad)
    with pytest.raises(ValueError, match="layers/moe/w_up: shape"):
        load_checkpoint(str(tmp_path), cfg, device="cpu")
    checkpoint.save(str(tmp_path), params, cfg)
    path = tmp_path / "params.npz"
    blob = bytearray(path.read_bytes())
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("layers/moe/w_up.npy")
    blob[info.header_offset + info.compress_size] ^= 0xFF  # in its data
    path.write_bytes(bytes(blob))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        load_checkpoint(str(tmp_path), cfg, device="cpu")


def test_serve_cli_on_a_saved_checkpoint(tmp_path, monkeypatch, capsys):
    """``launch.serve.main([... --ckpt ...])`` on the reduced OLMoE serves
    the tokens that the same parameters held in memory serve (the CLI's
    own device route, seed for seed), and prints the load's numbers."""
    real = launch.get_config
    monkeypatch.setattr(launch, "get_config",
                        lambda a: real(a, reduced=True))
    cfg = launch.get_config("olmoe-1b-7b").replace(dtype="float32")
    checkpoint.save(str(tmp_path), init_params_on_device(
        cfg, seed=0, device="cpu"), cfg)
    argv = ["--arch", "olmoe-1b-7b", "--requests", "3", "--slots", "2",
            "--max-new", "4", "--max-context", "160", "--device", "cpu",
            "--seed", "0"]
    served = launch.main(argv + ["--ckpt", str(tmp_path)])
    memory = launch.main(argv)
    assert [r.out_tokens for r in served["done"]] == \
        [r.out_tokens for r in memory["done"]]
    assert served["events"] == 12 and memory["load"] is None
    load = served["load"]
    assert load["device_peak_bytes"] is None and load["seconds"] > 0
    assert load["host_rss_kind"] in ("VmHWM", "VmRSS")
    assert load["host_rss_bytes"] > 0
    assert load["tree_bytes"] == sum(
        v.numel() * 4 for v in served["engine"].params.values())
    assert f"loaded {tmp_path} in" in capsys.readouterr().out
