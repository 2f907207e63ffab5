"""Package rules of the PyTorch/CUDA port.

* No file of ``src/repro_torch`` (nor ``chip_smoke.py``) imports ``jax`` or
  anything of the JAX package ``repro`` (an AST scan: the port keeps its own
  copies of what it needs).
* Entry points run on ``cuda`` unless told otherwise, and without a card
  they raise instead of carrying on on the CPU.
* A kernel wrapper given CPU tensors refuses (the CPU path is the plain
  version, taken by ``kernels.ops`` only for CPU tensors); importing the
  kernels builds nothing.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import paged_attention as pk
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels import tte_sample as tk
from repro_torch.launch import serve as launch
from repro_torch.models import (from_jax_flat, init_params, load_checkpoint,
                                to_flat_numpy)
from repro_torch.api import Client
from repro_torch.serve import BatchedEngine
from repro_torch.serve import server

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.relative_to(ROOT)} imports {mod}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_one(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    cfg = get_config("delphi-2m", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, seed=0)
    params = init_params(cfg, seed=0, device="cpu")
    flat = to_flat_numpy(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_flat(flat, cfg)
    np.savez(tmp_path / "params.npz", **flat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(str(tmp_path), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedEngine(params, cfg.replace(dtype="float32"), slots=2,
                      max_context=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.serve(launch.parse_args(["--requests", "1"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.serve(launch.parse_args(["--requests", "2", "--replicas",
                                        "2"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Client.serving(params, cfg.replace(dtype="float32"), slots=2,
                       max_context=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Client.from_params(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--config", "delphi-2m", "--reduced", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--config", "delphi-2m", "--reduced", "--port", "0",
                     "--replicas", "2"])


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tk.tte_sample_cuda(x, x)
    q = torch.zeros((1, 2, 4, 10))
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_cuda(q, q, q)
    pool = torch.zeros((2, 1, 4, 10))
    i32 = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pk.paged_decode_attention_cuda(
            torch.zeros((2, 1, 1, 10)), pool, pool, i32,
            torch.zeros((2, 4), dtype=torch.int32),
            torch.zeros((2,), dtype=torch.int32))
    x5 = torch.zeros((1, 1, 16, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_intra_cuda(x5, x5, x5, torch.zeros((1, 1, 16, 1)))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ops.reset_launch_counts()
    lg = torch.randn(3, 40)
    u = torch.rand(3, 40)
    ops.tte_sample(lg, u)
    q = torch.randn(1, 2, 8, 10)
    ops.flash_attention(q, q, q)
    x = torch.randn(1, 2, 16, 8)
    ops.ssd_intra(x, x, x, -torch.rand(1, 2, 16).cumsum(-1))
    assert ops.launch_counts() == {"tte_sample": 0, "flash_attention": 0,
                                   "paged_decode_attention": 0,
                                   "ssd_intra": 0}


def test_importing_the_port_builds_nothing():
    code = ("import repro_torch.serve, repro_torch.launch.serve\n"
            "import repro_torch.api, repro_torch.serve.server\n"
            "import repro_torch.serve.router\n"
            "from repro_torch.kernels import build\n"
            "assert build.library.cache_info().currsize == 0\n"
            "assert not build.last_build\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
    assert set(build.SOURCES) == {p.name for p in build.CSRC.glob("*.cu")}
    assert all((build.CSRC / h).exists() for h in build.HEADERS)
