"""The port's user-facing surface on the CPU: the console scripts, the two
``ModelConfig`` helpers against the reference's, and the paged-parity and
router round trips.

* Each ``repro-torch-*`` entry of ``pyproject.toml [project.scripts]``
  resolves to an importable callable.
* ``is_attention_free`` and ``with_sliding_window`` equal the JAX
  package's on every architecture, and the long_500k policy
  (``launch.specs.long_context_cfg``) gives each the reference's window.
* ``scripts/torch_paged_parity.py`` and ``scripts/torch_router_roundtrip.py``
  return 0 with ``--device cpu`` (reduced Delphi-2M, fp32).
"""
import importlib
import importlib.util
import pathlib
import tomllib

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import get_shape as jax_shape
from repro.launch import specs as jax_specs
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import get_shape
from repro_torch.launch import specs

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_SCRIPTS = {"repro-torch-serve": "repro_torch.serve.server:main",
                "repro-torch-audit": "repro_torch.privacy.audit:main"}


def _scripts():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_pyproject_names_the_ports_console_scripts():
    got = {k: v for k, v in _scripts().items() if k.startswith("repro-torch")}
    assert got == PORT_SCRIPTS


@pytest.mark.parametrize("name", sorted(PORT_SCRIPTS))
def test_console_script_resolves_to_a_callable(name):
    module, attr = _scripts()[name].split(":")
    fn = getattr(importlib.import_module(module), attr)
    assert callable(fn)
    with pytest.raises(SystemExit) as e:      # argparse's --help exits 0
        fn(["--help"])
    assert e.value.code == 0


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_helpers_equal_the_references(arch, reduced):
    mine = get_config(arch, reduced=reduced)
    ref = jax_config(arch, reduced=reduced)
    assert mine.is_attention_free == ref.is_attention_free
    for w in (64, 8192):
        a, b = mine.with_sliding_window(w), ref.with_sliding_window(w)
        assert a.sliding_window == b.sliding_window == w
        assert a.replace(sliding_window=None) == \
            mine.replace(sliding_window=None)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_long_context_policy_equals_the_references(arch):
    for shape in ("long_500k", "decode_32k"):
        got = specs.long_context_cfg(get_config(arch), get_shape(shape))
        want = jax_specs.long_context_cfg(jax_config(arch), jax_shape(shape))
        assert got.sliding_window == want.sliding_window, shape


def _script(name):
    path = ROOT / "scripts" / name
    spec = importlib.util.spec_from_file_location("_s_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["torch_paged_parity.py",
                                  "torch_router_roundtrip.py"])
def test_round_trip_passes_on_the_cpu(name, capsys):
    assert _script(name).main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all checks passed on cpu" in out or "OK torch router" in out
