"""The port's weight bridge against the JAX package's parameters.

Every key and shape of the JAX ``init_params`` pytree, flattened as
``train/checkpoint.py`` writes it, round-trips exactly (tolerance 0: the
bridge only copies fp32 arrays); the port's own seeded ``init_params`` has
the same keys, shapes and scales.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.models import param_count as jax_param_count
from repro.train import checkpoint as jax_checkpoint
from repro_torch.configs import get_config
from repro_torch.models import (from_jax_flat, init_params, load_checkpoint,
                                param_count, to_flat_numpy)

torch.set_num_threads(2)

CONFIGS = [pytest.param(False, id="delphi-2m"),
           pytest.param(True, id="delphi-2m-reduced")]


@functools.lru_cache(maxsize=None)
def _jax_flat(reduced: bool):
    """The JAX package's flat parameters: its ``init_params`` itself for the
    reduced variant; for the full width (whose eager init takes seconds on
    the CPU) the pytree of ``jax.eval_shape(init_params)`` filled with
    seeded values, so keys, nesting and shapes are the JAX package's."""
    cfg = jax_config("delphi-2m", reduced=reduced)
    key = jax.random.PRNGKey(0)
    if reduced:
        params = jax_init_params(cfg, key)
    else:
        rng = np.random.default_rng(0)
        params = jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32),
            jax.eval_shape(functools.partial(jax_init_params, cfg), key))
    return jax_checkpoint._flatten(params), jax_param_count(params)


@pytest.mark.parametrize("reduced", CONFIGS)
def test_bridge_round_trips_jax_params(reduced):
    flat, n = _jax_flat(reduced)
    cfg = get_config("delphi-2m", reduced=reduced)
    params = from_jax_flat(flat, cfg, device="cpu")
    assert set(params) == set(flat)
    for key, arr in flat.items():
        assert tuple(params[key].shape) == arr.shape, key
        assert params[key].dtype == torch.float32
        np.testing.assert_array_equal(params[key].numpy(), arr, err_msg=key)
    back = to_flat_numpy(params)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    assert param_count(params) == n
    if not reduced:
        assert n == 2_242_769           # Delphi-2M's published size


@pytest.mark.parametrize("reduced", CONFIGS)
def test_port_init_params_matches_jax_layout(reduced):
    flat, n = _jax_flat(reduced)
    cfg = get_config("delphi-2m", reduced=reduced)
    params = init_params(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in flat.items()}
    assert param_count(params) == n
    # the same scales as models/model.py's initializers (loose: sampling)
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    for key, want in [("layers/attn/wq", d ** -0.5),
                      ("layers/attn/wo", (cfg.n_heads * hd) ** -0.5),
                      ("layers/mlp/w_proj", ff ** -0.5),
                      ("embed/embed", 0.02)]:
        std = float(params[key].std())
        assert abs(std - want) < 0.05 * want, (key, std, want)
        if reduced:                      # flat holds JAX's own init here
            assert abs(std - float(np.std(flat[key]))) < 0.05 * want
    if reduced:
        for key in ("embed/out_bias", "layers/attn_norm/scale",
                    "layers/mlp_norm/bias", "layers/mlp/b_fc"):
            np.testing.assert_array_equal(params[key].numpy(), flat[key])
    # seeded from numpy: the same seed gives the same weights
    again = init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_load_checkpoint_reads_jax_save(tmp_path):
    flat, _ = _jax_flat(True)
    jax_checkpoint.save(str(tmp_path), flat,
                        jax_config("delphi-2m", reduced=True))
    params = load_checkpoint(str(tmp_path),
                             get_config("delphi-2m", reduced=True),
                             device="cpu")
    for key, arr in flat.items():
        np.testing.assert_array_equal(params[key].numpy(), arr, err_msg=key)


def test_from_jax_flat_rejects_wrong_keys_and_shapes():
    flat, _ = _jax_flat(True)
    cfg = get_config("delphi-2m", reduced=True)
    missing = dict(flat)
    missing.pop("layers/mlp/b_fc")
    with pytest.raises(ValueError, match="missing"):
        from_jax_flat(missing, cfg, device="cpu")
    extra = dict(flat, **{"layers/attn/bq": np.zeros((2, 4, 64), np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_flat(extra, cfg, device="cpu")
    bad = dict(flat, **{"embed/embed": flat["embed/embed"][:-1]})
    with pytest.raises(ValueError, match="shape"):
        from_jax_flat(bad, cfg, device="cpu")
