"""The dense and MoE LMs' sharded step counted at full width on the
production mesh (``launch.dryrun.count_step`` over a fake 16 x 16 process
group, meta DTensors), at the four input shapes, the MoE LMs under both
dense dispatches: TinyLlama-1.1B, H2O-Danube-1.8B, Qwen2.5-32B,
DeepSeek-7B, OLMoE-1B-7B and Qwen2-MoE-A2.7B at their published widths
(so the published layouts), depth cut to 2 layers, ``remat`` off (it
recomputes the same forward: ``tests/test_torch_collectives.py``).  In a
file of its own so that xdist runs it beside the other sharded tests.
"""
import pytest

from repro_torch.configs import INPUT_SHAPES, get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.specs import long_context_cfg

COVERED = [("tinyllama-1.1b", "dense_scan"), ("h2o-danube-1.8b", "dense_scan"),
           ("qwen2.5-32b", "dense_scan"), ("deepseek-7b", "dense_scan"),
           ("olmoe-1b-7b", "dense_scan"), ("olmoe-1b-7b", "dense_einsum"),
           ("qwen2-moe-a2.7b", "dense_scan"),
           ("qwen2-moe-a2.7b", "dense_einsum")]


@pytest.mark.parametrize("shape", [s.name for s in INPUT_SHAPES])
@pytest.mark.parametrize("arch,impl", COVERED)
def test_dense_and_moe_count_at_full_width_on_16x16(arch, impl, shape):
    """The sharded step runs on meta DTensors, makes nothing off the meta
    device, and sends collectives (every one of these layouts splits
    something the step must combine).  A prefill ends the embedding and
    each layer's split products in all-reduces of the device's B/16 rows,
    S long, d wide, in bf16 (attention's only where the query heads divide
    the axis), besides the MoE routers' two E-wide fp32 sums a layer."""
    shp = get_shape(shape)
    cfg = long_context_cfg(get_config(arch).replace(n_layers=2), shp)
    c = dryrun.count_step(cfg, shp, dryrun.make_production_mesh(), impl)
    assert c["off_meta_bytes"] == 0
    assert c["flops"] > 0 and c["bytes"] > 0
    assert sum(c["collectives"].values()) > 0
    if shp.mode == "prefill":
        rows = shp.global_batch // 16 * shp.seq_len * cfg.d_model * 2
        per_layer = 1 + (cfg.n_heads % 16 == 0)
        router = 2 * cfg.n_experts * 4 if cfg.n_experts else 0
        assert c["collectives"] == {"all-reduce": rows * (
            1 + per_layer * 2) + router * 2}
