"""The port's models in PyTorch: the weight bridge, layers, ring- and
paged-cache attention, the Mamba2 block and the model entry points (dense,
Mamba2 and the Mamba2/attention hybrid)."""
from repro_torch.models.attention import LayerCache, PagedCache
from repro_torch.models.model import (cast_params, decode_step, forward,
                                      forward_suffix, make_decode_cache,
                                      make_paged_decode_cache,
                                      mask_padded_positions, n_attn_apps,
                                      param_count, ring_width)
from repro_torch.models.params import (from_jax_flat, init_params,
                                       load_checkpoint, to_flat_numpy)

__all__ = ["LayerCache", "PagedCache", "cast_params", "decode_step",
           "forward", "forward_suffix", "from_jax_flat", "init_params",
           "load_checkpoint", "make_decode_cache", "make_paged_decode_cache",
           "mask_padded_positions", "n_attn_apps", "param_count",
           "ring_width", "to_flat_numpy"]
