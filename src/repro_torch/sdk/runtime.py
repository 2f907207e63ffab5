"""Artifact runtime of the port: the ONNX-Runtime analogue.

Loads an artifact directory written by ``repro_torch.sdk.export_model`` and
executes its ``torch.export`` graphs.  It imports no model code (nothing of
``repro_torch.models``, ``core``, ``configs``, ``train``, ``serve`` or
``api``): the graph semantics live in the serialized programs, the
parameters in ``params.npz`` and the metadata in ``manifest.json``.  What it
does import, besides PyTorch and numpy, is ``repro_torch.kernels.library``:
the graphs call its ``repro_torch::`` operators (the attention kernels and,
in Mamba2's and Zamba2's graphs, ``ssd_intra``), which must exist before
``torch.export.load`` resolves them.  On the card they launch the
hand-written CUDA kernels; on the CPU they run the plain versions.

Spec dispatch: v1 artifacts carry only the full-sequence graph (``run``);
v2 artifacts also expose ``prefill`` and ``decode_step``, whose cache (KV
rings, a recurrent state, or both) is a plain list of tensors threaded
through by the caller.  The decode graph updates the cache tensors in
place: the list ``decode_step`` returns holds the tensors it was given.

Graphs are traced on the CPU; at load each program moves to the runtime's
device (``move_to_device_pass``: its constants and the devices written into
its factory calls), and the parameters move there once.  An artifact of
another format (the JAX package's StableHLO) is refused by name.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

import repro_torch.kernels.library  # noqa: F401  (the graphs' operators)
from repro_torch import resolve_device
from repro_torch.sdk.manifest import INTERCHANGE, read_manifest


class Runtime:
    """Minimal execution provider: load → run.  No model code, no network.

    ``device`` is ``"cuda"`` unless the caller passes ``"cpu"``; without a
    card the default raises."""

    def __init__(self, artifact_dir: str, *, device="cuda"):
        self.dir = artifact_dir
        self.manifest = read_manifest(artifact_dir)
        fmt = self.manifest.get("interchange_format")
        if fmt != INTERCHANGE:
            raise ValueError(
                f"artifact {artifact_dir!r} is in interchange format "
                f"{fmt!r}; this runtime loads {INTERCHANGE!r} artifacts "
                f"(written by repro_torch.sdk.export_model).  Re-export the "
                f"parameters with it: params.npz is compatible")
        self.device = resolve_device(device)
        self.spec_version = str(self.manifest.get("spec_version", "1.0"))
        with np.load(os.path.join(artifact_dir, "params.npz")) as data:
            # one copy to the device at load: graph calls reuse it
            self._params = {k: torch.from_numpy(data[k]).to(self.device)
                            for k in data.files}

        self._calls: Dict[str, torch.nn.Module] = {}
        self._load_graph("full", "model.bin")
        graphs = self.manifest.get("graphs") or {}
        for name in ("prefill", "decode_step"):
            if name in graphs:
                self._load_graph(name, graphs[name]["file"])

    def _load_graph(self, name: str, fname: str) -> None:
        with open(os.path.join(self.dir, fname), "rb") as f:
            ep = torch.export.load(f)
        self._calls[name] = move_to_device_pass(ep, self.device).module()

    # -- introspection --------------------------------------------------------
    @property
    def input_signature(self) -> List[dict]:
        return self.manifest["signature"]["inputs"]

    @property
    def graphs(self) -> List[str]:
        return sorted(self._calls)

    @property
    def has_decode_graph(self) -> bool:
        return "decode_step" in self._calls

    # -- execution ------------------------------------------------------------
    def _tensors(self, inputs) -> List[torch.Tensor]:
        return [torch.from_numpy(np.array(x)).to(self.device)
                for x in inputs]

    @torch.no_grad()
    def run(self, *inputs) -> np.ndarray:
        """Execute the full graph: run(tokens[, ages]) -> logits (numpy)."""
        out = self._calls["full"](self._params, *self._tensors(inputs))
        return out.cpu().numpy()

    @torch.no_grad()
    def prefill(self, *inputs) -> Tuple[np.ndarray, List[torch.Tensor]]:
        """prefill(tokens[, ages], last_index) -> (logits (1, V), cache).

        ``cache`` is an opaque list of device tensors to thread into
        ``decode_step``; only spec-v2 artifacts ship this graph."""
        logits, cache = self._graph("prefill")(self._params,
                                               *self._tensors(inputs))
        return logits.cpu().numpy(), list(cache)

    @torch.no_grad()
    def decode_step(self, cache: Sequence[torch.Tensor], *inputs
                    ) -> Tuple[np.ndarray, List[torch.Tensor]]:
        """decode_step(cache, token[, age], step) -> (logits (1, V), cache).
        The cache tensors are updated in place and returned."""
        logits, cache = self._graph("decode_step")(
            self._params, list(cache), *self._tensors(inputs))
        return logits.cpu().numpy(), list(cache)

    def _graph(self, name: str):
        if name not in self._calls:
            raise ValueError(
                f"artifact {self.dir!r} (spec {self.spec_version}) does not "
                f"ship a {name!r} graph — re-export with spec v2 "
                f"(sdk.export_model) to enable KV-cached decoding")
        return self._calls[name]
