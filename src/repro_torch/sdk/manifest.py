"""FAIR manifest for exported model artifacts.

The paper's FAIR claim rests on the exported artifact being Findable (stable
identifiers + checksums), Accessible (self-contained directory, no framework
needed beyond PyTorch), Interoperable (an open interchange format:
``torch.export`` archives here, StableHLO in the JAX package, ONNX in the
paper), and Reusable (documented signature, provenance, license, and the
sampling semantics needed to *use* the logits).  This module materializes
those fields as ``manifest.json``.

Spec versions
-------------
* **v1** (``1.0``) — one fixed-shape full-sequence graph (``model.bin``).
* **v2** (``2.0``) — additionally ships a ``prefill`` graph and a KV-cached
  ``decode_step`` graph (cache arrays as explicit graph I/O, the way browser
  ONNX deployments ship decode graphs), described under the ``graphs`` key.
``sdk.runtime.Runtime`` dispatches on ``spec_version``; v1 artifacts keep
loading unchanged.

The fields, identifiers and blocks are the JAX package's
(``repro/sdk/manifest.py``); ``interchange_format`` and ``requires`` name
this package's format.  The two packages' graphs are not interchangeable
(the weight files are: both write the flat ``/``-keyed ``params.npz``),
and this package's runtime refuses an artifact of another format.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:               # the runtime reads manifests without configs
    from repro_torch.configs.base import ModelConfig

SPEC_V1 = "1.0"
SPEC_V2 = "2.0"
SPEC_VERSION = SPEC_V2
INTERCHANGE = "torch.export"   # the ONNX analogue


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def build_manifest(cfg: "ModelConfig", artifact_dir: str, *,
                   signature: Dict[str, Any],
                   spec_version: str = SPEC_VERSION,
                   graphs: Optional[Dict[str, Any]] = None,
                   provenance: str = "Duarte et al. 2026; Shmatko et al. 2025 "
                                     "(Delphi-2M); trained on synthetic data",
                   license_id: str = "Apache-2.0") -> Dict[str, Any]:
    files = {}
    for name in sorted(os.listdir(artifact_dir)):
        if name == "manifest.json":
            continue
        files[name] = sha256_file(os.path.join(artifact_dir, name))
    m = {
        "spec_version": spec_version,
        # F — findability
        "name": cfg.name,
        "identifier": f"repro/{cfg.name}@{files.get('model.bin', 'unhashed')[:23]}",
        "description": "Generative disease-history model (event + "
                       "time-to-event logits).",
        # A — accessibility
        "files": files,
        "requires": ["PyTorch with torch.export (the graphs are "
                     "torch.export.save archives)",
                     "repro_torch.kernels.library (the repro_torch:: "
                     "attention operators the graphs call: the CUDA kernels "
                     "on the card, their plain versions on the CPU)",
                     "numpy (host-side pre/post-processing only)"],
        # I — interoperability
        "interchange_format": INTERCHANGE,
        "signature": signature,
        # R — reusability
        "provenance": provenance,
        "license": license_id,
        "config": dataclasses.asdict(cfg),
        "sampling": {
            "method": "competing-exponential time-to-event (paper eq. 1)",
            "formula": "t_i = -exp(-logit_i) * ln(u_i); next = argmin_i t_i",
            "termination": {"death_token": cfg.death_token,
                            "max_age_years": cfg.max_age},
        },
        "privacy": "inference requires only this artifact; no network calls, "
                   "no server-side state (paper claim C5)",
    }
    if graphs is not None:
        m["graphs"] = graphs
    return m


def write_manifest(manifest: Dict[str, Any], artifact_dir: str) -> str:
    path = os.path.join(artifact_dir, "manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    return path


def read_manifest(artifact_dir: str) -> Dict[str, Any]:
    with open(os.path.join(artifact_dir, "manifest.json")) as f:
        return json.load(f)


class ChecksumError(ValueError):
    """A manifest-listed file is missing or fails its checksum."""


OK, MISMATCH, MISSING = "ok", "mismatch", "missing"


@dataclasses.dataclass
class ChecksumReport:
    """Per-file integrity verdict for one artifact directory.

    ``files`` maps each manifest-listed file name to "ok" / "mismatch" /
    "missing".  Truthy exactly when every file is "ok", so existing
    ``assert verify_checksums(d)`` call sites keep working.
    """
    artifact_dir: str
    files: Dict[str, str]

    @property
    def ok(self) -> bool:
        return all(v == OK for v in self.files.values())

    @property
    def bad_files(self) -> Dict[str, str]:
        return {k: v for k, v in self.files.items() if v != OK}

    def __bool__(self) -> bool:
        return self.ok

    def __str__(self) -> str:
        if self.ok:
            return f"all {len(self.files)} files verified"
        bad = ", ".join(f"{k}: {v}" for k, v in sorted(self.bad_files.items()))
        return f"integrity failure ({bad})"


def verify_checksums(artifact_dir: str, *, strict: bool = False
                     ) -> ChecksumReport:
    """Verify every manifest-listed file, returning a structured report.

    A missing file is reported as "missing" (not raised), a digest mismatch
    as "mismatch".  With ``strict=True`` any non-ok file raises
    :class:`ChecksumError` naming the offending file(s).
    """
    m = read_manifest(artifact_dir)
    report: Dict[str, str] = {}
    for name, digest in m["files"].items():
        path = os.path.join(artifact_dir, name)
        if not os.path.isfile(path):
            report[name] = MISSING
        elif sha256_file(path) != digest:
            report[name] = MISMATCH
        else:
            report[name] = OK
    rep = ChecksumReport(artifact_dir=artifact_dir, files=report)
    if strict and not rep.ok:
        raise ChecksumError(
            f"artifact {artifact_dir!r} failed verification: {rep}")
    return rep
