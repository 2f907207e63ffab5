"""FAIR portability layer of the port: export (the ONNX analogue, through
``torch.export``), runtime and the SDK session."""
from repro_torch.sdk.export import build_inference_fns, export_model, nest
from repro_torch.sdk.manifest import (SPEC_V1, SPEC_V2, SPEC_VERSION,
                                      ChecksumError, ChecksumReport,
                                      build_manifest, read_manifest,
                                      sha256_file, verify_checksums,
                                      write_manifest)
from repro_torch.sdk.runtime import Runtime
from repro_torch.sdk.session import InferenceSession

__all__ = ["build_inference_fns", "export_model", "nest",
           "SPEC_V1", "SPEC_V2", "SPEC_VERSION",
           "ChecksumError", "ChecksumReport",
           "build_manifest", "read_manifest", "sha256_file",
           "verify_checksums", "write_manifest", "Runtime",
           "InferenceSession"]
