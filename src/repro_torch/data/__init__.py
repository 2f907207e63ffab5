"""Data substrate of the port: the event vocabulary and the synthetic
disease-history simulator (numpy only)."""
from repro_torch.data.synthetic import SimulatorConfig, generate_dataset

__all__ = ["SimulatorConfig", "generate_dataset"]
