"""Data substrate of the port: the event vocabulary, the synthetic
disease-history simulator and the batching pipeline (numpy only)."""
from repro_torch.data.pipeline import (batches, dataset_stats, lm_batch,
                                       pack_trajectories)
from repro_torch.data.synthetic import (SimulatorConfig, cohort,
                                        generate_dataset, hazard_params,
                                        patient, simulate_patient)

__all__ = ["SimulatorConfig", "batches", "cohort", "dataset_stats",
           "generate_dataset", "hazard_params", "lm_batch",
           "pack_trajectories", "patient", "simulate_patient"]
