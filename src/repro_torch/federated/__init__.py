"""Federated fine-tuning of the port (FedAvg over client deltas)."""
from repro_torch.federated.fedavg import (FedConfig, aggregate,
                                          federated_finetune,
                                          make_local_update)

__all__ = ["FedConfig", "aggregate", "federated_finetune",
           "make_local_update"]
