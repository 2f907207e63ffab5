"""Eq.-1 sampling and trajectory state of the port."""
from repro_torch.core.sampler import (advance_trajectory_state,
                                      generate_trajectories,
                                      sample_next_event,
                                      sample_waiting_times)

__all__ = ["advance_trajectory_state", "generate_trajectories",
           "sample_next_event", "sample_waiting_times"]
