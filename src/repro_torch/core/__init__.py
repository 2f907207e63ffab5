"""Eq.-1 sampling and trajectory state of the port, the risk and
calibration layers on top of them, and the Delphi training objective."""
from repro_torch.core import losses
from repro_torch.core.calibration import (calibration_report, cohort_stats,
                                          generate_cohort)
from repro_torch.core.risk import (analytic_next_event_risk,
                                   analytic_next_event_risk_np,
                                   disease_chapter_map,
                                   disease_chapter_map_np,
                                   engine_oracle_trajectories,
                                   futures_chapter_risk, futures_risk_items,
                                   monte_carlo_risk, next_event_risk,
                                   pack_futures_trajectories)
from repro_torch.core.delphi import get_logits, init_delphi, loss_fn
from repro_torch.core.losses import dual_loss, event_ce, joint_nll, time_nll
from repro_torch.core.sampler import (advance_trajectory_state,
                                      generate_trajectories,
                                      sample_next_event,
                                      sample_next_event_np,
                                      sample_waiting_times)

__all__ = ["advance_trajectory_state", "analytic_next_event_risk",
           "analytic_next_event_risk_np", "calibration_report",
           "cohort_stats", "disease_chapter_map", "disease_chapter_map_np",
           "dual_loss", "event_ce", "get_logits", "init_delphi",
           "joint_nll", "loss_fn", "losses", "time_nll",
           "engine_oracle_trajectories", "futures_chapter_risk",
           "futures_risk_items", "generate_cohort", "generate_trajectories",
           "monte_carlo_risk", "next_event_risk",
           "pack_futures_trajectories", "sample_next_event",
           "sample_next_event_np", "sample_waiting_times"]
