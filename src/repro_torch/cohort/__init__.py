"""Cohort-scale scenario engine of the port: population risk sweeps,
counterfactual "what if" queries, and the straight-line parity oracle that
gates both.

    from repro_torch.cohort import ScenarioEngine, CounterfactualEdit

    se = ScenarioEngine(backend, max_in_flight=8, seed=0)
    result = se.sweep(patients, n_futures=16, horizon=5.0)
    reports = se.counterfactual(tokens, ages,
                                [CounterfactualEdit("remove", code)])
"""
from repro_torch.cohort.counterfactual import (CounterfactualEdit,
                                               CounterfactualReport,
                                               apply_edit, diff_futures)
from repro_torch.cohort.engine import ScenarioEngine, sweep_uniforms
from repro_torch.cohort.oracle import (assert_sweep_parity,
                                       oracle_patient_futures)
from repro_torch.cohort.schemas import CohortSweepResult, PatientResult

__all__ = [
    "CohortSweepResult", "CounterfactualEdit", "CounterfactualReport",
    "PatientResult", "ScenarioEngine", "apply_edit", "assert_sweep_parity",
    "diff_futures", "oracle_patient_futures", "sweep_uniforms",
]
