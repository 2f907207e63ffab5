"""Privacy red-team audit harness of the port: rarity-scored canaries,
membership-inference and prompt-extraction probes, and the audit CLI
(``python -m repro_torch.privacy.audit``).

    from repro_torch.privacy import make_canaries, inject_canaries, run_audit

    canaries = make_canaries(8, sim_cfg, seed=1)
    train = inject_canaries(train, canaries, repeats=4)   # before training
    ...
    members, nonmembers = split_canaries(canaries)
    report = run_audit(backend, members, nonmembers)      # after serving
"""
from repro_torch.privacy.attacks import (bootstrap_auc_ci,
                                         event_log_likelihoods,
                                         extraction_probe, extraction_rate,
                                         membership_score, membership_scores,
                                         roc_auc)
from repro_torch.privacy.audit import PrivacyAuditReport, main, run_audit
from repro_torch.privacy.canary import (Canary, inject_canaries,
                                        make_canaries, rare_code_pool,
                                        split_canaries)

__all__ = [
    "Canary", "PrivacyAuditReport", "bootstrap_auc_ci",
    "event_log_likelihoods", "extraction_probe", "extraction_rate",
    "inject_canaries", "main", "make_canaries", "membership_score",
    "membership_scores", "rare_code_pool", "roc_auc", "run_audit",
    "split_canaries",
]
