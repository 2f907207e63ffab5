"""Red-team privacy audit: canaries + attacks -> PrivacyAuditReport (the
JAX package's ``privacy/audit.py`` over the port's backends).

``run_audit`` scores a trained-in vs held-out canary split against any
inference backend and emits a machine-readable report: membership-
inference ROC-AUC (with bootstrap CI) and prompt-extraction leakage
rates.  The CLI runs the same audit against a served checkpoint over the
HTTP wire — the threat model a FAIR, privacy-preserving deployment must
answer for — so the federated path and future DP noise have a measurable
privacy axis next to the perf axis:

    python -m repro_torch.serve.server --config delphi-2m --ckpt DIR \
        --cache paged --port 8433 &
    python -m repro_torch.privacy.audit --url http://127.0.0.1:8433 \
        --canaries 8 --out audit.json

The report's JSON is the JAX package's (``PrivacyAuditReport.from_json``
of either package reads the other's).

Reading the numbers: ``mi_auc`` ~ 0.5 = the model cannot tell members
from held-out twins (good); -> 1.0 = per-record re-identification from
API access alone.  ``extraction_gap`` = member minus non-member leakage
rate; > 0 means the model regurgitates planted secrets it trained on.
The audit assumes the server was trained with ``inject_canaries`` over
the SAME canary spec (simulator seed / audit seed / counts) — canaries
regenerate deterministically on both sides, nothing is shipped.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional, Tuple

from repro_torch.api.schemas import WIRE_PROTOCOL_VERSION
from repro_torch.data.synthetic import SimulatorConfig
from repro_torch.privacy.attacks import (bootstrap_auc_ci, extraction_rate,
                                         membership_scores, roc_auc)
from repro_torch.privacy.canary import Canary, make_canaries, split_canaries


@dataclasses.dataclass
class PrivacyAuditReport:
    """Machine-readable audit outcome (JSON round-trips)."""
    backend: str
    n_members: int
    n_nonmembers: int
    mi_auc: float
    mi_auc_ci: Tuple[float, float]
    member_scores: List[float]
    nonmember_scores: List[float]
    member_extraction_rate: float
    nonmember_extraction_rate: float
    config: dict = dataclasses.field(default_factory=dict)

    @property
    def extraction_gap(self) -> float:
        return self.member_extraction_rate - self.nonmember_extraction_rate

    def to_json(self) -> dict:
        return {
            "protocol_version": WIRE_PROTOCOL_VERSION,
            "backend": self.backend,
            "n_members": int(self.n_members),
            "n_nonmembers": int(self.n_nonmembers),
            "mi_auc": float(self.mi_auc),
            "mi_auc_ci": [float(self.mi_auc_ci[0]),
                          float(self.mi_auc_ci[1])],
            "member_scores": [float(s) for s in self.member_scores],
            "nonmember_scores": [float(s) for s in self.nonmember_scores],
            "member_extraction_rate": float(self.member_extraction_rate),
            "nonmember_extraction_rate":
                float(self.nonmember_extraction_rate),
            "extraction_gap": float(self.extraction_gap),
            "config": self.config,
        }

    @classmethod
    def from_json(cls, d: dict) -> "PrivacyAuditReport":
        return cls(backend=str(d.get("backend", "")),
                   n_members=int(d["n_members"]),
                   n_nonmembers=int(d["n_nonmembers"]),
                   mi_auc=float(d["mi_auc"]),
                   mi_auc_ci=(float(d["mi_auc_ci"][0]),
                              float(d["mi_auc_ci"][1])),
                   member_scores=[float(s) for s in d["member_scores"]],
                   nonmember_scores=[float(s)
                                     for s in d["nonmember_scores"]],
                   member_extraction_rate=float(
                       d["member_extraction_rate"]),
                   nonmember_extraction_rate=float(
                       d["nonmember_extraction_rate"]),
                   config=dict(d.get("config") or {}))


def run_audit(backend, members: List[Canary], nonmembers: List[Canary], *,
              n_futures: int = 8, max_new: int = 16, match: int = 2,
              n_boot: int = 200, seed: int = 0,
              secret_only: bool = True) -> PrivacyAuditReport:
    """Score both canary groups through the backend's public surface and
    aggregate into a :class:`PrivacyAuditReport`."""
    m_scores = membership_scores(backend, members, secret_only=secret_only)
    n_scores = membership_scores(backend, nonmembers,
                                 secret_only=secret_only)
    auc = roc_auc(m_scores, n_scores)
    ci = bootstrap_auc_ci(m_scores, n_scores, n_boot=n_boot, seed=seed)
    m_rate, _ = extraction_rate(backend, members, n_futures=n_futures,
                                max_new=max_new, match=match, seed=seed)
    n_rate, _ = extraction_rate(backend, nonmembers, n_futures=n_futures,
                                max_new=max_new, match=match, seed=seed)
    return PrivacyAuditReport(
        backend=getattr(backend, "name", ""),
        n_members=len(members), n_nonmembers=len(nonmembers),
        mi_auc=auc, mi_auc_ci=ci,
        member_scores=[float(s) for s in m_scores],
        nonmember_scores=[float(s) for s in n_scores],
        member_extraction_rate=m_rate,
        nonmember_extraction_rate=n_rate,
        config={"n_futures": n_futures, "max_new": max_new,
                "match": match, "n_boot": n_boot, "seed": seed,
                "secret_only": secret_only})


PROG = "repro-torch-audit"


def _build_backend(args):
    from repro_torch.api.client import Client
    if args.artifact:
        raise SystemExit(
            f"{PROG}: --artifact is not ported yet: auditing an exported "
            f"artifact needs the port of the SDK runtime (ROADMAP queue A, "
            f"item 8); serve the checkpoint and pass --url instead")
    if args.url:
        return Client.connect(args.url).backend
    raise SystemExit(f"{PROG}: pass --url (served checkpoint)")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Membership-inference + prompt-extraction audit of a "
                    "served checkpoint, over the public inference API.")
    p.add_argument("--url", help="server base URL (http://host:port)")
    p.add_argument("--artifact", help="exported artifact directory (not "
                                      "ported yet: refused)")
    p.add_argument("--canaries", type=int, default=8,
                   help="total canaries (even=member, odd=held-out)")
    p.add_argument("--secret-len", type=int, default=4)
    p.add_argument("--prefix-events", type=int, default=8)
    p.add_argument("--sim-seed", type=int, default=0,
                   help="SimulatorConfig seed the canaries derive from "
                        "(must match the training side)")
    p.add_argument("--seed", type=int, default=0,
                   help="audit seed (canary streams + attack draws)")
    p.add_argument("--n-futures", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--match", type=int, default=2,
                   help="secret codes one future must emit to count as "
                        "leaked")
    p.add_argument("--n-boot", type=int, default=200)
    p.add_argument("--out", help="write the report JSON here "
                                 "(default: stdout)")
    args = p.parse_args(argv)

    backend = _build_backend(args)
    canaries = make_canaries(args.canaries,
                             SimulatorConfig(seed=args.sim_seed),
                             seed=args.seed, secret_len=args.secret_len,
                             prefix_events=args.prefix_events)
    members, nonmembers = split_canaries(canaries)
    report = run_audit(backend, members, nonmembers,
                       n_futures=args.n_futures, max_new=args.max_new,
                       match=args.match, n_boot=args.n_boot,
                       seed=args.seed)
    payload = json.dumps(report.to_json(), indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    else:
        print(payload)
    print(f"{PROG}: MI AUC {report.mi_auc:.3f} "
          f"[{report.mi_auc_ci[0]:.3f}, {report.mi_auc_ci[1]:.3f}] | "
          f"extraction member {report.member_extraction_rate:.2f} vs "
          f"held-out {report.nonmember_extraction_rate:.2f} "
          f"(gap {report.extraction_gap:+.2f})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
