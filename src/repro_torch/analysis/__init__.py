"""Entry-point checks of the port (ports ``repro.analysis``).

Contracts over the engine's entry points (launches per kernel, collectives,
precision; ``contracts``), checked against a census taken by running each
call (``census``), and the runtime :class:`RetraceGuard`, which proves
steady-state serving builds no kernel library.  ``python -m
repro_torch.launch.audit`` runs the backends x ranks x ticks-per-dispatch
matrix and writes ``analysis_report.json``.  ``lint`` holds the
reference's three repo rules over ``src/repro_torch``.  ``audit_train_step``
holds the train step (no kernel, no fp64; no collective on one card, and
under a mesh only those of ``train_collective_rule``).

Not ported: ``jaxpr_audit.py`` (it reads jaxprs; ``census`` stands in),
and with it ``CondBranches``, ``PrimitiveUse`` and ``count_launches``.
"""
from repro_torch.analysis.census import Census, CollectiveUse, census_of
from repro_torch.analysis.contracts import (AuditReport, CollectiveRule,
                                            CompiledContract,
                                            ContractViolation, EntryAudit,
                                            Violation, audit_engine,
                                            audit_flash_prefill,
                                            audit_train_step,
                                            engine_contracts,
                                            serve_collective_rule,
                                            train_collective_rule)
from repro_torch.analysis.retrace import (RetraceEvent, RetraceGuard,
                                          RetraceViolation,
                                          assert_no_steady_retraces,
                                          no_implicit_transfers)

__all__ = [
    "AuditReport", "Census", "CollectiveRule", "CollectiveUse",
    "CompiledContract", "ContractViolation", "EntryAudit", "RetraceEvent",
    "RetraceGuard", "RetraceViolation", "Violation",
    "assert_no_steady_retraces", "audit_engine", "audit_flash_prefill",
    "audit_train_step",
    "census_of", "engine_contracts", "no_implicit_transfers",
    "serve_collective_rule", "train_collective_rule",
]
