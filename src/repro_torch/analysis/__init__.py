"""Entry-point checks of the port (ports ``repro.analysis``).

Contracts over the engine's entry points (launches per kernel, collectives,
precision; ``contracts``), checked against a census taken by running each
call (``census``), and the runtime :class:`RetraceGuard`, which proves
steady-state serving builds no kernel library.  ``python -m
repro_torch.launch.audit`` runs the backends x ranks x ticks-per-dispatch
matrix and writes ``analysis_report.json``.  ``lint`` holds the
reference's three repo rules over ``src/repro_torch``.

Not ported: ``jaxpr_audit.py`` (it reads jaxprs; ``census`` stands in),
and with it ``CondBranches``, ``PrimitiveUse`` and ``count_launches``.
"""
from repro_torch.analysis.census import Census, CollectiveUse, census_of
from repro_torch.analysis.contracts import (AuditReport, CollectiveRule,
                                            CompiledContract,
                                            ContractViolation, EntryAudit,
                                            Violation, audit_engine,
                                            audit_flash_prefill,
                                            engine_contracts,
                                            serve_collective_rule)
from repro_torch.analysis.retrace import (RetraceEvent, RetraceGuard,
                                          RetraceViolation,
                                          no_implicit_transfers)

__all__ = [
    "AuditReport", "Census", "CollectiveRule", "CollectiveUse",
    "CompiledContract", "ContractViolation", "EntryAudit", "RetraceEvent",
    "RetraceGuard", "RetraceViolation", "Violation",
    "audit_engine", "audit_flash_prefill",
    "census_of", "engine_contracts", "no_implicit_transfers",
    "serve_collective_rule",
]
