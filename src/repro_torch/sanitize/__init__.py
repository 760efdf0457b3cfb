"""repro_torch.sanitize — the port's runtime sanitizer (sync guards and
compile budgets), from ``repro/sanitize``.  See ``harness`` for the
contract."""
from .harness import (CompileBudgetExceeded, clear_sync_log, compile_budget,
                      compile_counts, sanctioned_scope, sanctioned_sync,
                      sanitize_enabled, sanitized, sync_log)

__all__ = [
    "sanitize_enabled", "sanitized", "sanctioned_scope", "sanctioned_sync",
    "sync_log", "clear_sync_log", "compile_counts", "compile_budget",
    "CompileBudgetExceeded",
]
