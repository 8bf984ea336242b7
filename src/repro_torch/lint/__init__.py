"""`repro_torch.lint`: domain-aware static analysis for the repo's
modelling planes, the port's own copy of the JAX package's linter.

Four rule families, each encoding an invariant the test suite can only
sample but the analyzer can check everywhere:

- **units** — the quantitative claims rest on byte/bandwidth/energy
  accounting that silently spans Gb/s, bytes/s, pJ and seconds; the
  family flags unit-mixing arithmetic, magic scale literals and
  call-boundary mixes that bypass `repro_torch.units` (aka
  `repro_torch.core.units`).
- **determinism** — the golden/differential harnesses require every
  simulation path to be a pure function of its config: no global RNG
  streams, no wall-clock reads outside the sanctioned timing surfaces,
  no set-iteration order leaking into ordered outputs.
- **trace** — observability hygiene: no bare `print` outside the
  logger, no `SimTrace` layer events left unplaced, no `recording()`
  without `with`.
- **config** — config dataclasses validate (or are registered as
  intentionally unvalidated), provenance fields carry
  ``compare=False``, and PEP 562 lazy re-export tables match the
  submodules they proxy.

Run ``python -m repro_torch.lint src/ --format=text|github``; suppress
a finding inline with ``# lint: disable=<rule>`` plus a justification
comment.  The checked-in baseline (`lint_baseline.txt`) must stay
empty — it exists so the *mechanism* for grandfathering is exercised,
not so findings accumulate.

This package is pure stdlib on purpose: CI lints without installing
numpy, torch or jax, and `repro_torch.lint` can never import the code it
judges.  Its rules and its registry's data are the JAX package's, entry
for entry, so both linters judge any tree the same way; only the
messages name the port's modules.
"""

from .base import (Finding, LintReport, ModuleContext, Rule,
                   iter_py_files, load_baseline, run_rules,
                   write_baseline)
from .rules_config import RULES as _CONFIG_RULES
from .rules_determinism import RULES as _DETERMINISM_RULES
from .rules_trace import RULES as _TRACE_RULES
from .rules_units import RULES as _UNITS_RULES

#: every rule, in family order (stable: CLI/report ordering)
ALL_RULES = (_UNITS_RULES + _DETERMINISM_RULES + _TRACE_RULES
             + _CONFIG_RULES)

#: family names accepted by ``--select``
FAMILIES = tuple(dict.fromkeys(r.family for r in ALL_RULES))

__all__ = [
    "ALL_RULES", "FAMILIES", "Finding", "LintReport", "ModuleContext",
    "Rule", "iter_py_files", "load_baseline", "run_rules",
    "write_baseline",
]
