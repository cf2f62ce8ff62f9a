"""replaylint: AST-based determinism & cross-plane contract checker.

The port of ``repro.analysis``; it lints the port's core by default, and its
RS002 also flags torch's global RNG (draws without ``generator=``,
``torch.manual_seed``).

The differential-replay harness (repro_torch.core.replay) proves *dynamically*
that the simulator and the live plane agree; this package proves the
preconditions *statically*: no wall-clock reads, no unseeded RNGs, no
hash-order iteration, no expiry-index bypasses, and symmetric cost charges
across the two planes.  Run it as::

    python -m repro_torch.analysis src/repro_torch/core

See docs/ARCHITECTURE.md ("Determinism contract") for the rule catalog and
the suppression idiom.
"""

from .framework import (  # noqa: F401
    AnalysisResult,
    Finding,
    Module,
    Rule,
    UsageError,
    run_analysis,
)
from .rules import RULE_CLASSES, make_rules  # noqa: F401
