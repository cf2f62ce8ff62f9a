"""The replaylint rule set (RS001-RS006).

Each rule encodes one way a PR can silently break the differential-replay
contract (docs/ARCHITECTURE.md, "Determinism contract"): the 67 golden
fixtures under tests/golden/replay/ assert that the simulator and the live
plane produce bit-identical decisions and dollars (SkyStore §3.2/§5), and
that only holds while the code both planes consume is deterministic.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Sequence, Tuple

from .astutil import (
    ImportMap,
    class_property_names,
    iter_iteration_sites,
    set_likeness,
)
from .framework import Finding, Module, Rule

# ---------------------------------------------------------------------------
# RS001 -- wall-clock reads


class WallClockRule(Rule):
    """Virtual time must be *injected*; reading the host clock inside the
    storage core makes replay output depend on when the test ran.  The one
    sanctioned default lives at the VirtualStore boundary and carries an
    inline suppression."""

    code = "RS001"
    name = "wall-clock-read"
    rationale = (
        "time.time()/datetime.now() inside the storage core breaks replay: "
        "both planes must take time from the event spine (op.at / injected "
        "clock), never from the host."
    )

    #: ``time.perf_counter`` is deliberately absent: it is a measurement
    #: instrument (throughput reporting), not a decision input.
    BANNED = {
        "time.time",
        "time.time_ns",
        "time.monotonic",
        "time.monotonic_ns",
        "time.localtime",
        "time.gmtime",
        "datetime.datetime.now",
        "datetime.datetime.utcnow",
        "datetime.datetime.today",
        "datetime.date.today",
    }

    def check_module(self, module: Module) -> Iterator[Finding]:
        imports = ImportMap(module.tree)
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.Attribute, ast.Name)):
                continue
            if isinstance(node, ast.Name) and node.id in imports.names:
                qual = imports.names[node.id]
            else:
                qual = imports.qualname(node)
            if qual in self.BANNED:
                yield self.finding(
                    module,
                    node,
                    f"wall-clock read `{qual}`: inject the plane clock "
                    "(op.at / clock=) instead of defaulting to host time",
                )


# ---------------------------------------------------------------------------
# RS002 -- unseeded RNG construction


class UnseededRngRule(Rule):
    code = "RS002"
    name = "unseeded-rng"
    rationale = (
        "an RNG constructed without an explicit seed (or drawn from the "
        "process-global state) makes workload generation unreproducible; "
        "every generator derives from a named, seeded rng."
    )

    SEEDED_CTORS = {
        "numpy.random.default_rng",
        "numpy.random.RandomState",
        "random.Random",
    }
    #: numpy.random attributes that are constructors/utilities, not draws
    #: from the legacy global state.
    NUMPY_OK = {
        "default_rng", "Generator", "RandomState", "SeedSequence",
        "PCG64", "Philox", "MT19937", "BitGenerator",
    }
    #: torch's draws (``torch.rand*``, ``randn*``, ``randint*``,
    #: ``randperm``): without ``generator=`` they read the global generator.
    TORCH_DRAW_PREFIX = "torch.rand"
    #: Seeding torch's global generator, which every unnamed draw shares.
    TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.random.manual_seed"}

    def check_module(self, module: Module) -> Iterator[Finding]:
        imports = ImportMap(module.tree)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qual = imports.qualname(node.func)
            if qual is None:
                continue
            if qual in self.SEEDED_CTORS and not node.args and not node.keywords:
                yield self.finding(
                    module, node,
                    f"`{qual}()` without a seed: pass an explicit seed so "
                    "workloads replay bit-identically",
                )
            elif qual.startswith("numpy.random.") and \
                    qual.rsplit(".", 1)[1] not in self.NUMPY_OK:
                yield self.finding(
                    module, node,
                    f"`{qual}()` draws from numpy's process-global RNG: "
                    "construct a seeded generator via default_rng(seed)",
                )
            elif qual.startswith("random.") and qual not in self.SEEDED_CTORS:
                yield self.finding(
                    module, node,
                    f"`{qual}()` uses the process-global random state: "
                    "construct `random.Random(seed)` instead",
                )
            elif (qual.startswith(self.TORCH_DRAW_PREFIX)
                  and not any(kw.arg == "generator" for kw in node.keywords)):
                yield self.finding(
                    module, node,
                    f"`{qual}()` draws from torch's process-global generator: "
                    "pass generator= a seeded torch.Generator",
                )
            elif qual in self.TORCH_GLOBAL_SEED:
                yield self.finding(
                    module, node,
                    f"`{qual}()` seeds torch's process-global generator, "
                    "which every unnamed draw shares: draw from a seeded "
                    "torch.Generator instead",
                )


# ---------------------------------------------------------------------------
# RS003 -- hash-order iteration


class HashOrderIterRule(Rule):
    code = "RS003"
    name = "hash-order-iteration"
    rationale = (
        "iterating a set (or set union / .keys() view) runs in hash order, "
        "which varies with PYTHONHASHSEED; decision paths must wrap such "
        "iterables in sorted(...)."
    )

    def check_module(self, module: Module) -> Iterator[Finding]:
        for iterable, context in iter_iteration_sites(module.tree):
            reason = set_likeness(iterable)
            if reason:
                yield self.finding(
                    module, iterable,
                    f"{context} over {reason} iterates in hash order "
                    "(varies with PYTHONHASHSEED): wrap in sorted(...)",
                )


# ---------------------------------------------------------------------------
# RS004 -- TTL backing-field writes bypassing the property setters


class TtlBackingWriteRule(Rule):
    code = "RS004"
    name = "ttl-backing-write"
    rationale = (
        "ReplicaMeta.ttl/last_access/pinned are property-backed so every "
        "mutation re-arms the shared ExpiryIndex; writing the _-prefixed "
        "backing field desynchronizes the heap from the metadata."
    )

    PROTECTED = ("_ttl", "_last_access", "_pinned")

    def check_module(self, module: Module) -> Iterator[Finding]:
        yield from self._scan(module, module.tree.body, owner_props=frozenset())

    def _scan(self, module, stmts, owner_props) -> Iterator[Finding]:
        for stmt in stmts:
            if isinstance(stmt, ast.ClassDef):
                yield from self._scan(
                    module, stmt.body,
                    owner_props=frozenset(class_property_names(stmt)),
                )
                continue
            for node in ast.walk(stmt):
                if isinstance(node, ast.ClassDef):
                    # handled via the recursive branch when it is a direct
                    # statement; nested-in-expression classes are not a thing
                    continue
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for tgt in targets:
                    if not (isinstance(tgt, ast.Attribute) and
                            tgt.attr in self.PROTECTED):
                        continue
                    is_self = isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self"
                    if is_self and tgt.attr.lstrip("_") in owner_props:
                        continue  # the property implementation itself
                    yield self.finding(
                        module, tgt,
                        f"write to backing field `{tgt.attr}` bypasses the "
                        f"property setter `{tgt.attr.lstrip('_')}` and "
                        "desynchronizes the shared ExpiryIndex",
                    )


# ---------------------------------------------------------------------------
# RS005 -- cost-charge symmetry between the two planes


class CostChargeSymmetryRule(Rule):
    """Cross-file rule: the simulator plane (simulator.py) and the live
    plane (ledger.py) mutate the same CostReport fields; a charge added to
    one without the other is a fixture divergence waiting to happen, so it
    is a lint error instead."""

    code = "RS005"
    name = "cost-charge-symmetry"
    rationale = (
        "both planes settle into one CostReport; if simulator.py charges a "
        "field ledger.py never does (or vice versa), the golden dollar "
        "comparison can only pass by accident."
    )

    PLANES = ("simulator", "ledger")

    def __init__(self) -> None:
        #: plane -> {field -> first (path, line)}
        self._writes: Dict[str, Dict[str, Tuple[str, int]]] = {}

    @staticmethod
    def _report_field(tgt: ast.AST):
        """Field name for assignments of shape ``<expr>.report.<field>``."""
        if (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Attribute)
            and tgt.value.attr == "report"
        ):
            return tgt.attr
        return None

    def check_module(self, module: Module) -> Iterator[Finding]:
        if module.name in self.PLANES:
            fields = self._writes.setdefault(module.name, {})
            for node in ast.walk(module.tree):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AugAssign):
                    targets = [node.target]
                for tgt in targets:
                    field = self._report_field(tgt)
                    if field is not None:
                        fields.setdefault(field, (str(module.path), tgt.lineno))
        return iter(())

    def finalize(self, modules: Sequence[Module]) -> Iterator[Finding]:
        if not all(p in self._writes for p in self.PLANES):
            return  # single-plane invocation: nothing to diff
        sim, led = (self._writes[p] for p in self.PLANES)
        for field in sorted(set(sim) - set(led)):
            path, line = sim[field]
            yield Finding(
                self.code,
                f"CostReport.{field} is charged in the simulator plane but "
                "never in the live ledger: add the matching charge or the "
                "golden dollar diff will drift",
                path, line,
            )
        for field in sorted(set(led) - set(sim)):
            path, line = led[field]
            yield Finding(
                self.code,
                f"CostReport.{field} is charged in the live ledger but "
                "never in the simulator plane: add the matching charge or "
                "the golden dollar diff will drift",
                path, line,
            )


# ---------------------------------------------------------------------------
# RS006 -- float accumulation over unordered containers


class UnorderedFloatSumRule(Rule):
    code = "RS006"
    name = "unordered-float-sum"
    rationale = (
        "float addition is not associative; sum() over a hash-ordered "
        "container gives PYTHONHASHSEED-dependent dollars in the ledger "
        "paths.  Sort first (or sum a deterministically ordered sequence)."
    )

    SUM_FUNCS = {"sum", "math.fsum"}

    def check_module(self, module: Module) -> Iterator[Finding]:
        imports = ImportMap(module.tree)
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            qual = imports.qualname(node.func)
            if qual not in self.SUM_FUNCS:
                continue
            arg = node.args[0]
            reason = set_likeness(arg)
            if reason is None and isinstance(arg, (ast.GeneratorExp, ast.ListComp)):
                reason = set_likeness(arg.generators[0].iter)
                reason = f"a comprehension over {reason}" if reason else None
            if reason:
                yield self.finding(
                    module, node,
                    f"float {qual}() over {reason}: accumulation order "
                    "follows hash order -- sort the operands first",
                )


RULE_CLASSES = (
    WallClockRule,
    UnseededRngRule,
    HashOrderIterRule,
    TtlBackingWriteRule,
    CostChargeSymmetryRule,
    UnorderedFloatSumRule,
)


def make_rules() -> List[Rule]:
    """Fresh rule instances (cross-file rules carry per-run state)."""
    return [cls() for cls in RULE_CLASSES]
