"""Shared AST helpers for the replaylint rules.

Everything here is syntactic: no type inference, no imports of the analyzed
code.  The helpers err toward precision (few false positives) because the
analyzer gates CI -- a noisy rule would train people to sprinkle
suppressions, which defeats the contract.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Tuple


class ImportMap:
    """Resolve local names to dotted module paths for one module.

    ``import numpy as np`` maps ``np`` -> ``numpy``;
    ``from datetime import datetime as dt`` maps ``dt`` -> ``datetime.datetime``.
    """

    def __init__(self, tree: ast.Module) -> None:
        self.names: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    self.names[local] = target
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.names[local] = f"{node.module}.{alias.name}"

    def qualname(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain with the root resolved
        through the import table, or None for non-name expressions."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.names.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))


_SET_METHODS = {"union", "intersection", "difference", "symmetric_difference"}
_SET_OPS = (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)


def set_likeness(node: ast.AST) -> Optional[str]:
    """Why ``node`` evaluates to a hash-ordered container, or None.

    Deliberately narrow: plain ``for k in some_dict`` is insertion-ordered in
    every supported Python and is NOT flagged; explicit ``.keys()`` is flagged
    only because the author reached for a view when ``sorted(d)`` reads the
    same -- it marks iteration-order as load-bearing without ordering it.
    """
    if isinstance(node, ast.Set):
        return "set literal"
    if isinstance(node, ast.SetComp):
        return "set comprehension"
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Name) and func.id in ("set", "frozenset"):
            return f"{func.id}(...)"
        if isinstance(func, ast.Attribute):
            if func.attr == "keys" and not node.args:
                return ".keys() view"
            if func.attr in _SET_METHODS and set_likeness(func.value):
                return f".{func.attr}(...) on a set"
    if isinstance(node, ast.BinOp) and isinstance(node.op, _SET_OPS):
        left = set_likeness(node.left)
        right = set_likeness(node.right)
        if left or right:
            op = {ast.BitOr: "|", ast.BitAnd: "&", ast.Sub: "-", ast.BitXor: "^"}[
                type(node.op)
            ]
            return f"set expression ({left or '...'} {op} {right or '...'})"
    return None


def iter_iteration_sites(tree: ast.Module) -> Iterator[Tuple[ast.AST, str]]:
    """Yield (iterable-expression, context) for every spot whose evaluation
    order becomes program order: for-loops, comprehension generators, and
    order-materializing calls (list/tuple/iter/enumerate)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.For):
            yield node.iter, "for loop"
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            for gen in node.generators:
                yield gen.iter, "comprehension"
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id in ("list", "tuple", "iter", "enumerate") and node.args:
                yield node.args[0], f"{node.func.id}(...)"


def class_property_names(cls: ast.ClassDef) -> set:
    """Names defined as properties (``@property`` or ``@<name>.setter``)
    directly in the class body."""
    props = set()
    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in stmt.decorator_list:
            if isinstance(dec, ast.Name) and dec.id == "property":
                props.add(stmt.name)
            elif (
                isinstance(dec, ast.Attribute)
                and dec.attr in ("setter", "deleter", "getter")
            ):
                props.add(stmt.name)
    return props
