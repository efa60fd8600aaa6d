"""Shared AST helpers for the OTPU rules.

The port's copy of ``orleans_tpu.analysis.rules.common``.
"""

from __future__ import annotations

import ast
from typing import Iterator

# shared with the summary engine (which rule modules must not be
# imported BY — rules import common, common imports summaries)
from ..summaries import GRAIN_BASES, dotted_name, func_params

__all__ = [
    "GRAIN_BASES", "dotted_name", "decorator_names", "is_grain_class",
    "is_reentrant_grain", "iter_functions", "iter_grain_classes",
    "func_params", "lexical_walk",
]


def decorator_names(node: ast.ClassDef | ast.FunctionDef |
                    ast.AsyncFunctionDef) -> list[str]:
    """Dotted names of decorators; a decorator-factory call contributes
    its callee's name (``@placement("hash")`` → ``placement``)."""
    out = []
    for d in node.decorator_list:
        if isinstance(d, ast.Call):
            d = d.func
        name = dotted_name(d)
        if name:
            out.append(name)
    return out


def is_grain_class(node: ast.ClassDef) -> bool:
    for base in node.bases:
        last = dotted_name(base).rsplit(".", 1)[-1]
        if last in GRAIN_BASES:
            return True
    return False


def is_reentrant_grain(node: ast.ClassDef) -> bool:
    """``@reentrant`` decorator or a literal ``__orleans_reentrant__ = True``
    in the class body."""
    for name in decorator_names(node):
        if name.rsplit(".", 1)[-1] == "reentrant":
            return True
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and \
                        t.id == "__orleans_reentrant__":
                    v = stmt.value
                    if isinstance(v, ast.Constant) and v.value:
                        return True
    return False


def iter_functions(tree: ast.AST, qualprefix: str = "") -> Iterator[
        tuple[str, "ast.FunctionDef | ast.AsyncFunctionDef"]]:
    """Yield (qualname, node) for every def/async def, nested included."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qn = f"{qualprefix}{node.name}"
            yield qn, node
            yield from iter_functions(node, qn + ".")
        elif isinstance(node, ast.ClassDef):
            yield from iter_functions(node, f"{qualprefix}{node.name}.")


def iter_grain_classes(tree: ast.AST,
                       qualprefix: str = "") -> Iterator[
        tuple[str, ast.ClassDef]]:
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.ClassDef):
            qn = f"{qualprefix}{node.name}"
            if is_grain_class(node):
                yield qn, node
            yield from iter_grain_classes(node, qn + ".")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from iter_grain_classes(node, f"{qualprefix}{node.name}.")


def lexical_walk(node: ast.AST, *, into_defs: bool = False
                 ) -> Iterator[ast.AST]:
    """Depth-first walk in source order (``ast.walk`` is breadth-first,
    which scrambles before/after-await ordering). By default does NOT
    descend into nested function/class definitions — a nested def's body
    does not execute at its lexical position."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not into_defs and isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.Lambda, ast.ClassDef)):
            continue
        yield from lexical_walk(child, into_defs=into_defs)
