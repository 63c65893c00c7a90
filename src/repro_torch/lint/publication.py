"""publication-order rule: row fields are complete before publication.

The lock-free tracer publishes a row by appending to a deque (the
CPython-atomic publication point); readers may observe the row the
instant the append lands, so every field must already be written.  The
contract is spelled at the publication statement::

    self.head = i + 1  # publishes: self.times, self.workers, self.deltas

For each listed field the rule checks, within the enclosing function's
statement order, that

* at least one statement *before* the publication writes the field, and
* no statement *after* it writes the field (a late write is exactly the
  torn-row bug the deque ordering exists to prevent).

A "write" of field ``F`` is an assignment/augassign whose target is
``F``, ``F[...]`` or ``F.<sub>``, an in-place mutator call
(``F.append(...)``), or — for bare names — a call ``F(...)`` (the hot
path binds ``times.append`` to a local, so calling it *is* the write).
"""
from __future__ import annotations

import ast

from repro_torch.lint import analysis
from repro_torch.lint.analysis import MUTATOR_METHODS, expr_text
from repro_torch.lint.engine import Finding, publish_annotation

RULE = "publication-order"


def _flat_statements(func: analysis.FunctionInfo):
    """All statements of the function body in source order, without
    descending into nested defs, each with its *position chain* — the
    ``(body_id, index)`` path from the function body down to the
    statement.  Chains order statements control-flow-sensibly: two
    statements in sibling branches of one ``if`` share no body at their
    divergence point and are mutually unordered."""
    out: list[tuple[ast.stmt, tuple]] = []

    def walk(stmts, chain):
        body_key = id(stmts)
        for idx, st in enumerate(stmts):
            here = chain + ((body_key, idx),)
            out.append((st, here))
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for body in analysis._sub_bodies(st):
                walk(body, here)

    walk(func.node.body, ())
    return out


def _compare(chain_a: tuple, chain_b: tuple) -> int | None:
    """-1 if a executes before b, 1 if after, None if unordered
    (sibling branches) or identical."""
    for (key_a, idx_a), (key_b, idx_b) in zip(chain_a, chain_b):
        if key_a != key_b:
            return None
        if idx_a != idx_b:
            return -1 if idx_a < idx_b else 1
    return None  # one is an ancestor of the other, or the same statement


def _writes_field(stmt: ast.stmt, field: str) -> bool:
    dotted = "." in field

    def target_matches(text: str | None) -> bool:
        return text is not None and (text == field
                                     or text.startswith(field + "."))

    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        stack = list(targets)
        while stack:
            t = stack.pop()
            if isinstance(t, (ast.Tuple, ast.List)):
                stack.extend(t.elts)
            elif isinstance(t, ast.Starred):
                stack.append(t.value)
            elif isinstance(t, ast.Subscript):
                if target_matches(expr_text(t.value)):
                    return True
            elif target_matches(expr_text(t)):
                return True
        return False
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        func = stmt.value.func
        if isinstance(func, ast.Attribute) and func.attr in MUTATOR_METHODS \
                and target_matches(expr_text(func.value)):
            return True
        if not dotted and isinstance(func, ast.Name) and func.id == field:
            return True  # bound-method local: ta(...) IS the append
    return False


def check_publication_order(project: analysis.Project) -> list[Finding]:
    findings: list[Finding] = []
    for module in project.modules:
        annotated_lines = {line for line in module.comments
                           if publish_annotation(module.comments, line)}
        if not annotated_lines:
            continue
        for func in module.all_functions:
            stmts = _flat_statements(func)
            for stmt, chain in stmts:
                if hasattr(stmt, "body"):
                    continue
                span = range(stmt.lineno, (stmt.end_lineno or stmt.lineno) + 1)
                fields = None
                for line in span:
                    if line in annotated_lines:
                        fields = publish_annotation(module.comments, line)
                        break
                if not fields:
                    continue
                before = [s for s, c in stmts if _compare(c, chain) == -1]
                after = [s for s, c in stmts if _compare(c, chain) == 1]
                for field in fields:
                    if not any(_writes_field(s, field) for s in before):
                        findings.append(Finding(
                            rule=RULE, path=module.path, line=stmt.lineno,
                            message=(f"publication point declares {field} "
                                     "but nothing writes it beforehand "
                                     f"(in {func.qualname})"),
                            symbol=f"{func.qualname}:{field}:unwritten"))
                    late = next((s for s in after if _writes_field(s, field)),
                                None)
                    if late is not None:
                        findings.append(Finding(
                            rule=RULE, path=module.path, line=late.lineno,
                            message=(f"{field} written after its publication "
                                     f"point at line {stmt.lineno} — readers "
                                     "can observe a torn row (in "
                                     f"{func.qualname})"),
                            symbol=f"{func.qualname}:{field}:late-write"))
    return findings
