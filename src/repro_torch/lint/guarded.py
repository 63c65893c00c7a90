"""guarded-by rule: mutations of annotated shared state must hold the lock.

Contract grammar (trailing comment on the attribute's initialisation)::

    self.next_seq = 0          # guarded-by: self.lock
    self.got_bye = False       # guarded-by: IngestServer._lock

``self.<x>`` specs are *receiver-relative*: a mutation spelled
``st.next_seq = 1`` requires ``st.lock`` held, which the shared resolver
canonicalises to the same node as ``with st.lock:``.  Class-qualified
specs (``Class.attr``) pin the lock to one object regardless of receiver.

A ``# guarded-by:`` on a ``def`` line is a *method contract*: the body is
checked as if the lock were held (caller-holds-it idiom, e.g.
``SpillStore._write_block``), and every resolvable call to that method is
checked for the lock being held at the call site.

Mutations inside the owning class's ``__init__`` are exempt (construction
happens before the object is shared).
"""
from __future__ import annotations

import ast

from repro_torch.lint import analysis
from repro_torch.lint.analysis import MUTATOR_METHODS, expr_text
from repro_torch.lint.engine import Finding

RULE = "guarded-by"


def _mutation_paths(stmt: ast.stmt):
    """Yield ``(dotted_path, node)`` for attribute paths this statement
    writes: plain/aug/subscript assigns, dels, and in-place container
    mutator calls (``x.append(...)``)."""
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.Delete):
        targets = list(stmt.targets)
    elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        func = stmt.value.func
        if isinstance(func, ast.Attribute) and func.attr in MUTATOR_METHODS:
            text = expr_text(func.value)
            if text:
                yield text, stmt.value
        return
    stack = targets
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
        elif isinstance(t, ast.Subscript):
            text = expr_text(t.value)
            if text:
                yield text, t
        else:
            text = expr_text(t)
            if text:
                yield text, t


def _owner_for(path: str, func: analysis.FunctionInfo,
               project: analysis.Project):
    """Which class's guarded-attr contract governs a mutation of
    ``path``?  ``self.x`` binds to the enclosing class only; any other
    receiver binds through the attr name when exactly one class in the
    project guards it."""
    if "." not in path:
        return None, None, None
    receiver, attr = path.rsplit(".", 1)
    if receiver == "self":
        if func.cls is not None and attr in func.cls.guarded_attrs:
            return func.cls, attr, receiver
        return None, None, None
    owners = project.guarded_attr_owners.get(attr, [])
    # Foreign receivers are untyped: enforce only when the attr name is
    # unique among every class that defines it — if some other class also
    # has a `self.<attr>` (e.g. the lock-free EventShard.times next to the
    # guarded EventRing.times), the receiver could be either, so stay out.
    if len(owners) == 1 and project.attr_definers.get(attr, set()) == {owners[0].name}:
        return owners[0], attr, receiver
    return None, None, None


def check_guarded_by(project: analysis.Project) -> list[Finding]:
    findings: list[Finding] = []
    for module in project.modules:
        for func in module.all_functions:
            for stmt, held in func.iter_with_held(project):
                for path, node in _mutation_paths(stmt):
                    owner, attr, receiver = _owner_for(path, func, project)
                    if owner is None:
                        continue
                    if receiver == "self" and func.cls is owner \
                            and func.name == "__init__":
                        continue  # construction, pre-sharing
                    spec = owner.guarded_attrs[attr]
                    required_expr = spec.required_for(receiver)
                    required, _ = project.resolve_lock(required_expr, func)
                    if required in held:
                        continue
                    findings.append(Finding(
                        rule=RULE, path=module.path, line=node.lineno,
                        message=(f"mutation of {owner.name}.{attr} outside "
                                 f"`with {required_expr}` (guarded-by "
                                 f"{spec.lock_expr}, in {func.qualname})"),
                        symbol=f"{func.qualname}:{path}"))
            # Calls into methods whose def-line contract says the caller
            # must already hold the lock.
            for call, held, _stmt in func.call_sites(project):
                for callee in project.resolve_call(call, func):
                    if callee.contract is None or callee is func:
                        continue
                    receiver = None
                    if isinstance(call.func, ast.Attribute):
                        receiver = expr_text(call.func.value)
                    required_expr = callee.contract.required_for(receiver)
                    # Resolve in the frame where the spelling makes
                    # sense: the caller's when receiver-rewritten, the
                    # callee's for its own self-relative spelling.
                    frame = func if receiver not in (None, "self") else callee
                    if receiver == "self" and func.cls is callee.cls:
                        frame = func
                    required, _ = project.resolve_lock(required_expr, frame)
                    if required in held:
                        continue
                    findings.append(Finding(
                        rule=RULE, path=module.path, line=call.lineno,
                        message=(f"call to {callee.qualname} requires "
                                 f"{required_expr} held (guarded-by contract"
                                 f" on its def), in {func.qualname}"),
                        symbol=f"{func.qualname}:call:{callee.qualname}"))
    return findings
