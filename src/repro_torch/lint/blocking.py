"""loop-blocking rule: nothing slow may run on the selector thread.

Roots are functions whose ``def`` line carries ``# lint: event-loop``
(``IngestServer._loop``).  The rule walks the resolvable call graph from
each root and flags, in any reachable function, calls that can stall the
event loop:

* ``time.sleep``;
* ``os.fsync`` and the journal-compaction file ops (``os.replace``,
  ``os.rename``, ``os.remove``, ``os.unlink``) — a rotation seal or
  prune is milliseconds of disk latency every connected host pays;
* blocking socket setup: ``socket.create_connection`` without a
  ``timeout``, ``sock.setblocking(True)``, ``sock.settimeout(None)``,
  ``sock.makefile`` (returns a *blocking* file wrapper);
* unbounded waits: zero-argument ``.join()`` / ``.wait()``, and
  ``select.select`` / ``selector.select()`` with no timeout.

Each finding carries the call chain from the root, so "why is this on
the loop thread" is answerable from the report alone.  Intentional
exceptions (the opt-in journal fsync) are suppressed inline with a
reason or carried in the baseline with a written justification.
"""
from __future__ import annotations

import ast

from repro_torch.lint import analysis
from repro_torch.lint.engine import Finding

RULE = "loop-blocking"

#: Canonical call targets that block unconditionally.
_DENY_CALLS = {
    "time.sleep": "time.sleep() stalls the event loop",
    "os.fsync": "os.fsync() is a synchronous disk barrier",
    "os.replace": "os.replace() is synchronous disk metadata I/O",
    "os.rename": "os.rename() is synchronous disk metadata I/O",
    "os.remove": "os.remove() is synchronous disk metadata I/O",
    "os.unlink": "os.unlink() is synchronous disk metadata I/O",
}


def _is_none(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _is_true(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _blocking_reason(call: ast.Call, canonical: str | None) -> str | None:
    """Why this call blocks, or None if it is loop-safe."""
    if canonical in _DENY_CALLS:
        return _DENY_CALLS[canonical]
    func = call.func
    attr = func.attr if isinstance(func, ast.Attribute) else None
    kwargs = {kw.arg: kw.value for kw in call.keywords}
    if canonical == "socket.create_connection":
        if len(call.args) < 2 and "timeout" not in kwargs:
            return "socket.create_connection() without a timeout blocks"
        return None
    if attr == "setblocking" and call.args and _is_true(call.args[0]):
        return "setblocking(True) makes the socket block the loop"
    if attr == "settimeout" and call.args and _is_none(call.args[0]):
        return "settimeout(None) makes the socket block the loop"
    if attr == "makefile":
        return "makefile() returns a blocking file wrapper"
    if attr == "join" and not call.args and not call.keywords:
        return "join() without a timeout waits unboundedly"
    if attr == "wait" and not call.args and "timeout" not in kwargs:
        return "wait() without a timeout waits unboundedly"
    if canonical == "select.select" and len(call.args) < 4 \
            and "timeout" not in kwargs:
        return "select.select() without a timeout blocks"
    if attr == "select" and canonical != "select.select" \
            and not call.args and "timeout" not in kwargs:
        return "selector.select() without a timeout blocks"
    return None


def _reachable_from_roots(project: analysis.Project):
    """BFS over the call graph; returns func -> chain-of-qualnames from
    its nearest root (roots map to a one-element chain)."""
    chains: dict[analysis.FunctionInfo, list[str]] = {}
    queue: list[analysis.FunctionInfo] = []
    for module in project.modules:
        for func in module.all_functions:
            if func.is_loop_root:
                chains[func] = [func.qualname]
                queue.append(func)
    while queue:
        func = queue.pop(0)
        for call, _held, _stmt in func.call_sites(project):
            for callee in project.resolve_call(call, func):
                if callee in chains:
                    continue
                chains[callee] = chains[func] + [callee.qualname]
                queue.append(callee)
    return chains


def check_loop_blocking(project: analysis.Project) -> list[Finding]:
    findings: list[Finding] = []
    for func, chain in _reachable_from_roots(project).items():
        module = func.module
        via = " -> ".join(chain)
        for call, _held, _stmt in func.call_sites(project):
            canonical = project.canonical_call_text(call, module)
            reason = _blocking_reason(call, canonical)
            if reason is None:
                continue
            label = canonical or "call"
            findings.append(Finding(
                rule=RULE, path=module.path, line=call.lineno,
                message=f"{reason}; reachable from event loop via {via}",
                symbol=f"{func.qualname}:{label}"))
    return findings
