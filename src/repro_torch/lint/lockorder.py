"""lock-order rule: the lock-acquisition graph must be acyclic.

Nodes are canonical lock names (``Class.attr`` / ``module.py::name``).
An edge A → B means "B was acquired while A was held", from either:

* lexical nesting — ``with A:`` … ``with B:`` inside one function
  (a method contract counts as holding its lock on entry); or
* interprocedural flow — calling ``f()`` while holding A adds A → L for
  every lock L that ``f`` (transitively, through the resolvable call
  graph) acquires.

Non-blocking acquires (``lock.acquire(False)``) never appear — only
``with`` statements create edges — and an RLock self-edge is legal
re-entrancy, not a deadlock.  Graphs are built per defining module (the
issue's "per module" scope); a cycle spanning modules is reported once,
in the module contributing its first edge.  Any strongly connected
component with more than one node, or a non-reentrant self-edge, is an
ABBA-style deadlock shape and is reported with one example site per edge.
"""
from __future__ import annotations

from repro_torch.lint import analysis
from repro_torch.lint.engine import Finding

RULE = "lock-order"


def _transitive_acquires(project, func, memo, visiting):
    """All locks ``func`` may acquire, directly or through callees."""
    if func in memo:
        return memo[func]
    if func in visiting:
        return frozenset()  # recursion cycle in the call graph
    visiting.add(func)
    acquired = {lock for lock, _held, _line in func.with_acquisitions(project)}
    for call, _held, _stmt in func.call_sites(project):
        for callee in project.resolve_call(call, func):
            acquired |= _transitive_acquires(project, callee, memo, visiting)
    visiting.discard(func)
    memo[func] = frozenset(acquired)
    return memo[func]


def _build_edges(project):
    """edge (a, b) -> list of (path, line, qualname) example sites."""
    edges: dict[tuple[str, str], list[tuple[str, int, str]]] = {}
    memo: dict = {}

    def add(a, b, module, line, func):
        if a == b and project.lock_kind(a) == "RLock":
            return
        edges.setdefault((a, b), []).append((module.path, line, func.qualname))

    for module in project.modules:
        for func in module.all_functions:
            for lock, held, line in func.with_acquisitions(project):
                for h in held:
                    add(h, lock, module, line, func)
            for call, held, stmt in func.call_sites(project):
                if not held:
                    continue
                for callee in project.resolve_call(call, func):
                    for lock in _transitive_acquires(project, callee, memo,
                                                     set()):
                        for h in held:
                            add(h, lock, module, call.lineno, func)
    return edges


def _sccs(nodes, adj):
    """Tarjan's strongly connected components, iteratively."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(adj.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(adj.get(nxt, ()))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
    return out


def check_lock_order(project: analysis.Project) -> list[Finding]:
    edges = _build_edges(project)
    adj: dict[str, list[str]] = {}
    nodes: set[str] = set()
    for (a, b) in edges:
        nodes.update((a, b))
        adj.setdefault(a, []).append(b)

    findings: list[Finding] = []
    seen_cycles: set[frozenset[str]] = set()
    for comp in _sccs(sorted(nodes), adj):
        comp_set = frozenset(comp)
        cyclic = len(comp) > 1 or (comp[0], comp[0]) in edges
        if not cyclic or comp_set in seen_cycles:
            continue
        seen_cycles.add(comp_set)
        cycle_edges = sorted((a, b) for (a, b) in edges
                             if a in comp_set and b in comp_set)
        examples = []
        for a, b in cycle_edges:
            path, line, qual = edges[(a, b)][0]
            examples.append(f"{a} -> {b} at {path}:{line} ({qual})")
        path, line, _qual = edges[cycle_edges[0]][0]
        findings.append(Finding(
            rule=RULE, path=path, line=line,
            message=("lock-order cycle between "
                     + ", ".join(sorted(comp_set)) + ": "
                     + "; ".join(examples)),
            symbol="cycle:" + "->".join(sorted(comp_set))))
    return findings
