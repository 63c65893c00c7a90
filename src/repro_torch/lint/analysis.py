"""Shared AST analysis: modules, classes, locks, call graph, held-sets.

Everything the four rules have in common lives here, computed once per
``run_lint``:

* per-module ASTs with comments, suppressions, and annotation bindings;
* per-class *lock attributes* (``self.x = threading.Lock()`` and
  friends), with ``Condition(self.other)`` resolved as an alias of the
  underlying lock — acquiring the condition *is* acquiring the lock;
* *guarded attributes* (``self.x = ... # guarded-by: <lock>``) and
  *method contracts* (``# guarded-by:`` on a ``def`` line — the body
  runs with the lock held, so callers must hold it);
* a canonical lock-naming scheme (:meth:`Project.resolve_lock`) that
  lets ``with self._lock:`` in one method and ``with st.lock:`` in
  another agree on identity without type inference;
* a best-effort call graph (:meth:`Project.resolve_call`) over
  module-local names, ``self.``/``Class.`` receivers, project imports,
  and project-unique method names;
* a held-set walker (:meth:`FunctionInfo.iter_with_held`) that streams
  ``(statement, frozenset_of_held_locks)`` pairs in source order.

The resolution is heuristic by design — no inference, no stubs — but it
is *symmetric*: the same resolver names the lock in a ``guarded-by``
contract and the lock in a ``with`` statement, so matching spellings
always agree even when neither resolves to a known lock object.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from repro_torch.lint import engine

#: Callables in ``threading`` whose result we treat as a lock for both
#: acquisition tracking and lock-order nodes.
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

#: Method names that mutate a container in place (used by guarded-by).
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "discard", "clear",
    "add", "update", "setdefault", "sort", "reverse",
}


def expr_text(node: ast.AST) -> str | None:
    """Dotted text for a Name/Attribute chain (``self.source.cond``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = expr_text(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _signature_lines(node: ast.FunctionDef | ast.AsyncFunctionDef) -> range:
    first_body = node.body[0].lineno if node.body else node.lineno + 1
    return range(node.lineno, max(node.lineno, first_body - 1) + 1)


@dataclass
class GuardSpec:
    """A ``# guarded-by: <lock>`` binding on an attribute or a def."""

    lock_expr: str   # as written: "self._lock", "FleetSource.cond", ...
    line: int

    def required_for(self, receiver: str | None) -> str:
        """Rewrite a ``self.``-relative lock to the mutation site's
        receiver: spec ``self.lock`` at site ``st.next_seq`` requires
        ``st.lock``."""
        if receiver and receiver != "self" and self.lock_expr.startswith("self."):
            return receiver + self.lock_expr[4:]
        return self.lock_expr


@dataclass(eq=False)
class ClassInfo:
    name: str
    node: ast.ClassDef
    module: "Module"
    lock_attrs: dict[str, str] = field(default_factory=dict)   # attr -> root attr
    lock_kinds: dict[str, str] = field(default_factory=dict)   # root attr -> factory
    guarded_attrs: dict[str, GuardSpec] = field(default_factory=dict)
    methods: dict[str, "FunctionInfo"] = field(default_factory=dict)

    def lock_root(self, attr: str) -> str | None:
        seen = set()
        while attr in self.lock_attrs and attr not in seen:
            seen.add(attr)
            nxt = self.lock_attrs[attr]
            if nxt == attr:
                return attr
            attr = nxt
        return attr if attr in self.lock_attrs.values() or attr in self.lock_attrs else None


@dataclass(eq=False)
class FunctionInfo:
    name: str
    qualname: str
    node: ast.FunctionDef | ast.AsyncFunctionDef
    module: "Module"
    cls: ClassInfo | None
    contract: GuardSpec | None = None   # guarded-by on the def line
    is_loop_root: bool = False          # lint: event-loop on the def line

    def iter_with_held(self, project: "Project"):
        """Yield ``(stmt, held)`` for every statement in source order.

        ``held`` is the frozenset of canonical lock names lexically held
        at that statement: enclosing ``with <lock>:`` blocks plus this
        function's own contract.  Nested ``def``s are *not* descended
        into — they are separate :class:`FunctionInfo` entries with
        their own (empty) base held-set.
        """
        base: frozenset[str] = frozenset()
        if self.contract is not None:
            canon, _ = project.resolve_lock(self.contract.lock_expr, self)
            base = frozenset({canon})

        def walk(stmts, held):
            for st in stmts:
                yield st, held
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(st, (ast.With, ast.AsyncWith)):
                    inner = held
                    for item in st.items:
                        text = expr_text(item.context_expr)
                        if text is None:
                            continue
                        canon, known = project.resolve_lock(text, self)
                        if known:
                            inner = inner | {canon}
                    yield from walk(st.body, inner)
                    continue
                for body in _sub_bodies(st):
                    yield from walk(body, held)

        yield from walk(self.node.body, base)

    def with_acquisitions(self, project: "Project"):
        """Yield ``(lock, held_before, line)`` for each ``with``-acquired
        known lock, in source order (used by lock-order)."""
        for st, held in self.iter_with_held(project):
            if not isinstance(st, (ast.With, ast.AsyncWith)):
                continue
            inner = set(held)
            for item in st.items:
                text = expr_text(item.context_expr)
                if text is None:
                    continue
                canon, known = project.resolve_lock(text, self)
                if known:
                    yield canon, frozenset(inner), st.lineno
                    inner.add(canon)

    def call_sites(self, project: "Project"):
        """Yield ``(call_node, held, stmt)`` for every Call expression.

        Compound statements contribute only their *header* expressions
        (test/iter/with-items); their bodies arrive as their own
        statements, so no call is yielded twice.
        """
        for st, held in self.iter_with_held(project):
            for root in _header_exprs(st):
                for sub in ast.walk(root):
                    if isinstance(sub, ast.Call):
                        yield sub, held, st


def _header_exprs(st: ast.stmt) -> list[ast.AST]:
    """The expressions owned by the statement itself — a simple statement
    in full, a compound statement's header only, a def's nothing."""
    if not hasattr(st, "body"):
        return [st]
    if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return []
    out: list[ast.AST] = []
    for name in ("test", "iter", "target", "subject"):
        value = getattr(st, name, None)
        if value is not None:
            out.append(value)
    for item in getattr(st, "items", ()) or ():
        out.append(item.context_expr)
    return out


def _direct_nested_defs(node):
    """First-level nested ``def``s only; deeper nesting is handled by the
    recursive _make_function call on each of these."""
    out, stack = [], list(node.body)
    while stack:
        st = stack.pop(0)
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(st)
            continue
        stack.extend(c for c in ast.iter_child_nodes(st)
                     if isinstance(c, ast.stmt) or hasattr(c, "body"))
    return out


def _sub_bodies(st: ast.stmt):
    for name in ("body", "orelse", "finalbody"):
        body = getattr(st, name, None)
        if body:
            yield body
    for handler in getattr(st, "handlers", ()) or ():
        yield handler.body


@dataclass(eq=False)
class Module:
    path: str                      # as passed to the linter (relative)
    dotted: str                    # best-effort import name
    tree: ast.Module
    source: str
    comments: dict[int, str]
    suppressions: dict[int, list[engine.Suppression]]
    classes: dict[str, ClassInfo] = field(default_factory=dict)
    functions: dict[str, FunctionInfo] = field(default_factory=dict)  # module level
    all_functions: list[FunctionInfo] = field(default_factory=list)   # incl. methods + nested
    imports: dict[str, str] = field(default_factory=dict)             # alias -> dotted
    lock_vars: dict[str, str] = field(default_factory=dict)           # module-level locks
    lock_var_kinds: dict[str, str] = field(default_factory=dict)
    _stmt_spans: list[tuple[int, int]] = field(default_factory=list)
    _def_spans: list[tuple[int, int, int, int]] = field(default_factory=list)

    def suppress_spans_for_line(self, line: int) -> list[int]:
        """Lines whose ``# lint: disable=`` comments govern ``line``:
        the offending statement's own span plus every enclosing ``def``
        signature."""
        lines = {line}
        for start, end in self._stmt_spans:
            if start <= line <= end and end - start <= 20:
                # the statement's own lines, plus the line directly above
                # it (a full-line disable comment with a long reason)
                lines.update(range(start - 1, end + 1))
        for start, end, sig_start, sig_end in self._def_spans:
            if start <= line <= end:
                # signature lines plus the line above the def (where a
                # function-wide disable sits, decorator-style)
                lines.update(range(sig_start - 1, sig_end + 1))
        return sorted(lines)


def _dotted_name(path: str) -> str:
    parts = path.replace(os.sep, "/").split("/")
    if parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if "repro" in parts:
        parts = parts[parts.index("repro"):]
    elif "src" in parts:
        parts = parts[parts.index("src") + 1:]
    return ".".join(p for p in parts if p)


def _lock_factory(call: ast.AST, imports: dict[str, str]) -> str | None:
    """Return the factory name if ``call`` constructs a threading lock."""
    if not isinstance(call, ast.Call):
        return None
    text = expr_text(call.func)
    if text is None:
        return None
    head, _, rest = text.partition(".")
    full = imports.get(head, head) + (("." + rest) if rest else "")
    if full.startswith("threading.") and full.split(".", 1)[1] in LOCK_FACTORIES:
        return full.split(".", 1)[1]
    if full in LOCK_FACTORIES:  # `from threading import Lock`
        return full
    return None


class Project:
    """All parsed modules plus the cross-module indexes."""

    def __init__(self):
        self.modules: list[Module] = []
        self.by_path: dict[str, Module] = {}
        self.by_dotted: dict[str, Module] = {}
        self.errors: list[str] = []
        # attr name -> {class info} across the whole project
        self.lock_attr_owners: dict[str, list[ClassInfo]] = {}
        self.guarded_attr_owners: dict[str, list[ClassInfo]] = {}
        # attr name -> every class that assigns self.<attr> anywhere; used
        # to keep unique-owner resolution honest (a name also defined by an
        # unrelated class cannot be enforced on foreign receivers).
        self.attr_definers: dict[str, set[str]] = {}
        self.class_index: dict[str, list[ClassInfo]] = {}
        self.method_index: dict[str, list[FunctionInfo]] = {}
        self.class_by_dotted: dict[str, ClassInfo] = {}

    # -- loading --------------------------------------------------------

    @classmethod
    def load(cls, paths: list[str]) -> "Project":
        project = cls()
        for path in paths:
            norm = path.replace(os.sep, "/")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    source = f.read()
                tree = ast.parse(source, filename=path)
            except (OSError, SyntaxError) as exc:
                project.errors.append(f"{norm}: {exc}")
                continue
            project._add_module(norm, source, tree)
        project._index()
        return project

    def _add_module(self, path: str, source: str, tree: ast.Module) -> None:
        comments = engine.extract_comments(source)
        module = Module(path=path, dotted=_dotted_name(path), tree=tree,
                        source=source, comments=comments,
                        suppressions=engine.parse_suppressions(comments))
        self._collect_imports(module)
        self._collect_spans(module)
        self._collect_toplevel(module)
        self.modules.append(module)
        self.by_path[path] = module
        self.by_dotted[module.dotted] = module

    def _collect_imports(self, module: Module) -> None:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    module.imports[local] = target
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    pkg = module.dotted.split(".")[:-node.level]
                    base = ".".join(pkg + ([node.module] if node.module else []))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    module.imports[local] = f"{base}.{alias.name}" if base else alias.name

    def _collect_spans(self, module: Module) -> None:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sig = _signature_lines(node)
                module._def_spans.append(
                    (node.lineno, node.end_lineno or node.lineno,
                     sig.start, sig.stop - 1))
            elif isinstance(node, ast.stmt) and not hasattr(node, "body"):
                module._stmt_spans.append(
                    (node.lineno, node.end_lineno or node.lineno))

    def _collect_toplevel(self, module: Module) -> None:
        for node in module.tree.body:
            if isinstance(node, ast.ClassDef):
                self._collect_class(module, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = self._make_function(module, node, None, node.name)
                module.functions[node.name] = info
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                kind = _lock_factory(node.value, module.imports)
                if kind:
                    name = node.targets[0].id
                    module.lock_vars[name] = name
                    module.lock_var_kinds[name] = kind

    def _collect_class(self, module: Module, node: ast.ClassDef) -> None:
        info = ClassInfo(name=node.name, node=node, module=module)
        module.classes[node.name] = info
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = self._make_function(module, item, info,
                                         f"{node.name}.{item.name}")
                info.methods[item.name] = fn
        # Class-body declarations (dataclass fields): contract + definer.
        for item in node.body:
            if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                name = item.target.id
            elif isinstance(item, ast.Assign) and len(item.targets) == 1 \
                    and isinstance(item.targets[0], ast.Name):
                name = item.targets[0].id
            else:
                continue
            self.attr_definers.setdefault(name, set()).add(info.name)
            lock = engine.guard_annotation(module.comments, item.lineno)
            if lock:
                info.guarded_attrs[name] = GuardSpec(lock, item.lineno)
        # Attribute contracts + lock attributes from any `self.X = ...`.
        for method in info.methods.values():
            for sub in ast.walk(method.node):
                if isinstance(sub, ast.Assign):
                    targets, value = sub.targets, sub.value
                elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                    targets, value = [sub.target], sub.value
                else:
                    continue
                for target in targets:
                    text = expr_text(target)
                    if not (text and text.startswith("self.")
                            and text.count(".") == 1):
                        continue
                    attr = text.split(".", 1)[1]
                    self.attr_definers.setdefault(attr, set()).add(info.name)
                    kind = _lock_factory(value, module.imports)
                    if kind:
                        root = attr
                        if kind == "Condition" and isinstance(value, ast.Call) \
                                and value.args:
                            underlying = expr_text(value.args[0])
                            if underlying and underlying.startswith("self."):
                                root = underlying.split(".", 1)[1]
                        info.lock_attrs[attr] = root
                        info.lock_kinds.setdefault(root, kind)
                    lock = engine.guard_annotation(module.comments, sub.lineno)
                    if lock:
                        info.guarded_attrs[attr] = GuardSpec(lock, sub.lineno)

    def _make_function(self, module: Module, node, cls, qualname) -> FunctionInfo:
        info = FunctionInfo(name=node.name, qualname=qualname, node=node,
                            module=module, cls=cls)
        for line in _signature_lines(node):
            lock = engine.guard_annotation(module.comments, line)
            if lock and info.contract is None:
                info.contract = GuardSpec(lock, line)
            if engine.is_event_loop_annotation(module.comments, line):
                info.is_loop_root = True
        module.all_functions.append(info)
        # Nested defs become their own FunctionInfo (publication points
        # live inside the tracer's hot-path closures) but are not
        # indexed as callable methods.
        for inner in _direct_nested_defs(node):
            self._make_function(module, inner, cls,
                                f"{qualname}.<locals>.{inner.name}")
        return info

    def _index(self) -> None:
        for module in self.modules:
            for cls in module.classes.values():
                self.class_index.setdefault(cls.name, []).append(cls)
                self.class_by_dotted[f"{module.dotted}.{cls.name}"] = cls
                for attr in cls.lock_attrs:
                    self.lock_attr_owners.setdefault(attr, []).append(cls)
                for attr in cls.guarded_attrs:
                    self.guarded_attr_owners.setdefault(attr, []).append(cls)
                for name, fn in cls.methods.items():
                    self.method_index.setdefault(name, []).append(fn)

    # -- resolution -----------------------------------------------------

    def _class_named(self, name: str, module: Module) -> ClassInfo | None:
        if name in module.classes:
            return module.classes[name]
        target = module.imports.get(name)
        if target and target in self.class_by_dotted:
            return self.class_by_dotted[target]
        owners = self.class_index.get(name, [])
        return owners[0] if len(owners) == 1 else None

    def resolve_lock(self, text: str, func: FunctionInfo | None) -> tuple[str, bool]:
        """Canonical name for a lock expression, plus whether it resolved
        to a *known* lock object.  Canonical forms: ``Class.attr`` for
        class locks, ``module.py::name`` otherwise (the fallback is still
        deterministic, so two identical spellings always agree)."""
        module = func.module if func else None
        parts = text.split(".")
        # self._lock inside a class that defines it
        if func and func.cls and parts[0] == "self" and len(parts) == 2 \
                and parts[1] in func.cls.lock_attrs:
            root = func.cls.lock_attrs[parts[1]]
            return f"{func.cls.name}.{root}", True
        # ClassName.attr (class-qualified contract spelling)
        if len(parts) == 2 and module is not None:
            cls = self._class_named(parts[0], module)
            if cls is not None and parts[1] in cls.lock_attrs:
                return f"{cls.name}.{cls.lock_attrs[parts[1]]}", True
        # receiver.attr where attr names a lock in exactly one class
        if len(parts) >= 2:
            owners = self.lock_attr_owners.get(parts[-1], [])
            if len(owners) == 1:
                cls = owners[0]
                return f"{cls.name}.{cls.lock_attrs[parts[-1]]}", True
        # module-level lock variable
        if len(parts) == 1 and module is not None and text in module.lock_vars:
            return f"{module.path}::{text}", True
        where = module.path if module is not None else "?"
        return f"{where}::{text}", False

    def lock_kind(self, canonical: str) -> str | None:
        """Factory kind ('Lock', 'RLock', ...) for a canonical lock name."""
        if "::" in canonical:
            path, name = canonical.split("::", 1)
            mod = self.by_path.get(path)
            return mod.lock_var_kinds.get(name) if mod else None
        if "." in canonical:
            cname, attr = canonical.rsplit(".", 1)
            for cls in self.class_index.get(cname, []):
                if attr in cls.lock_kinds:
                    return cls.lock_kinds[attr]
        return None

    def canonical_call_text(self, call: ast.Call, module: Module) -> str | None:
        """Dotted call target with the first component resolved through
        the module's imports (``from time import sleep`` → ``time.sleep``)."""
        text = expr_text(call.func)
        if text is None:
            return None
        head, _, rest = text.partition(".")
        full_head = module.imports.get(head, head)
        return full_head + (("." + rest) if rest else "")

    def resolve_call(self, call: ast.Call, func: FunctionInfo) -> list[FunctionInfo]:
        """Best-effort callee resolution; empty list when ambiguous."""
        f = call.func
        module = func.module
        if isinstance(f, ast.Name):
            name = f.id
            if name in module.functions:
                return [module.functions[name]]
            cls = module.classes.get(name)
            if cls is None:
                target = module.imports.get(name)
                if target:
                    owner_dotted, _, leaf = target.rpartition(".")
                    owner = self.by_dotted.get(owner_dotted)
                    if owner is not None:
                        if leaf in owner.functions:
                            return [owner.functions[leaf]]
                        cls = owner.classes.get(leaf)
            if cls is not None and "__init__" in cls.methods:
                return [cls.methods["__init__"]]
            return []
        if isinstance(f, ast.Attribute):
            recv = expr_text(f.value)
            name = f.attr
            if recv == "self" and func.cls is not None:
                if name in func.cls.methods:
                    return [func.cls.methods[name]]
            if recv is not None and "." not in recv:
                cls = self._class_named(recv, module)
                if cls is not None and name in cls.methods:
                    return [cls.methods[name]]
                target = module.imports.get(recv)
                if target is not None:
                    owner = self.by_dotted.get(target)
                    if owner is not None and name in owner.functions:
                        return [owner.functions[name]]
            owners = self.method_index.get(name, [])
            if len(owners) == 1:
                return owners
        return []
