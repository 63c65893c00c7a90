"""Runtime lock-order sanitizer: the dynamic half of the lock-order rule.

While installed, ``threading.Lock``/``threading.RLock`` return proxies
that record, per thread, which lock was acquired while which others were
held.  Locks are identified by *creation site* (``file:line``), the same
granularity the static pass reasons at — every ``_HostState.lock`` is
one node, exactly like the AST rule's ``_HostState.lock``.  At the end
of a test session the recorded edges are checked for cycles; a cycle
means two code paths disagreed about acquisition order *in an actual
run*, cross-validating the static rule's graph with ground truth.

``threading.Condition`` needs no patching: a bare ``Condition()``
allocates its lock via the (patched) module-global ``RLock``, and
``Condition(existing_lock)`` wraps whatever proxy it is handed, so
condition acquires are recorded through the underlying lock either way.

Deliberate limits:

* re-entrant acquires of the *same proxy* record no edge (RLock
  re-entrancy is legal);
* nesting two locks from the *same* creation site (e.g. two different
  hosts' ``_HostState.lock``) records no edge either — a site-level
  graph cannot express per-instance ordering disciplines, and a false
  self-edge would fail CI on correct code;
* edge recording uses an *unpatched* lock internally, so the watchdog
  never feeds back into its own graph.

Opt out with ``GAPP_LOCK_WATCHDOG=0`` (see ``tests/conftest.py``).
"""
from __future__ import annotations

import os
import sys
import threading


def _creation_site(depth: int = 2) -> str:
    """file:line of the frame that called the lock factory, skipping
    frames inside this module and inside ``threading`` itself."""
    frame = sys._getframe(depth)
    here = os.path.normcase(__file__)
    while frame is not None:
        fname = os.path.normcase(frame.f_code.co_filename)
        if fname != here and not fname.endswith(os.sep + "threading.py"):
            return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


class _LockProxy:
    """Wraps a real lock; records acquisition order through its watchdog."""

    __slots__ = ("_wd", "_inner", "site")

    def __init__(self, wd: "LockWatchdog", inner, site: str):
        self._wd = wd
        self._inner = inner
        self.site = site

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._wd._note_acquire(self)
        return got

    def release(self):
        self._wd._note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        # _is_owned/_release_save/_acquire_restore for Condition, etc.
        return getattr(self._inner, name)


class LockWatchdog:
    """Install/uninstall the factory patches and hold the edge graph."""

    def __init__(self):
        self._orig_lock = threading.Lock
        self._orig_rlock = threading.RLock
        # Internal state is protected by an *unpatched* lock so the
        # watchdog's own synchronization never records edges.
        self._mu = self._orig_lock()
        self._tls = threading.local()
        self._active = False
        # (site_a, site_b) -> example "thread: a -> b" description
        self.edges: dict[tuple[str, str], str] = {}

    # -- patching -------------------------------------------------------

    def install(self) -> None:
        wd = self

        def make_lock():
            return _LockProxy(wd, wd._orig_lock(), _creation_site())

        def make_rlock():
            return _LockProxy(wd, wd._orig_rlock(), _creation_site())

        self._active = True
        threading.Lock = make_lock
        threading.RLock = make_rlock

    def uninstall(self) -> None:
        self._active = False
        threading.Lock = self._orig_lock
        threading.RLock = self._orig_rlock

    # -- recording ------------------------------------------------------

    def _held(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _note_acquire(self, proxy: _LockProxy) -> None:
        if not self._active:
            return
        stack = self._held()
        if not any(p is proxy for p in stack):
            # NOT threading.current_thread(): in a freshly-bootstrapped
            # thread (3.10 sets Thread._started before registering in
            # threading._active) it would fabricate a _DummyThread whose
            # own Event acquires another proxied lock — and recurse here
            # forever, killing the bootstrap before _started.set() and
            # hanging Thread.start() in the parent.
            ident = threading.get_ident()
            reg = threading._active.get(ident)
            tname = reg.name if reg is not None else f"thread-{ident}"
            new_edges = []
            for held in stack:
                if held.site != proxy.site:
                    new_edges.append((held.site, proxy.site, tname))
            if new_edges:
                with self._mu:
                    for a, b, t in new_edges:
                        self.edges.setdefault(
                            (a, b), f"{t}: {a} then {b}")
        stack.append(proxy)

    def _note_release(self, proxy: _LockProxy) -> None:
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is proxy:
                del stack[i]
                return

    # -- checking -------------------------------------------------------

    def cycles(self) -> list[str]:
        """Human-readable description of every cycle in the site graph."""
        with self._mu:
            edges = dict(self.edges)
        adj: dict[str, list[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)

        out: list[str] = []
        seen: set[frozenset] = set()
        # DFS cycle search; the graphs here are tiny (dozens of sites).
        for start in sorted(adj):
            path: list[str] = []
            on_path: set[str] = set()

            def dfs(node):
                path.append(node)
                on_path.add(node)
                for nxt in sorted(adj.get(node, ())):
                    if nxt in on_path:
                        cyc = path[path.index(nxt):] + [nxt]
                        key = frozenset(cyc)
                        if key not in seen:
                            seen.add(key)
                            detail = "; ".join(
                                edges.get((a, b), f"{a} then {b}")
                                for a, b in zip(cyc, cyc[1:]))
                            out.append(" -> ".join(cyc) + f" ({detail})")
                    elif nxt in adj:
                        dfs(nxt)
                path.pop()
                on_path.discard(node)

            dfs(start)
        return out
