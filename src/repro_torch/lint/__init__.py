"""Concurrency lint — static enforcement of this repo's locking invariants.

GAPP's premise is that serialization bugs surface too late, at runtime;
this repo is itself a heavily threaded system (the lock-free tracer, the
selector ``IngestServer``, ``SpillStore`` journals, the session fold
worker), and every concurrency invariant so far was caught only by chaos
testing after the fact.  ``python -m repro_torch.lint`` closes that loop: an
AST-based rule engine proves the documented invariants *before* the code
runs, and CI gates it next to tier-1.

Rules (see each module for exact semantics; README "Concurrency
invariants" documents the annotation grammar):

* ``guarded-by`` (:mod:`repro_torch.lint.guarded`) — ``# guarded-by: <lock>``
  contracts on shared attributes; every mutation must happen with the
  named lock held (lexically inside ``with <lock>:`` or in a method whose
  ``def`` line carries the same contract, meaning "caller holds it").
* ``lock-order`` (:mod:`repro_torch.lint.lockorder`) — builds the
  interprocedural lock-acquisition graph per module and reports any
  cycle (the ABBA shape: ``self._lock`` → ``st.lock`` in one path,
  ``st.lock`` → ``self._lock`` in another).
* ``loop-blocking`` (:mod:`repro_torch.lint.blocking`) — no ``time.sleep``,
  ``os.fsync``, journal compaction, or unbounded waits reachable from a
  ``# lint: event-loop`` root (the ``IngestServer._loop`` selector
  callbacks).
* ``publication-order`` (:mod:`repro_torch.lint.publication`) —
  ``# publishes: <fields>`` marks a publication point (the shard
  ``deque.append``); every listed row field must be written before it,
  never after.

Suppress a finding with ``# lint: disable=<rule>(<reason>)`` on the
offending line (or the enclosing ``def`` line for the whole function); a
reason is mandatory.  Accepted legacy findings live in the committed
baseline file (``lint-baseline.json``), each with a written
justification; ``--write-baseline`` regenerates it.
"""
from repro_torch.lint.engine import (Baseline, Finding, LintResult,  # noqa: F401
                               run_lint)
from repro_torch.lint.runner import main  # noqa: F401

RULES = ("guarded-by", "lock-order", "loop-blocking", "publication-order")
