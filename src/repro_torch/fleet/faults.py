"""Deterministic fault injection for the fleet transport.

Chaos testing the ingest path with real kill -9s and packet loss makes
every failure a flaky race.  :class:`FaultPlan` instead injects failures
*beneath* :mod:`repro_torch.fleet.wire` / :mod:`repro_torch.fleet.transport` through
two shims, so each failure mode is an ordinary, reproducible unit test:

* **wire shim** — :meth:`FaultPlan.wrap_producer` wraps the producer's
  connection file object; every ``write()`` is one frame (the sink writes
  whole frames), so rules trigger on exact frame counts: kill the
  connection at frame N (``drop``), write a byte-truncated frame then die
  (``truncate`` — the server sees a torn frame that never completes),
  flip a frame-header byte (``corrupt`` — byte 2 is the schema version,
  which every decoder hard-rejects, so corruption is *detected*, never
  silently folded), sleep before a frame (``stall``) or before every
  frame (``slow``).  Connect attempts are gated too
  (``refuse_connect`` — a partition is "drop the connection, then refuse
  the next K dials").
* **journal shim** — :meth:`FaultPlan.wrap_journal` proxies a
  :class:`~repro_torch.core.spill.SpillStore`; ``disk_full`` makes
  ``append_block`` raise ``OSError(ENOSPC)`` for the next K attempts once
  the store reaches a given block, exercising both journal-full policies
  (producer: shed the chunk before it consumes a seq; server: refuse the
  chunk so the reconnect replay re-delivers it).

Determinism: rules fire on frame/block/attempt counts, never timers, and
every injected fault is appended to :attr:`FaultPlan.events` —
``(host_id, kind, detail)`` in injection order — so a test can assert the
exact fault sequence it scripted.  The optional ``seed`` feeds
:attr:`FaultPlan.rng`, the *only* randomness source a chaos harness
should use to scatter rules, making a whole 64-producer chaos run
replayable from one integer.
"""
from __future__ import annotations

import errno
import random
import threading
import time


class _Rule:
    __slots__ = ("kind", "conn", "frame", "arg", "remaining")

    def __init__(self, kind, conn, frame, arg, remaining=1):
        self.kind = kind
        self.conn = conn        # connection index (per host) or None = any
        self.frame = frame      # frame/block index or None = any
        self.arg = arg
        self.remaining = remaining


class FaultPlan:
    """A scripted, seedable schedule of transport/journal faults.

    Rules are keyed by ``host_id`` (use ``"*"`` to match every host).
    Frame and connection indices are 0-based and count per host:
    connection 0 is the host's first dial, frame 0 its first write on
    that connection (HELLO).  All methods are thread-safe — one plan is
    shared across every producer/server thread of a chaos run.
    """

    ANY = "*"

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.seed = seed
        self.events: list[tuple[str, str, str]] = []
        self._lock = threading.Lock()
        self._rules: dict[str, list[_Rule]] = {}
        self._conns: dict[str, int] = {}       # successful dials per host
        self._schedules: dict[str, list[int]] = {}

    # -- scripting API -------------------------------------------------------
    def _add(self, host: str, rule: _Rule) -> "FaultPlan":
        with self._lock:
            self._rules.setdefault(str(host), []).append(rule)
        return self

    def drop(self, host: str, *, frame: int,
             conn: int | None = None) -> "FaultPlan":
        """Kill the connection (ConnectionResetError) instead of writing
        frame ``frame``."""
        return self._add(host, _Rule("drop", conn, int(frame), None))

    def truncate(self, host: str, *, frame: int, keep: int = 4,
                 conn: int | None = None) -> "FaultPlan":
        """Write only the first ``keep`` bytes of frame ``frame``, then
        kill the connection — the peer holds a torn frame forever."""
        return self._add(host, _Rule("truncate", conn, int(frame),
                                     max(int(keep), 0)))

    def corrupt(self, host: str, *, frame: int, offset: int = 2,
                conn: int | None = None) -> "FaultPlan":
        """Flip one byte of frame ``frame`` before writing it.  The
        default offset 2 is the frame header's schema-version byte, which
        every decoder rejects — corruption surfaces as a protocol error,
        never as silently-wrong data."""
        return self._add(host, _Rule("corrupt", conn, int(frame),
                                     int(offset)))

    def stall(self, host: str, *, frame: int, seconds: float,
              conn: int | None = None) -> "FaultPlan":
        """Sleep ``seconds`` before writing frame ``frame`` (one-shot
        latency spike)."""
        return self._add(host, _Rule("stall", conn, int(frame),
                                     float(seconds)))

    def slow(self, host: str, *, per_frame: float) -> "FaultPlan":
        """Sleep ``per_frame`` seconds before EVERY frame on every
        connection of ``host`` — a persistently slow producer."""
        return self._add(host, _Rule("slow", None, None, float(per_frame),
                                     remaining=1 << 62))

    def refuse_connect(self, host: str, *, times: int = 1) -> "FaultPlan":
        """Refuse the host's next ``times`` dials
        (ConnectionRefusedError).  ``drop`` + ``refuse_connect`` scripts a
        network partition of bounded length."""
        return self._add(host, _Rule("refuse", None, None, None,
                                     remaining=int(times)))

    def disk_full(self, host: str, *, at_block: int,
                  failures: int = 1) -> "FaultPlan":
        """Once the wrapped journal holds ``at_block`` blocks, the next
        ``failures`` ``append_block`` attempts raise
        ``OSError(ENOSPC)`` — then the disk "recovers"."""
        return self._add(host, _Rule("disk_full", None, int(at_block), None,
                                     remaining=int(failures)))

    # generic step schedules (server kills/restarts etc.): the chaos
    # driver polls `due(name, step)` with its progress counter; each
    # threshold fires exactly once, in order
    def schedule(self, name: str, at_steps) -> "FaultPlan":
        with self._lock:
            self._schedules.setdefault(str(name), []).extend(
                sorted(int(s) for s in at_steps))
        return self

    def due(self, name: str, step: int) -> bool:
        with self._lock:
            pending = self._schedules.get(str(name))
            if pending and step >= pending[0]:
                pending.pop(0)
                self.events.append((name, "due", f"step={step}"))
                return True
            return False

    # -- shims ---------------------------------------------------------------
    def connect(self, host: str) -> int:
        """Gate one dial attempt; returns this connection's index (counts
        only successful dials).  Raises ConnectionRefusedError while a
        ``refuse_connect`` budget remains."""
        with self._lock:
            rule = self._find(host, "refuse")
            if rule is not None:
                rule.remaining -= 1
                self.events.append((host, "refuse", ""))
                raise ConnectionRefusedError(
                    errno.ECONNREFUSED, f"fault plan refused {host}")
            idx = self._conns.get(host, 0)
            self._conns[host] = idx + 1
            return idx

    def wrap_producer(self, host: str, fileobj, conn: int = 0):
        """Wrap a connection's file object so writes pass through the
        frame-fault rules (one ``write()`` == one frame)."""
        return _FaultedFile(self, str(host), int(conn), fileobj)

    def wrap_journal(self, host: str, store):
        """Proxy a SpillStore so ``append_block`` honors ``disk_full``
        rules; everything else delegates untouched."""
        return _FaultedJournal(self, str(host), store)

    # -- matching (internal) -------------------------------------------------
    def _find(self, host: str, kind: str, conn: int | None = None,
              frame: int | None = None) -> _Rule | None:
        """Caller holds the lock.  First live rule matching host ('*'
        matches any), kind, and — when the rule pins them — conn/frame."""
        for key in (host, self.ANY):
            for r in self._rules.get(key, ()):
                if r.kind != kind or r.remaining <= 0:
                    continue
                if r.conn is not None and r.conn != conn:
                    continue
                if r.frame is not None and frame is not None \
                        and r.frame != frame:
                    continue
                return r
        return None

    def _on_write(self, host: str, conn: int, frame: int,
                  data: bytes) -> bytes | None:
        """Apply write-side rules to one frame.  Returns the (possibly
        mutated) bytes to write, or raises to kill the connection.  A
        ``truncate`` rule writes its prefix itself and then raises, so
        ``None`` is never returned to the caller."""
        with self._lock:
            slow = self._find(host, "slow", conn, None)
            stall = self._find(host, "stall", conn, frame)
            drop = self._find(host, "drop", conn, frame)
            trunc = self._find(host, "truncate", conn, frame)
            corr = self._find(host, "corrupt", conn, frame)
            for r in (stall, drop, trunc, corr):
                if r is not None:
                    r.remaining -= 1
        delay = (slow.arg if slow is not None else 0.0) \
            + (stall.arg if stall is not None else 0.0)
        if delay:
            if stall is not None:
                with self._lock:
                    self.events.append((host, "stall",
                                        f"conn={conn} frame={frame} "
                                        f"s={delay}"))
            time.sleep(delay)
        if drop is not None:
            with self._lock:
                self.events.append((host, "drop",
                                    f"conn={conn} frame={frame}"))
            raise ConnectionResetError(
                errno.ECONNRESET, f"fault plan dropped {host} @{frame}")
        if trunc is not None:
            with self._lock:
                self.events.append((host, "truncate",
                                    f"conn={conn} frame={frame} "
                                    f"keep={trunc.arg}"))
            return data[:trunc.arg]     # caller writes this, then dies
        if corr is not None:
            with self._lock:
                self.events.append((host, "corrupt",
                                    f"conn={conn} frame={frame} "
                                    f"offset={corr.arg}"))
            mutated = bytearray(data)
            if mutated:
                mutated[min(corr.arg, len(mutated) - 1)] ^= 0xFF
            return bytes(mutated)
        return data

    def _truncates(self, host: str, conn: int, frame: int) -> bool:
        """Peek (without consuming) whether frame ``frame`` is a truncate
        target — the wrapper must kill the connection after the partial
        write."""
        with self._lock:
            for key in (host, self.ANY):
                for r in self._rules.get(key, ()):
                    if r.kind == "truncate" and r.remaining == 0 \
                            and (r.conn is None or r.conn == conn) \
                            and r.frame == frame:
                        return True
        return False

    def _on_append(self, host: str, blocks: int) -> None:
        with self._lock:
            rule = None
            for key in (host, self.ANY):
                for r in self._rules.get(key, ()):
                    if r.kind == "disk_full" and r.remaining > 0 \
                            and blocks >= r.frame:
                        rule = r
                        break
                if rule is not None:
                    break
            if rule is None:
                return
            rule.remaining -= 1
            self.events.append((host, "disk_full", f"block={blocks}"))
        raise OSError(errno.ENOSPC,
                      f"fault plan: no space on {host} journal @{blocks}")


class _FaultedFile:
    """File-object shim: one ``write()`` == one frame (the sink's
    contract), reads/flush/close delegate."""

    def __init__(self, plan: FaultPlan, host: str, conn: int, raw):
        self._plan = plan
        self._host = host
        self._conn = conn
        self._raw = raw
        self.frames = 0

    def write(self, data):
        frame = self.frames
        self.frames += 1        # dropped frames still count: determinism
        out = self._plan._on_write(self._host, self._conn, frame, data)
        n = self._raw.write(out)
        if len(out) < len(data) \
                and self._plan._truncates(self._host, self._conn, frame):
            # a torn frame must actually reach the peer before this side
            # dies, or the test degenerates into a plain drop
            self._raw.flush()
            raise ConnectionResetError(
                errno.ECONNRESET,
                f"fault plan truncated {self._host} @{frame}")
        return n

    def read(self, *a, **kw):
        return self._raw.read(*a, **kw)

    def readinto(self, *a, **kw):
        return self._raw.readinto(*a, **kw)

    def flush(self):
        return self._raw.flush()

    def close(self):
        return self._raw.close()

    def __getattr__(self, name):
        return getattr(self._raw, name)


class _FaultedJournal:
    """SpillStore proxy: ``append_block`` honors ``disk_full`` rules."""

    def __init__(self, plan: FaultPlan, host: str, store):
        self._plan = plan
        self._host = host
        self._store = store

    def append_block(self, *cols, sync: bool = False) -> int:
        self._plan._on_append(self._host, self._store.blocks)
        return self._store.append_block(*cols, sync=sync)

    def __getattr__(self, name):
        return getattr(self._store, name)
