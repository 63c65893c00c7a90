"""Rule engine: findings, annotations, suppressions, baseline.

The engine is deliberately small.  A *rule* is a callable
``rule(project) -> list[Finding]``; the engine owns everything around the
rules — parsing files once into a shared :class:`~repro_torch.lint.analysis.Project`,
extracting comments with ``tokenize`` (so a ``#`` inside a string never
reads as an annotation), matching ``# lint: disable=RULE(reason)``
suppressions, and diffing surviving findings against the committed
baseline file.
"""
from __future__ import annotations

import io
import json
import re
import tokenize
from dataclasses import dataclass, field

# --- comment + annotation extraction -----------------------------------

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=(?P<items>.+)$")
_SUPPRESS_ITEM_RE = re.compile(r"(?P<rule>[\w-]+)\s*(?:\((?P<reason>[^)]*)\))?")
_GUARD_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>[A-Za-z_][\w.]*)")
_PUBLISH_RE = re.compile(r"#\s*publishes:\s*(?P<names>[A-Za-z_][\w.]*(?:\s*,\s*[A-Za-z_][\w.]*)*)")
_EVENT_LOOP_RE = re.compile(r"#\s*lint:\s*event-loop\b")


def extract_comments(source: str) -> dict[int, str]:
    """Map line number -> comment text for every ``#`` comment.

    Uses ``tokenize`` rather than string scanning so ``#`` characters
    inside string literals are never mistaken for comments.  Returns an
    empty map on tokenize errors (the caller reports syntax errors via
    ``ast.parse`` instead).
    """
    comments: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                comments[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return {}
    return comments


@dataclass
class Suppression:
    rule: str
    reason: str
    line: int
    used: bool = False


def parse_suppressions(comments: dict[int, str]) -> dict[int, list[Suppression]]:
    out: dict[int, list[Suppression]] = {}
    for line, text in comments.items():
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        items = []
        for im in _SUPPRESS_ITEM_RE.finditer(m.group("items")):
            items.append(Suppression(rule=im.group("rule"),
                                     reason=(im.group("reason") or "").strip(),
                                     line=line))
        if items:
            out[line] = items
    return out


def guard_annotation(comments: dict[int, str], line: int) -> str | None:
    text = comments.get(line)
    if not text:
        return None
    m = _GUARD_RE.search(text)
    return m.group("lock") if m else None


def publish_annotation(comments: dict[int, str], line: int) -> list[str] | None:
    text = comments.get(line)
    if not text:
        return None
    m = _PUBLISH_RE.search(text)
    if not m:
        return None
    return [n.strip() for n in m.group("names").split(",")]


def is_event_loop_annotation(comments: dict[int, str], line: int) -> bool:
    text = comments.get(line)
    return bool(text and _EVENT_LOOP_RE.search(text))


# --- findings ----------------------------------------------------------


@dataclass
class Finding:
    """One rule violation.

    ``symbol`` is a line-number-free identity (``qualname:detail``) used
    for baseline fingerprints so entries survive unrelated line drift.
    """

    rule: str
    path: str
    line: int
    message: str
    symbol: str
    suppressed_by: str | None = None  # reason text when suppressed/baselined

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "message": self.message, "fingerprint": self.fingerprint}
        if self.suppressed_by is not None:
            d["reason"] = self.suppressed_by
        return d


# --- baseline ----------------------------------------------------------


class Baseline:
    """Committed ledger of accepted findings, each with a justification.

    Format (``lint-baseline.json``)::

        {"version": 1,
         "entries": {"<rule>:<path>:<symbol>": "<why this is acceptable>"}}

    A baseline entry that no longer matches any finding is *stale* and
    fails the run: either the underlying issue was fixed (delete the
    entry) or the code moved in a way that needs a fresh look.
    """

    VERSION = 1

    def __init__(self, entries: dict[str, str] | None = None):
        self.entries = dict(entries or {})
        self.matched: set[str] = set()

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if data.get("version") != cls.VERSION:
            raise ValueError(f"unsupported baseline version in {path}: "
                             f"{data.get('version')!r}")
        entries = data.get("entries", {})
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in entries.items()):
            raise ValueError(f"malformed baseline entries in {path}")
        return cls(entries)

    def match(self, finding: Finding) -> str | None:
        reason = self.entries.get(finding.fingerprint)
        if reason is not None:
            self.matched.add(finding.fingerprint)
        return reason

    @property
    def stale(self) -> list[str]:
        return sorted(set(self.entries) - self.matched)

    @staticmethod
    def write(path: str, findings: list[Finding], reason: str) -> None:
        entries = {f.fingerprint: (f.suppressed_by or reason)
                   for f in findings}
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": Baseline.VERSION,
                       "entries": dict(sorted(entries.items()))},
                      f, indent=2, sort_keys=False)
            f.write("\n")


# --- orchestration -----------------------------------------------------


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)      # live
    suppressed: list[Finding] = field(default_factory=list)    # inline-disabled
    baselined: list[Finding] = field(default_factory=list)
    stale_baseline: list[str] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)            # parse failures

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale_baseline and not self.errors

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
            "baselined": [f.to_json() for f in self.baselined],
            "stale_baseline": self.stale_baseline,
            "errors": self.errors,
        }


def _suppression_for(finding: Finding, module) -> Suppression | None:
    """Inline suppression lookup: any line of the offending statement's
    span, or the signature lines of the enclosing ``def``."""
    spans = module.suppress_spans_for_line(finding.line)
    for line in spans:
        for sup in module.suppressions.get(line, ()):  # pragma: no branch
            if sup.rule == finding.rule:
                return sup
    return None


def run_lint(paths: list[str], baseline: Baseline | None = None,
             rules=None) -> LintResult:
    """Parse ``paths`` once, run every rule, fold suppressions + baseline."""
    from repro_torch.lint import analysis
    from repro_torch.lint.blocking import check_loop_blocking
    from repro_torch.lint.guarded import check_guarded_by
    from repro_torch.lint.lockorder import check_lock_order
    from repro_torch.lint.publication import check_publication_order

    if rules is None:
        rules = (check_guarded_by, check_lock_order, check_loop_blocking,
                 check_publication_order)

    project = analysis.Project.load(paths)
    result = LintResult(errors=list(project.errors))

    raw: list[Finding] = []
    for rule in rules:
        raw.extend(rule(project))
    raw.sort(key=lambda f: (f.path, f.line, f.rule, f.message))

    for finding in raw:
        module = project.by_path.get(finding.path)
        sup = _suppression_for(finding, module) if module is not None else None
        if sup is not None:
            sup.used = True
            if not sup.reason:
                # An excuse without a justification is itself a finding.
                result.findings.append(Finding(
                    rule=finding.rule, path=finding.path, line=sup.line,
                    message=(f"suppression of [{finding.rule}] has no reason "
                             f"— use # lint: disable={finding.rule}(why)"),
                    symbol=finding.symbol + ":no-reason"))
                continue
            finding.suppressed_by = sup.reason
            result.suppressed.append(finding)
            continue
        if baseline is not None:
            reason = baseline.match(finding)
            if reason is not None:
                finding.suppressed_by = reason
                result.baselined.append(finding)
                continue
        result.findings.append(finding)

    if baseline is not None:
        result.stale_baseline = baseline.stale
    return result
