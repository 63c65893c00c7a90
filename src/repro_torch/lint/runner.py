"""CLI for the concurrency lint: ``python -m repro_torch.lint [paths...]``.

Exit codes: 0 clean, 1 findings (or stale baseline entries), 2 usage or
parse errors.  ``--json`` emits the machine-readable report CI archives;
the default text output is one ``path:line: [rule] message`` per finding.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.lint.engine import Baseline, run_lint

DEFAULT_BASELINE = "lint-baseline.json"


def collect_files(paths: list[str],
                  exclude: list[str] | None = None) -> list[str]:
    skip = [os.path.normpath(e) for e in (exclude or [])]

    def excluded(p: str) -> bool:
        q = os.path.normpath(p)
        return any(q == e or q.startswith(e + os.sep) for e in skip)

    files: list[str] = []
    for path in paths:
        if os.path.isdir(path):
            for root, dirs, names in os.walk(path):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git")
                                 and not excluded(os.path.join(root, d)))
                for name in sorted(names):
                    if name.endswith(".py") \
                            and not excluded(os.path.join(root, name)):
                        files.append(os.path.join(root, name))
        elif not excluded(path):
            files.append(path)
    return files


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="concurrency lint: guarded-by, lock-order, "
                    "loop-blocking, publication-order")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories to lint (default: src)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the JSON report instead of text")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help=f"baseline file (default {DEFAULT_BASELINE})")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline file")
    parser.add_argument("--exclude", action="append", default=[],
                        metavar="PATH",
                        help="path prefix to skip (repeatable; e.g. "
                             "tests/lint_fixtures, whose bad_*.py must "
                             "keep flagging in the fixture self-check)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept current findings into the baseline "
                             "(reasons default to TODO and must be edited)")
    args = parser.parse_args(argv)

    paths = args.paths or ["src"]
    files = collect_files(paths, exclude=args.exclude)
    if not files:
        print(f"repro_torch.lint: no python files under {paths}", file=sys.stderr)
        return 2

    baseline = None
    if not args.no_baseline and not args.write_baseline \
            and os.path.exists(args.baseline):
        try:
            baseline = Baseline.load(args.baseline)
        except (ValueError, OSError, json.JSONDecodeError) as exc:
            print(f"repro_torch.lint: bad baseline: {exc}", file=sys.stderr)
            return 2

    result = run_lint(files, baseline=baseline)

    if args.write_baseline:
        for f in result.findings:
            f.suppressed_by = None
        Baseline.write(args.baseline, result.findings,
                       reason="TODO: justify this accepted finding")
        print(f"wrote {len(result.findings)} entr"
              f"{'y' if len(result.findings) == 1 else 'ies'} to "
              f"{args.baseline}; edit the reasons before committing")
        return 0

    if args.as_json:
        print(json.dumps(result.to_json(), indent=2))
    else:
        for err in result.errors:
            print(f"error: {err}")
        for f in result.findings:
            print(f.render())
        for fp in result.stale_baseline:
            print(f"stale baseline entry (fixed? delete it): {fp}")
        bits = [f"{len(result.findings)} finding"
                f"{'' if len(result.findings) == 1 else 's'}"]
        if result.suppressed:
            bits.append(f"{len(result.suppressed)} suppressed inline")
        if result.baselined:
            bits.append(f"{len(result.baselined)} baselined")
        if result.stale_baseline:
            bits.append(f"{len(result.stale_baseline)} stale baseline entries")
        print(f"repro_torch.lint: {', '.join(bits)} across {len(files)} files")

    if result.errors:
        return 2
    return 0 if result.ok else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
