"""The port's copy of the concurrency lint (``repro_torch.lint``) against the
reference's (``repro.lint``), on the CPU.

Exactly: the findings on every fixture (rule, path, symbol, line,
message), suppressions and the baseline's round trip and staleness, the
CLI's exit codes and JSON, and the number of checks each rule makes over
``src`` with and without the copy in it (its modules repeat the
reference's class, method and attribute names, which the rules resolve
across the whole tree).  The port's runtime ``LockWatchdog`` finds the
same sequential ABBA as the reference's (tests/test_lint.py).
"""
import ast
import importlib
import json
import os
import subprocess
import sys
import threading

import pytest

from repro import lint as jlint
from repro_torch import lint as tlint
from repro_torch.lint.engine import Baseline
from repro_torch.lint.watchdog import LockWatchdog, _LockProxy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join("tests", "lint_fixtures")
FIXTURES = sorted(f for f in os.listdir(os.path.join(ROOT, FIXTURE_DIR))
                  if f.endswith(".py"))
COPY = os.path.join("src", "repro_torch", "lint")


def _key(f):
    return (f.rule, f.path, f.symbol, f.line, f.message, f.suppressed_by)


def test_the_copy_has_the_reference_rules_and_modules():
    assert tlint.RULES == jlint.RULES
    def sources(d):
        return sorted(f for f in os.listdir(os.path.join(ROOT, d))
                      if f.endswith(".py"))
    assert sources(COPY) == sources(os.path.join("src", "repro", "lint"))


@pytest.mark.parametrize("name", FIXTURES)
def test_findings_on_each_fixture_equal_the_reference(name, monkeypatch):
    monkeypatch.chdir(ROOT)
    path = os.path.join(FIXTURE_DIR, name)
    want, got = jlint.run_lint([path]), tlint.run_lint([path])
    assert [_key(f) for f in got.findings] == \
        [_key(f) for f in want.findings]
    assert [_key(f) for f in got.suppressed] == \
        [_key(f) for f in want.suppressed]
    assert got.errors == want.errors
    assert bool(want.findings) == name.startswith("bad_")


def test_baseline_round_trip_and_staleness_equal_the_reference(
        tmp_path, monkeypatch):
    """A baseline written by either package silences the same findings in
    both, and against a clean file every entry is stale in both."""
    monkeypatch.chdir(ROOT)
    bad = [os.path.join(FIXTURE_DIR, "bad_guarded.py")]
    good = [os.path.join(FIXTURE_DIR, "good_guarded.py")]
    paths = {}
    for name, pkg in (("ref", jlint), ("port", tlint)):
        paths[name] = str(tmp_path / f"{name}.json")
        pkg.Baseline.write(paths[name], pkg.run_lint(bad).findings,
                           reason="accepted for test")
    with open(paths["ref"]) as a, open(paths["port"]) as b:
        assert a.read() == b.read()
    for pkg in (jlint, tlint):
        res = pkg.run_lint(bad, baseline=pkg.Baseline.load(paths["port"]))
        assert res.findings == [] and len(res.baselined) == 4 and res.ok
        res = pkg.run_lint(good, baseline=pkg.Baseline.load(paths["port"]))
        assert len(res.stale_baseline) == 4 and not res.ok
    with pytest.raises(ValueError):
        bad_file = tmp_path / "bad.json"
        bad_file.write_text(json.dumps({"version": 2, "entries": {}}))
        Baseline.load(str(bad_file))


def _cli(module, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=120)


@pytest.mark.parametrize("args", [
    ("--no-baseline", "--json", os.path.join(FIXTURE_DIR, "bad_blocking.py")),
    ("--no-baseline", "--json", os.path.join(FIXTURE_DIR, "good_guarded.py")),
    ("--json", "--exclude", FIXTURE_DIR, "src"),
    ("--json", "--baseline", "missing.json", os.path.join(FIXTURE_DIR,
                                                          "bad_lock_order.py")),
    ("--no-baseline", os.path.join(FIXTURE_DIR, "bad_publication.py")),
    (os.path.join(FIXTURE_DIR, "no_such_dir"),),
], ids=["bad-json", "good-json", "src-json", "no-baseline-file", "text",
        "no-files"])
def test_cli_gives_the_reference_exit_codes_and_json(args):
    want, got = _cli("repro.lint", *args), _cli("repro_torch.lint", *args)
    assert got.returncode == want.returncode
    if "--json" in args:
        assert json.loads(got.stdout) == json.loads(want.stdout)
    else:
        assert got.stdout.replace("repro_torch.lint:", "repro.lint:") == \
            want.stdout
        assert got.stderr.replace("repro_torch.lint:", "repro.lint:") == \
            want.stderr


def _check_counts(pkg: str, files: list) -> dict:
    """The checks each rule of ``pkg`` makes over ``files``, counted
    outside the copy: guarded-by's mutations bound to a contract and
    calls into contracted methods; lock-order's (edge, site) pairs;
    loop-blocking's functions reachable from an event-loop root and the
    calls it examines there; publication-order's publication points."""
    an = importlib.import_module(f"{pkg}.analysis")
    guarded = importlib.import_module(f"{pkg}.guarded")
    lockorder = importlib.import_module(f"{pkg}.lockorder")
    blocking = importlib.import_module(f"{pkg}.blocking")
    engine = importlib.import_module(f"{pkg}.engine")
    project = an.Project.load(files)

    def outside(path):
        return not os.path.normpath(path).startswith(COPY + os.sep)
    mutations = contracted = points = 0
    for module in project.modules:
        if not outside(module.path):
            continue
        points += sum(1 for line in module.comments
                      if engine.publish_annotation(module.comments, line))
        for func in module.all_functions:
            for stmt, _ in func.iter_with_held(project):
                mutations += sum(
                    1 for path, _ in guarded._mutation_paths(stmt)
                    if guarded._owner_for(path, func, project)[0] is not None)
            for call, _, _ in func.call_sites(project):
                contracted += sum(
                    1 for callee in project.resolve_call(call, func)
                    if callee.contract is not None and callee is not func)
    reach = [f for f in blocking._reachable_from_roots(project)
             if outside(f.module.path)]
    return {
        "guarded-by": (mutations, contracted),
        "lock-order": sorted((edge, site) for edge, sites in
                             lockorder._build_edges(project).items()
                             for site in sites if outside(site[0])),
        "loop-blocking": (len(reach), sum(
            1 for f in reach for _ in f.call_sites(project))),
        "publication-order": points,
    }


def test_the_copy_makes_neither_lint_skip_a_check(monkeypatch):
    """Each rule of each package makes the same checks over ``src`` with
    the copy as without it (tests/test_lint.py::test_src_tree_lints_clean
    lints both packages with the reference's lint), and the two packages
    make the same checks."""
    from repro.lint.runner import collect_files
    monkeypatch.chdir(ROOT)
    with_copy = collect_files(["src"])
    without = collect_files(["src"], exclude=[COPY])
    assert set(with_copy) - set(without) == {
        os.path.join(COPY, f) for f in os.listdir(COPY) if f.endswith(".py")}
    want = _check_counts("repro.lint", without)
    assert want["guarded-by"][0] > 0 and want["lock-order"]
    assert want["loop-blocking"][0] > 0 and want["publication-order"] > 0
    assert _check_counts("repro.lint", with_copy) == want
    assert _check_counts("repro_torch.lint", with_copy) == want


def test_the_copy_lints_clean_under_both_packages(monkeypatch):
    monkeypatch.chdir(ROOT)
    files = [os.path.join(COPY, f) for f in sorted(os.listdir(COPY))
             if f.endswith(".py")]
    for pkg in (jlint, tlint):
        res = pkg.run_lint(files)
        assert res.errors == [] and res.findings == []
    for f in files:
        tree = ast.parse(open(f).read(), f)
        mods = {n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.module}
        assert not any(m == "repro" or m.startswith("repro.") for m in mods)


# ---------------------------------------------------------------------------
# the port's runtime watchdog
# ---------------------------------------------------------------------------

@pytest.fixture
def _session_graph_guard(lock_order_watchdog):
    """The test below creates a cyclic acquisition order ON PURPOSE, and
    the session-wide watchdog (the reference's, tests/conftest.py) proxies
    its locks too: restore that watchdog's edge graph afterwards, or the
    deliberate ABBA would fail the whole session at teardown (as
    tests/test_lint.py does)."""
    if lock_order_watchdog is None:
        yield
        return
    with lock_order_watchdog._mu:
        snapshot = dict(lock_order_watchdog.edges)
    yield
    with lock_order_watchdog._mu:
        lock_order_watchdog.edges.clear()
        lock_order_watchdog.edges.update(snapshot)


@pytest.mark.usefixtures("_session_graph_guard")
def test_port_watchdog_detects_sequential_abba():
    wd = LockWatchdog()
    wd.install()
    try:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:        # opposite order: never deadlocks in this run,
            with a:    # but the order graph now has a cycle
                pass
    finally:
        wd.uninstall()
    cycles = wd.cycles()
    assert cycles, "ABBA acquisition order not detected"
    assert "->" in cycles[0] and "test_torch_lint.py" in cycles[0]


def test_port_watchdog_accepts_a_consistent_hierarchy():
    wd = LockWatchdog()
    wd.install()
    try:
        a, b = threading.Lock(), threading.RLock()
        for _ in range(3):
            with a:
                with b:
                    with b:        # re-entrant: no self-edge
                        pass
    finally:
        wd.uninstall()
    assert wd.cycles() == []
    assert isinstance(a, _LockProxy)
    assert not isinstance(threading.Lock(), _LockProxy)   # uninstalled
