"""The port's analyzer (``repro_torch.analysis``) held finding for finding
against the reference's (``repro.analysis``), and the port's runtime
shadow checker held scenario for scenario against the reference's.

Both analyzers run in this one process, under one hash seed, so any order
that comes from set or dict iteration is the same in both: findings are
compared as ``(path, line, rule, context, message)`` in the order the CLI
prints them (``sort_findings``: by path, line and rule, ties in the
analyzer's own order), with the hierarchy's path in the messages
normalised (``repro_torch/analysis/hierarchy.py`` -> the reference's).

* the 20 fixture files of ``tests/analysis/fixtures`` and ``--self-test``;
* the trees ``src/repro``, ``src/repro_torch``, ``src``, ``tests/analysis``
  and ``tests/launch`` (one finding there), each parsed once per analyzer;
* a copy of ``src/repro_torch/serve`` with three planted violations;
* seeded programs (numpy, a fixed seed), 32 to a chunk, each scanned
  alone and every chunk as one tree (its classes share bare names, so the
  analyzers merge them across files);
* the CLI, case by case: exit codes and printed lines;
* the tables, the shipped baseline, and ``chip_smoke.py``'s phase Z.
"""

import ast
import io
import json
import os
import shutil
import sys
import threading

import numpy as np
import pytest

from repro.analysis import cli as ref_cli
from repro.analysis import hierarchy as ref_hierarchy
from repro.analysis import lockorder as ref_lockorder
from repro.analysis import rules as ref_rules
from repro.analysis import shadow as ref_shadow
from repro_torch.analysis import cli, hierarchy, lockorder, rules, shadow
from repro_torch.analysis.findings import sort_findings

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "analysis", "fixtures")
PORT_HIERARCHY = "repro_torch/analysis/hierarchy.py"
REF_HIERARCHY = "repro/analysis/hierarchy.py"

ANALYZERS = {"repro": ref_cli, "repro_torch": cli}


def norm(text: str) -> str:
    return text.replace(PORT_HIERARCHY, REF_HIERARCHY)


def rows(findings):
    """The CLI's order, every field of each finding, messages normalised."""
    return [(f.path, f.line, f.rule, f.context, norm(f.message))
            for f in sort_findings(findings)]


def scan(mod, files):
    findings, errors = mod.scan_files(files)
    return rows(findings), errors


def run_cli(mod, argv):
    out = io.StringIO()
    code = mod.main(argv, out=out)
    return code, norm(out.getvalue()).splitlines()


# -------------------------------------------------------------------------
# the fixture corpus
# -------------------------------------------------------------------------
FIXTURE_FILES = sorted(
    f"{rule}/{kind}" for rule in os.listdir(FIXTURES)
    if os.path.isdir(os.path.join(FIXTURES, rule))
    for kind in ("bad.py", "good.py"))


def test_fixture_corpus_has_a_bad_and_a_good_file_per_rule():
    assert len(FIXTURE_FILES) == 20 == 2 * len(rules.RULE_DOCS)
    assert {f.split("/")[0] for f in FIXTURE_FILES} == set(rules.RULE_DOCS)


@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_fixture_gives_the_references_findings(fixture):
    path = os.path.join(FIXTURES, fixture)
    got, want = scan(cli, [path]), scan(ref_cli, [path])
    assert got == want
    rule, kind = fixture.split("/")
    hits = [r for r in got[0] if r[2] == rule]
    assert bool(hits) == (kind == "bad.py"), got


def test_self_test_reports_what_the_references_reports():
    out, ref_out = io.StringIO(), io.StringIO()
    assert cli.self_test(out=out) == ref_cli.self_test(out=ref_out) == 0
    assert out.getvalue() == ref_out.getvalue() == \
        "self-test: 20 fixture checks, 0 failures\n"


# -------------------------------------------------------------------------
# the trees
# -------------------------------------------------------------------------
TREES = ("src/repro", "src/repro_torch", "src", "tests/analysis",
         "tests/launch")


@pytest.fixture(scope="module")
def tree_scans():
    """Each tree's files and each analyzer's findings, parsed once."""
    cache = {}

    def get(tree):
        if tree not in cache:
            files = cli.collect_files([os.path.join(REPO, tree)])
            cache[tree] = (files, ref_cli.collect_files(
                [os.path.join(REPO, tree)]),
                {name: scan(mod, files) for name, mod in ANALYZERS.items()})
        return cache[tree]
    return get


@pytest.mark.parametrize("tree", TREES)
def test_tree_gives_the_references_findings(tree, tree_scans):
    files, ref_files, found = tree_scans(tree)
    assert files == ref_files and files
    assert found["repro_torch"] == found["repro"]
    assert found["repro_torch"][1] == []          # no parse error
    if tree.startswith("src"):
        # the gates of both packages: every tree of src scans clean
        assert found["repro_torch"][0] == []
    if tree == "tests/launch":
        assert [r[2] for r in found["repro_torch"][0]] == \
            ["env-import-snapshot"]


#: (file under serve/, text there, what replaces it, the rule it plants)
SERVE_FAULTS = (
    # service.cond (rank 3) held around service.reader_lock (rank 2)
    ("service.py",
     "        with self._reader_lock:\n"
     "            engines = list(self._engines)",
     "        with self._cond, self._reader_lock:\n"
     "            engines = list(self._engines)", "lock-order"),
    # the transport's condition waited on outside its with block
    ("transport.py",
     "            self._cond.wait(timeout)\n"
     "            now = self._committed\n",
     "        self._cond.wait(timeout)\n"
     "        with self._cond:\n"
     "            now = self._committed\n", "cond-wait-unheld"),
    # an anonymous threading.Lock taken under replica.lock
    ("replica.py",
     '        self._lock = make_lock("replica.lock")\n',
     '        self._lock = make_lock("replica.lock")\n'
     '        self._side = threading.Lock()\n', None),
    ("replica.py",
     "        with self._lock:\n"
     "            self._pulls += pulls\n",
     "        with self._lock, self._side:\n"
     "            self._pulls += pulls\n", "lock-undeclared"),
)


def test_planted_serve_copy_gives_the_references_findings(tmp_path):
    serve = tmp_path / "serve"
    shutil.copytree(os.path.join(REPO, "src", "repro_torch", "serve"), serve,
                    ignore=shutil.ignore_patterns("__pycache__"))
    files = cli.collect_files([str(serve)])
    assert scan(cli, files) == scan(ref_cli, files) == ([], [])
    for name, old, new, _ in SERVE_FAULTS:
        text = (serve / name).read_text()
        assert text.count(old) == 1, (name, old)
        (serve / name).write_text(text.replace(old, new))
    got, want = scan(cli, files), scan(ref_cli, files)
    assert got == want
    planted = {rule for *_, rule in SERVE_FAULTS if rule}
    assert {r[2] for r in got[0]} == planted, got
    for name in ("service.py", "transport.py", "replica.py"):
        assert any(r[0] == str(serve / name) for r in got[0]), name
    code, lines = run_cli(cli, [str(serve)])
    assert (code, lines) == run_cli(ref_cli, [str(serve)])
    assert code == 1 and lines[-1] == f"{len(files)} files scanned, " \
        f"{len(got[0])} findings"


# -------------------------------------------------------------------------
# seeded programs
# -------------------------------------------------------------------------
SEED = 20240229
CHUNKS, PER_CHUNK = 8, 32
LOCK_NAMES = tuple(n for n, _ in ref_hierarchy.HIERARCHY) + \
    ("undeclared.lock",)
FACTORIES = ("make_lock", "make_rlock", "make_condition", "threading.Lock",
             "threading.RLock", "threading.Condition", "Lock")
METHODS = ("m0", "m1", "m2", "m3", "probe", "applied", "get", "wait")
PROPS = ("version", "applied", "pending")
ATTRS = ("_x", "_d", "_ticket", "_version", "_n")
NONDET = ("random.random()", "time.time()", 'os.environ["MODE"]',
          'os.environ.get("MODE")', 'os.getenv("MODE")', "np.random.rand()",
          "jax.random.PRNGKey(0)", "resolve_interpret()", "uuid.uuid4()",
          "time.monotonic()", "datetime.now()", "x.sum()")
JIT_DECOS = ("@jax.jit", "@jit", "@functools.partial(jax.jit, "
             "static_argnums=0)", "@partial(jit, donate_argnums=1)",
             "@jax.jit()", "@functools.lru_cache")
IGNORES = ("  # analysis: ignore", "  # analysis: ignore[wall-clock]",
           "  # analysis: ignore[lock-order,lock-undeclared]",
           "  # analysis: ignore[unlocked-attr]")


class ProgramWriter:
    """One seeded module: 1-3 classes whose locks are named from the
    hierarchy (and one undeclared name) or made raw, with nested with
    blocks, acquire / release (also in if / elif branches), waits and
    notifies in and out of their with, self-calls, calls through
    annotated and constructed attributes, property loads, attributes
    read and written in and out of a lock and ``@locks_required``; and
    the rule snippets (env reads at import, truthy versions, wall-clock
    deadlines, broad excepts, nondeterminism in ``jit`` bodies).  The
    text is parsed, never imported."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng([SEED, seed])
        self.lines = []

    def pick(self, seq):
        return seq[int(self.rng.integers(len(seq)))]

    def chance(self, p: float) -> bool:
        return bool(self.rng.random() < p)

    def emit(self, ind: int, text: str) -> None:
        tail = self.pick(IGNORES) if self.chance(0.04) else ""
        self.lines.append("    " * ind + text + tail)

    def program(self) -> str:
        self.emit(0, "import functools, os, random, threading, time, uuid")
        self.emit(0, "from repro.analysis.shadow import locks_required, "
                     "make_condition, make_lock, make_rlock")
        if self.chance(0.3):
            self.emit(0, f"FLAG = {self.pick(NONDET[2:5])}")
        if self.chance(0.2):
            self.emit(0, "if version:")
            self.emit(1, "pass")
        for k in range(int(self.rng.integers(0, 3))):
            self.jit_function(k)
        classes = [f"C{k}" for k in range(int(self.rng.integers(1, 4)))]
        for cls in classes:
            self.klass(cls, classes)
        return "\n".join(self.lines) + "\n"

    def jit_function(self, k: int) -> None:
        self.emit(0, self.pick(JIT_DECOS))
        self.emit(0, f"def f{k}(x, y=None):")
        for _ in range(int(self.rng.integers(1, 3))):
            self.emit(1, f"r = {self.pick(NONDET)}")
        if self.chance(0.3):
            self.emit(1, "def inner():")
            self.emit(2, f"return {self.pick(NONDET)}")
        self.emit(1, "return x")

    def klass(self, cls: str, classes: list) -> None:
        self.emit(0, f"class {cls}:")
        if self.chance(0.2):
            self.emit(1, f"DEFAULT = {self.pick(NONDET[2:5])}")
        n_locks = int(self.rng.integers(1, 4))
        self.locks = [f"_l{i}" for i in range(n_locks)]
        peer = self.pick(classes)
        self.emit(1, f"def __init__(self, peer: {peer} = None, "
                     f"other: 'mod.{self.pick(classes)}' = None):")
        for attr in self.locks:
            fac = self.pick(FACTORIES)
            if fac.startswith("make_"):
                self.emit(2, f'self.{attr} = {fac}("{self.pick(LOCK_NAMES)}")')
            else:
                self.emit(2, f"self.{attr} = {fac}()")
        self.emit(2, "self._peer = peer")
        self.emit(2, "self._other = other")
        self.emit(2, f"self._made = {self.pick(classes)}()")
        if self.chance(0.3):
            self.emit(2, f"self._typed: {self.pick(classes)} = make()")
        for attr in ATTRS:
            if self.chance(0.6):
                self.emit(2, f"self.{attr} = 0")
        for name in PROPS:
            if self.chance(0.3):
                self.emit(1, "@property")
                self.emit(1, f"def {name}(self):")
                self.body(2, 1)
                self.emit(2, f"return self.{self.pick(ATTRS)}")
        for name in METHODS[:int(self.rng.integers(2, len(METHODS) + 1))]:
            if self.chance(0.25):
                self.emit(1, f'@locks_required("{self.pick(LOCK_NAMES)}")')
            self.emit(1, f"def {name}(self, version=None, ticket=0):")
            self.body(2, 0)

    def lock(self) -> str:
        return "self." + self.pick(self.locks)

    def body(self, ind: int, depth: int) -> None:
        for _ in range(int(self.rng.integers(1, 4))):
            self.statement(ind, depth)

    def statement(self, ind: int, depth: int) -> None:
        kinds = ["with", "with2", "acquire", "branch", "wait", "call",
                 "prop", "store", "load", "truthy", "clock", "except",
                 "env", "lambda"]
        if depth < 3:
            kinds += ["with", "with", "nested_def", "loop", "try"]
        kind = self.pick(kinds) if depth < 4 else "load"
        e = self.emit
        if kind == "with":
            e(ind, f"with {self.lock()}:")
            self.body(ind + 1, depth + 1)
        elif kind == "with2":
            e(ind, f"with {self.lock()}, {self.lock()}:")
            self.body(ind + 1, depth + 1)
        elif kind == "acquire":
            lk = self.lock()
            if self.chance(0.3):
                e(ind, f"if not {lk}.acquire(timeout=0.1):")
                e(ind + 1, "return")
            else:
                e(ind, f"{lk}.acquire()")
            if self.chance(0.5):
                self.statement(ind, depth + 1)
            if self.chance(0.7):
                e(ind, f"{lk}.release()")
        elif kind == "branch":
            a, b = self.lock(), self.lock()
            e(ind, f"if self.{self.pick(ATTRS)} > 1:")
            e(ind + 1, f"{a}.acquire()")
            if self.chance(0.6):
                e(ind, "elif ticket:")
                e(ind + 1, f"{b}.acquire()")
            if self.chance(0.5):
                e(ind, "else:")
                self.body(ind + 1, depth + 1)
            self.statement(ind, depth + 1)
            if self.chance(0.5):
                e(ind, f"{a}.release()")
        elif kind == "wait":
            op = self.pick(("wait(0.01)", "wait_for(lambda: True, 0.01)",
                            "notify()", "notify_all()"))
            e(ind, f"{self.lock()}.{op}")
        elif kind == "call":
            recv = self.pick(("self", "self._peer", "self._other",
                              "self._made", "self._typed", "other",
                              "self._d"))
            e(ind, f"r = {recv}.{self.pick(METHODS)}()")
        elif kind == "prop":
            recv = self.pick(("self", "self._peer", "self._made", "svc"))
            e(ind, f"v = {recv}.{self.pick(PROPS)}")
        elif kind == "store":
            attr = self.pick(ATTRS)
            e(ind, self.pick((f"self.{attr} = 1", f"self.{attr} += 1",
                              f"self.{attr}[ticket] = 2",
                              f"self.{attr}: int = 3")))
        elif kind == "load":
            e(ind, f"y = self.{self.pick(ATTRS)}")
        elif kind == "truthy":
            test = self.pick(("version", "not ticket", "self._version",
                              "self._ticket and version", "at_version",
                              "version is None", "self._n"))
            form = self.pick(("if", "while", "assert", "or", "ifexp",
                              "comp"))
            if form == "if":
                e(ind, f"if {test}:")
                e(ind + 1, "pass")
            elif form == "while":
                e(ind, f"while {test}:")
                e(ind + 1, "break")
            elif form == "assert":
                e(ind, f"assert {test}")
            elif form == "or":
                e(ind, f"z = {test} or 0")
            elif form == "ifexp":
                e(ind, f"z = 1 if {test} else 2")
            else:
                e(ind, f"z = [i for i in range(3) if {test}]")
        elif kind == "clock":
            e(ind, self.pick(("deadline = time.time() + 1.0",
                              "left = deadline - time.monotonic()",
                              "stamp = time.time()")))
        elif kind == "except":
            e(ind, "try:")
            e(ind + 1, f"r = self.{self.pick(METHODS)}()")
            handler = self.pick(("except Exception:", "except:",
                                 "except Exception as exc:",
                                 "except (ValueError, BaseException):",
                                 "except builtins.Exception:",
                                 "except ValueError:"))
            e(ind, handler)
            e(ind + 1, self.pick(("pass", "raise", "self._fail(exc)",
                                  "log(exc)", "self._x = 1")))
        elif kind == "try":
            e(ind, "try:")
            self.body(ind + 1, depth + 1)
            e(ind, "finally:")
            self.body(ind + 1, depth + 1)
        elif kind == "env":
            e(ind, f"mode = {self.pick(NONDET[2:5])}")
        elif kind == "lambda":
            e(ind, f"cb = lambda: {self.lock()}.acquire()")
        elif kind == "nested_def":
            e(ind, f"def inner{depth}():")
            self.body(ind + 1, depth + 1)
            e(ind, f"inner{depth}()")
        elif kind == "loop":
            e(ind, self.pick(("for i in range(2):", "while self._x:")))
            self.body(ind + 1, depth + 1)


@pytest.fixture(scope="module")
def program_chunks(tmp_path_factory):
    """CHUNKS directories of PER_CHUNK seeded programs each, with the
    reference's findings on each program alone."""
    root = tmp_path_factory.mktemp("programs")
    chunks = []
    for c in range(CHUNKS):
        d = root / f"chunk{c}"
        d.mkdir()
        files = {}
        for i in range(PER_CHUNK):
            path = d / f"p{i:02d}.py"
            path.write_text(ProgramWriter(c * PER_CHUNK + i).program())
            files[str(path)] = scan(ref_cli, [str(path)])
        chunks.append((str(d), files))
    return chunks


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_seeded_programs_give_the_references_findings(chunk,
                                                      program_chunks):
    d, files = program_chunks[chunk]
    for path, want in files.items():
        assert scan(cli, [path]) == want, path
        assert want[1] == [], want[1]
    # the chunk as one tree: C0..C2 of every program merge by bare name
    assert run_cli(cli, [d]) == run_cli(ref_cli, [d])


def test_seeded_programs_reach_every_rule(program_chunks):
    found = [want for _, files in program_chunks for want in files.values()]
    assert len(found) >= 200
    assert {r[2] for rows_, _ in found for r in rows_} == \
        set(rules.RULE_DOCS)
    # most programs give findings of more than one rule
    assert sum(len({r[2] for r in rows_}) > 1 for rows_, _ in found) > 150


# -------------------------------------------------------------------------
# the CLI, case by case
# -------------------------------------------------------------------------
CLEAN = "import time\n\ndef left(deadline):\n" \
        "    return deadline - time.monotonic()\n"
BAD = "import time\ndef deadline(t):\n    return time.time() + t\n"


def _write(d, files):
    for name, text in files.items():
        path = d / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def _then_new_finding(d):
    _write(d, {"bad.py": BAD + "def window(t):\n"
                               "    return time.time() - t\n"})


#: name -> (files, steps, exit codes); a step is an argv list ("{d}"
#: stands for the case's directory) or a callable that edits the files
CLI_CASES = {
    "clean_file": ({"clean.py": CLEAN}, [["{d}/clean.py"]], [0]),
    "one_finding": ({"bad.py": BAD}, [["{d}/bad.py"]], [1]),
    "syntax_error": ({"broken.py": "def f(:\n", "clean.py": CLEAN},
                     [["{d}"]], [2]),
    "write_baseline_then_baselined": (
        {"bad.py": BAD},
        [["--baseline", "{d}/base.json", "--write-baseline", "{d}/bad.py"],
         ["--baseline", "{d}/base.json", "{d}/bad.py"]], [0, 0]),
    "new_finding_after_baseline": (
        {"bad.py": BAD},
        [["--baseline", "{d}/base.json", "--write-baseline", "{d}/bad.py"],
         _then_new_finding,
         ["--baseline", "{d}/base.json", "{d}/bad.py"]], [0, 1]),
    "malformed_baseline": ({"bad.py": BAD, "base.json": '{"a": 1}\n'},
                           [["--baseline", "{d}/base.json", "{d}"]], [2]),
    "inline_ignore": ({"stamp.py": "import time\n"
                                   "STAMP = time.time()  # analysis: "
                                   "ignore[wall-clock]\n"},
                      [["{d}"]], [0]),
    "list_rules": ({}, [["--list-rules"]], [0]),
    "self_test": ({}, [["--self-test"]], [0]),
    "no_python_files": ({"notes.txt": "x\n"}, [["{d}"]], [2]),
    "skipped_fixtures_directory": (
        {"fixtures/bad.py": BAD, "__pycache__/bad.py": BAD,
         "pkg/clean.py": CLEAN}, [["{d}"]], [0]),
}


def _run_case(mod, d, case):
    files, steps, _ = CLI_CASES[case]
    if d.exists():
        shutil.rmtree(d)
    d.mkdir()
    _write(d, files)
    out = []
    for step in steps:
        if callable(step):
            step(d)
            continue
        out.append(run_cli(mod, [a.replace("{d}", str(d)) for a in step]))
    base = d / "base.json"
    return out, (base.read_text() if base.exists() else None)


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_case_gives_the_references_codes_and_lines(case, tmp_path):
    d = tmp_path / "case"
    got, want = _run_case(cli, d, case), _run_case(ref_cli, d, case)
    assert got == want
    runs, baseline_text = got
    assert [code for code, _ in runs] == CLI_CASES[case][2]
    last = runs[-1][1]
    if case == "clean_file":
        assert last == ["1 files scanned, 0 findings"]
    elif case == "one_finding":
        assert last[0].startswith(f"{d}/bad.py:3 wall-clock ")
        assert last[1] == "1 files scanned, 1 findings"
    elif case == "syntax_error":
        assert last[0].startswith(f"parse-error {d}/broken.py: ")
    elif case == "write_baseline_then_baselined":
        assert runs[0][1] == [f"wrote 1 fingerprints to {d}/base.json"]
        assert last == ["1 files scanned, 0 findings (1 baselined)"]
        assert json.loads(baseline_text) == [
            f"{d}/bad.py::wall-clock::deadline::" +
            rules.check_wall_clock("", ast.parse(BAD))[0].message]
    elif case == "new_finding_after_baseline":
        assert last[0].startswith(f"{d}/bad.py:5 wall-clock ")
        assert last[-1] == "1 files scanned, 1 findings (1 baselined)"
    elif case == "malformed_baseline":
        assert last[0].startswith("baseline error: ")
    elif case == "list_rules":
        assert [line.split()[0] for line in last] == sorted(rules.RULE_DOCS)
        assert any(REF_HIERARCHY in line for line in last)
    elif case == "no_python_files":
        assert last == [f"no python files under ['{d}']"]
    elif case == "skipped_fixtures_directory":
        assert last == ["1 files scanned, 0 findings"]


def test_module_entry_point_runs_the_gate(tmp_path):
    import subprocess
    bad = tmp_path / "bad.py"
    bad.write_text(BAD)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(bad)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout.splitlines()[-1] == "1 files scanned, 1 findings"
    assert "jax" not in proc.stderr


# -------------------------------------------------------------------------
# the tables and the shipped baseline
# -------------------------------------------------------------------------
def test_hierarchy_tables_are_the_references():
    assert hierarchy.HIERARCHY == ref_hierarchy.HIERARCHY
    assert hierarchy.RANKS == ref_hierarchy.RANKS
    assert hierarchy.REENTRANT == ref_hierarchy.REENTRANT
    for name in list(hierarchy.RANKS) + ["no.such.lock"]:
        assert hierarchy.describe(name) == ref_hierarchy.describe(name)
    import repro_torch.analysis as pkg
    assert (pkg.HIERARCHY, pkg.RANKS, pkg.REENTRANT) == (
        hierarchy.HIERARCHY, hierarchy.RANKS, hierarchy.REENTRANT)
    assert pkg.Finding.__module__ == "repro_torch.analysis.findings"


def test_rule_tables_are_the_references():
    assert list(rules.ALL_RULES) == list(ref_rules.ALL_RULES)
    assert {k: norm(v) for k, v in rules.RULE_DOCS.items()} == \
        ref_rules.RULE_DOCS
    assert list(rules.RULE_DOCS) == list(ref_rules.RULE_DOCS)
    assert lockorder.LOCK_FACTORIES == ref_lockorder.LOCK_FACTORIES
    assert lockorder.THREADING_CTORS == ref_lockorder.THREADING_CTORS
    assert lockorder._FALLBACK_SKIP == ref_lockorder._FALLBACK_SKIP
    assert cli._SKIP_DIRS == ref_cli._SKIP_DIRS


def test_shipped_baseline_is_empty():
    path = os.path.join(REPO, "src", "repro_torch", "analysis",
                        "baseline.json")
    assert cli._DEFAULT_BASELINE == path
    with open(path) as fh:
        assert json.load(fh) == []


def test_chip_smoke_analysis_phase_on_the_cpu():
    """Phase Z runs on the host alone: the self-test, the clean scan and
    the planted inversion through ``python -m repro_torch.analysis``."""
    sys.path.insert(0, REPO)
    import chip_smoke
    out = chip_smoke.analysis_phase()
    assert out["findings"] == 0 and out["files"] >= 100
    assert out["self_test_checks"] == 20
    assert out["fault_rules"] == ["lock-order"]
    assert chip_smoke.PATH_KERNELS["analysis"] == ()


# -------------------------------------------------------------------------
# the runtime shadow checker, in both packages
# -------------------------------------------------------------------------
@pytest.fixture(params=["repro", "repro_torch"])
def sh(request, monkeypatch):
    """The shadow module of one package, with shadowing on."""
    mod = ref_shadow if request.param == "repro" else shadow
    monkeypatch.setenv(mod.ENV_FLAG, "1")
    return mod


def test_shadow_factories_return_plain_primitives_when_off(sh,
                                                           monkeypatch):
    monkeypatch.delenv(sh.ENV_FLAG, raising=False)
    assert isinstance(sh.make_lock("store.lock"), type(threading.Lock()))
    assert isinstance(sh.make_rlock("service.reader_lock"),
                      type(threading.RLock()))
    assert isinstance(sh.make_condition("service.cond"),
                      threading.Condition)


def test_shadow_env_read_at_call_time(sh, monkeypatch):
    monkeypatch.delenv(sh.ENV_FLAG, raising=False)
    assert not sh.shadow_enabled()
    monkeypatch.setenv(sh.ENV_FLAG, "1")
    assert sh.shadow_enabled()


def test_shadow_unknown_lock_name_rejected(sh):
    with pytest.raises(sh.LockHierarchyViolation, match="not declared"):
        sh.make_lock("no.such.lock")


def test_shadow_inversion_fires(sh):
    store = sh.make_lock("store.lock")
    cond = sh.make_condition("frontdoor.cond")
    with store:
        with pytest.raises(sh.LockHierarchyViolation, match="inverts"):
            cond.acquire()
    assert not sh.held_locks()


def test_shadow_descending_order_clean(sh):
    cond = sh.make_condition("frontdoor.cond")
    store = sh.make_lock("store.lock")
    with cond:
        with store:
            assert sh.held_locks() == ("frontdoor.cond", "store.lock")
    assert not sh.held_locks()


def test_shadow_nonreentrant_reentry_fires_rlock_ok(sh):
    lock = sh.make_lock("store.lock")
    with lock:
        with pytest.raises(sh.LockHierarchyViolation, match="re-entry"):
            lock.acquire()
    rlock = sh.make_rlock("service.reader_lock")
    with rlock:
        with rlock:
            assert sh.held_locks() == ("service.reader_lock",) * 2
    assert not sh.held_locks()


def test_shadow_reentry_under_a_lower_lock_is_legal(sh):
    """A lock this thread already holds is taken again, reentrantly or
    by a bounded probe, while it holds a lock ranked below it: no
    inversion (the thread owns the lock), in both packages."""
    rlock = sh.make_rlock("service.reader_lock")       # rank 2
    submit = sh.make_lock("service.submit_lock")       # rank 1
    store = sh.make_lock("store.lock")                 # rank 7
    with rlock, store:
        assert rlock.acquire() is True
        rlock.release()
    with submit, store:
        assert submit.acquire(timeout=0.01) is False
        assert submit.acquire(blocking=False) is False
    assert not sh.held_locks()


def test_shadow_bounded_reacquire_is_a_probe(sh):
    lock = sh.make_lock("service.submit_lock")
    with lock:
        assert lock.acquire(timeout=0.01) is False
        assert lock.acquire(blocking=False) is False
    assert not sh.held_locks()


def test_shadow_wait_requires_held_and_releases_in_stack(sh):
    cond = sh.make_condition("service.cond")
    with pytest.raises(sh.LockHierarchyViolation, match="without holding"):
        cond.wait(0.01)
    with pytest.raises(sh.LockHierarchyViolation, match="without holding"):
        cond.notify_all()
    with cond:
        assert sh.held_locks() == ("service.cond",)
        cond.wait(0.01)
        assert sh.held_locks() == ("service.cond",)


def test_shadow_wait_for_requires_held(sh):
    cond = sh.make_condition("transport.cond")
    with pytest.raises(sh.LockHierarchyViolation, match="without holding"):
        cond.wait_for(lambda: True, 0.01)
    with cond:
        assert cond.wait_for(lambda: True, 0.01) is True
        assert sh.held_locks() == ("transport.cond",)
    assert not sh.held_locks()


def test_shadow_wait_reacquires_down_rank_legally(sh):
    cond = sh.make_condition("service.cond")
    store = sh.make_lock("store.lock")
    with cond:
        cond.wait(0.01)
        with store:
            assert sh.held_locks() == ("service.cond", "store.lock")


def test_shadow_assert_no_locks_held(sh):
    sh.assert_no_locks_held("test")
    lock = sh.make_lock("store.lock")
    with lock:
        with pytest.raises(sh.LockHierarchyViolation, match="dispatch"):
            sh.assert_no_locks_held("QueryEngine.query_batch")


def test_shadow_assert_no_locks_held_noop_when_off(sh, monkeypatch):
    lock = sh.make_lock("store.lock")
    monkeypatch.delenv(sh.ENV_FLAG)
    with lock:
        sh.assert_no_locks_held("anywhere")


def test_shadow_locks_required_enforced(sh):
    cond = sh.make_condition("frontdoor.cond")

    @sh.locks_required("frontdoor.cond")
    def take():
        return True

    with pytest.raises(sh.LockHierarchyViolation, match="requires"):
        take()
    with cond:
        assert take() is True
    assert take.__locks_required__ == ("frontdoor.cond",)


def test_shadow_violation_is_assertion_error(sh):
    assert issubclass(sh.LockHierarchyViolation, AssertionError)


def test_shadow_cross_thread_stacks_independent(sh):
    cond = sh.make_condition("frontdoor.cond")
    store = sh.make_lock("store.lock")
    cond.acquire()
    errors = []

    def other():
        try:
            with store:
                pass
        except sh.LockHierarchyViolation as exc:  # pragma: no cover
            errors.append(exc)

    th = threading.Thread(target=other)
    th.start()
    th.join()
    cond.release()
    assert not errors and not sh.held_locks()
