"""repro-lint (``tools.analyze``) over the port's sources.

* ``python -m tools.analyze --src src/repro_torch`` finds nothing new, and
  the committed baseline grandfathers nothing (so nothing of the port is
  hidden there).
* Every ``engine-thread-only``, ``hot-path`` and ``holds=_lock`` marker on
  a method of the reference's ``serve/engine.py`` and ``serve/prefix.py``
  stands on the port's method of the same class and name, and every
  ``# guarded-by:`` field of theirs on the port's field.
* The markers bite: on a copy of the port, a host sync added to the tick
  is an RL006 finding, and the engine stripped of its marker lines has
  RL001 findings.
"""
import ast
import pathlib
import re
import shutil

import pytest

from tools.analyze import baseline as baseline_mod
from tools.analyze.cli import DEFAULT_BASELINE, run_lint
from tools.analyze.core import SourceFile
from tools.analyze.locks import _ClassInfo

ROOT = pathlib.Path(__file__).resolve().parents[1]
MARKS = ("engine-thread-only", "hot-path", "holds=_lock")
SERVE_FILES = ("engine.py", "prefix.py")


def test_the_port_lints_clean_with_an_empty_baseline():
    res = run_lint(ROOT, src_rel="src/repro_torch",
                   baseline_path=ROOT / DEFAULT_BASELINE)
    assert [f.format_text() for f in res.new] == []
    assert res.grandfathered == [] and res.stale_baseline == []
    assert baseline_mod.load(ROOT / DEFAULT_BASELINE) == {}


def _signature_markers(sf: SourceFile, fn: ast.FunctionDef):
    """The markers in the comments of a def's signature lines (a marker may
    sit on any line of a multi-line signature in the reference) or on a
    comment line just above it."""
    first = fn.lineno - 1 if fn.lineno - 1 in sf._standalone else fn.lineno
    out = set()
    for ln in range(first, fn.body[0].lineno):
        m = re.search(r"#\s*repro-lint:\s*(.*)$", sf.comments.get(ln, ""))
        if m:
            out |= {t for t in m.group(1).split() if t in MARKS}
    return out


def _methods(path: pathlib.Path):
    sf = SourceFile(path.as_posix(), path.read_text())
    for cls in sf.tree.body:
        if isinstance(cls, ast.ClassDef):
            for fn in cls.body:
                if isinstance(fn, ast.FunctionDef):
                    yield sf, cls.name, fn


def _reference_markers():
    out = []
    for name in SERVE_FILES:
        for sf, cls, fn in _methods(ROOT / "src/repro/serve" / name):
            marks = _signature_markers(sf, fn)
            if marks:
                out.append((name, cls, fn.name, frozenset(marks)))
    return out


REFERENCE = _reference_markers()


def test_the_reference_carries_the_markers_this_file_holds_the_port_to():
    names = {m for _, _, _, marks in REFERENCE for m in marks}
    assert names == set(MARKS)
    assert len(REFERENCE) >= 30


@pytest.mark.parametrize("file,cls,method,marks", REFERENCE,
                         ids=[f"{f}:{c}.{m}" for f, c, m, _ in REFERENCE])
def test_port_method_carries_the_references_markers(file, cls, method,
                                                    marks):
    port = {(c, fn.name): sf.markers_for_def(fn) for sf, c, fn in
            _methods(ROOT / "src/repro_torch/serve" / file)}
    assert (cls, method) in port, f"the port has no {cls}.{method}"
    assert marks <= port[(cls, method)], \
        f"{cls}.{method}: reference {sorted(marks)}, port " \
        f"{sorted(port[(cls, method)])}"


def _guards(path: pathlib.Path):
    """{class: {field: guard}} of a file's ``# guarded-by:`` fields."""
    sf = SourceFile(path.as_posix(), path.read_text())
    return {c.name: _ClassInfo(sf, c).guarded for c in sf.tree.body
            if isinstance(c, ast.ClassDef)}


@pytest.mark.parametrize("file", SERVE_FILES)
def test_port_fields_carry_the_references_guards(file):
    ref = _guards(ROOT / "src/repro/serve" / file)
    port = _guards(ROOT / "src/repro_torch/serve" / file)
    want = {(c, f, g) for c, fields in ref.items() for f, g in fields.items()}
    got = {(c, f, g) for c, fields in port.items() for f, g in fields.items()}
    assert want, file
    assert want <= got, sorted(want - got)


def _mutant(tmp_path, edit) -> pathlib.Path:
    """A copy of the port under ``tmp_path`` with ``edit`` (text -> text)
    applied to its engine."""
    shutil.copytree(ROOT / "src/repro_torch", tmp_path / "src/repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    eng = tmp_path / "src/repro_torch/serve/engine.py"
    text = eng.read_text()
    eng.write_text(edit(text))
    assert eng.read_text() != text
    return tmp_path


def test_a_host_sync_in_the_tick_is_an_rl006_finding(tmp_path):
    head = ("    # repro-lint: engine-thread-only hot-path\n"
            "    def step(self) -> bool:\n")
    root = _mutant(tmp_path, lambda t: t.replace(
        head, head + "        self._state['active'].sum().item()\n"))
    res = run_lint(root, src_rel="src/repro_torch", select=["RL006"])
    assert any(f.rule == "RL006" and "step" in f.symbol for f in res.new), \
        [f.format_text() for f in res.new]


def test_the_engine_without_its_markers_has_rl001_findings(tmp_path):
    """Without the marker lines above its methods, the engine's tick reads
    ``_cancel_ids`` (guarded by ``_lock``) outside the lock."""
    root = _mutant(tmp_path, lambda t: "".join(
        ln for ln in t.splitlines(keepends=True)
        if not ln.strip().startswith("# repro-lint: engine-thread-only")))
    res = run_lint(root, src_rel="src/repro_torch", select=["RL001"])
    assert any(f.symbol == "BatchedEngine._apply_control._cancel_ids"
               for f in res.new), [f.format_text() for f in res.new]
