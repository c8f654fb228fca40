"""No module that portbench's runs import is JAX's or the JAX package's,
and the plain reference imports nothing of the measured program."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench.harness.cell import FORBIDDEN

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    files = [f for f in glob.glob(os.path.join(PB, "**", "*.py"),
                                  recursive=True)
             if os.sep + "tests" + os.sep not in f]
    assert len(files) > 20
    for f in files:
        bad = set(_top_level_imports(f)) & set(FORBIDDEN)
        assert not bad, (f, bad)


def test_reference_sources_import_nothing_of_the_program():
    for f in glob.glob(os.path.join(PB, "reference", "*.py")):
        tops = set(_top_level_imports(f))
        assert tops <= {"__future__", "dataclasses", "functools", "math",
                        "typing", "numpy", "torch"}, (f, tops)


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_module():
    """A whole CPU run of a cell (harness, driver, metric readers, the
    reference) in a fresh process: every loaded module's top-level name
    is compared whole, so homulator_tpu_torch passes."""
    mods = _modules_after(
        "import sys, json, time; sys.path.insert(0, '.');"
        "from portbench.harness import cell;"
        "from portbench.tests.tiny import TINY, HMULT;"
        "r = cell.run_cell('.', 'setB.hmult.b8', 5, 0.2, False, 'cpu',"
        " time.perf_counter(), config=TINY, mix=HMULT);"
        "assert r['correct'];"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "homulator_tpu_torch" in mods
    assert not set(mods) & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import sys, json; sys.path.insert(0, '.');"
        "import portbench.reference.ckks, portbench.reference.workloads;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(mods) & set(FORBIDDEN + ("homulator_tpu_torch",))


def _plant(tmp_path, where, monkeypatch):
    """A stand-in `jax` package first on sys.path, and a copy of the
    benchmark's root whose run imports it: from a metric reader that a
    later change might add, or from the reference's set-up."""
    from portbench.drivers import hmult_batch

    fake = tmp_path / "fake" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "fake"))
    root = tmp_path / "root"
    shutil.copytree(os.path.join(PB, "endtoend"),
                    root / "portbench" / "endtoend")
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    if where == "reader":
        man["end_to_end"].append({"name": "loads_jax", "unit": "s",
                                  "better": "lower", "bound": 0.25,
                                  "source": "host_clock"})
        (root / "portbench" / "endtoend" / "loads_jax.py").write_text(
            "def read(rec):\n    import jax  # noqa: F401\n    return 1.0\n")
    else:
        def reference(*a):
            import jax  # noqa: F401
            return real(*a)
        real = hmult_batch.reference
        monkeypatch.setattr(hmult_batch, "reference", reference)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return str(root)


@pytest.mark.parametrize("where", ["reader", "reference"])
def test_jax_loaded_after_the_window_fails_the_run(tmp_path, monkeypatch,
                                                   where):
    """The check of the loaded modules comes after everything a run
    imports: a module named `jax` loaded by a metric reader or by the
    reference makes the run print no result."""
    from portbench.harness import cell
    from portbench.tests.tiny import HMULT, TINY

    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.split(".")[0] in ("jax", "jaxlib", "flax")}
    try:
        root = _plant(tmp_path, where, monkeypatch)
        with pytest.raises(cell.RunError, match="jax"):
            cell.run_cell(root, "setB.hmult.b8", 5, 0.2, False, "cpu",
                          time.perf_counter(), config=TINY, mix=HMULT)
    finally:
        for m in [m for m in sys.modules if m.split(".")[0] == "jax"]:
            del sys.modules[m]
        sys.modules.update(saved)
