"""What the benchmark loads: the reference and the layer kinds' arithmetic
import nothing of the port, and a whole run loads no module whose
top-level name is jax, jaxlib, flax or repro (compared whole: the port's
name begins with repro)."""

from __future__ import annotations

import json
import subprocess
import sys

import pb_tiny

SNIPPET = """
import json, sys
sys.path.insert(0, {here!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body: str):
    code = SNIPPET.format(here=str(pb_tiny.HERE), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(pb_tiny.ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_port():
    mods = _top_level("import importlib, pkgutil, reference.lm, reference.check, reference.kinds\n"
                      "for m in pkgutil.iter_modules(reference.kinds.__path__):\n"
                      "    importlib.import_module('reference.kinds.' + m.name)")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax", "harness"}


def test_layer_kinds_arithmetic_imports_nothing_of_the_port():
    mods = _top_level("import importlib, pkgutil, harness.counts, harness.weights, harness.kinds\n"
                      "for m in pkgutil.iter_modules(harness.kinds.__path__):\n"
                      "    importlib.import_module('harness.kinds.' + m.name)")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax", "reference"}


def test_a_whole_run_loads_no_jax_package():
    body = ("sys.path.insert(0, {tests!r}); import pb_tiny\n"
            "code, res = pb_tiny.execute('dbrx-132b.chat')\n"
            "assert code == 0 and res['correct'], res").format(tests=str(pb_tiny.HERE / "tests"))
    mods = _top_level(body)
    assert "repro_torch" in mods
    assert not mods & {"repro", "jax", "jaxlib", "flax"}


def test_the_guard_names_a_loaded_jax_package():
    import run

    sys.modules.setdefault("repro", type(sys)("repro"))
    try:
        assert run.forbidden_modules() == ["repro"]
    finally:
        if getattr(sys.modules.get("repro"), "__file__", None) is None:
            del sys.modules["repro"]


def test_a_jax_package_loaded_by_a_metric_reader_gives_no_result(monkeypatch):
    """The guard runs after the traced run's readers: one that loads a
    module named ``repro`` leaves the run without a result."""
    import run

    load = run.load_file

    class Planting:
        @staticmethod
        def read(_run):
            sys.modules["repro"] = type(sys)("repro")
            return None

    def load_file(path, name):
        return Planting if name.startswith("portbench_metric_") else load(path, name)

    monkeypatch.setattr(run, "load_file", load_file)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    try:
        code, res = pb_tiny.execute("qwen3-0.6b.prefill-long", trace=1)
    finally:
        sys.modules.pop("repro", None)
    assert code == 4 and res is None


def test_a_checkout_without_the_port_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(pb_tiny.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(pb_tiny.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dbrx-132b.chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
