"""Nothing a run loads is JAX or the JAX package (by whole top-level
name: ``biear_tpu_torch`` is the port, ``biear_tpu`` the JAX package),
and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from perfbench import harness  # noqa: E402


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _py_files(sub=""):
    for dirpath, _, files in os.walk(os.path.join(tiny.BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _py_files():
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in _py_files("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("biear_tpu_torch",
                                             *harness.FORBIDDEN), (path, mod)


def test_whole_name_check(monkeypatch):
    import types
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "biear_tpu_torch_probe",
                        types.ModuleType("biear_tpu_torch_probe"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "biear_tpu.models",
                        types.ModuleType("biear_tpu.models"))
    assert harness.forbidden_modules() == ["biear_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["biear_tpu", "jaxlib"]


def test_a_run_loads_no_forbidden_module(tmp_path):
    d = tiny.make(str(tmp_path / "b"))
    code = (
        "import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "import perfbench.run\n"
        "from perfbench import harness\n"
        "import tiny\n"
        "out = harness.run('dual-train-b512', 3, 0.2, False, 'cpu',"
        " tiny.benchmark(), bench_dir=%r)\n"
        "ref = [k for k in sys.modules if k.startswith('perfbench.reference')]\n"
        "print(json.dumps({'bad': harness.forbidden_modules(),"
        " 'port': 'biear_tpu_torch' in sys.modules, 'ref': ref}))\n"
    ) % (tiny.ROOT, os.path.dirname(os.path.abspath(__file__)), d)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    import json
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["port"] and res["ref"]


def test_reference_alone_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.model, perfbench.reference.synth\n"
            "import perfbench.reference.train\n"
            "print(sorted({k.split('.')[0] for k in sys.modules} & "
            "{'biear_tpu_torch', 'biear_tpu', 'jax', 'jaxlib', 'flax'}))"
            ) % tiny.ROOT
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
