"""No module of JAX or of the JAX package in a run, and none of the
program in the reference: top-level module names, compared whole."""

import ast
import json
import os
import subprocess
import sys

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "nnal_tpu"}


def _top(name):
    return name.split(".")[0]


def _subprocess(code):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    mods = _subprocess(
        "import sys, json; sys.path.insert(0, 'portbench/tests'); "
        "import tiny; tiny.run('fcd103.serve.f32'); "
        "from reference import counts, pw1, fcd103, draws, patches; "
        "print(json.dumps(sorted(sys.modules)))")
    tops = {_top(m) for m in mods}
    assert not tops & FORBIDDEN
    assert "nnal_tpu_torch" in tops       # the program did run
    # the port's name starts with the JAX package's: only whole names count
    assert "nnal_tpu" not in tops


def test_the_reference_imports_nothing_of_the_program():
    mods = _subprocess(
        "import sys, json; sys.path.insert(0, 'portbench'); "
        "import reference; "
        "from reference import counts, pw1, fcd103, draws, patches; "
        "print(json.dumps(sorted(sys.modules)))")
    tops = {_top(m) for m in mods}
    assert not tops & (FORBIDDEN | {"nnal_tpu_torch"})
    ref_dir = os.path.join(tiny.BENCH, "reference")
    for fn in os.listdir(ref_dir):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fn)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert _top(n) not in FORBIDDEN | {"nnal_tpu_torch"}, (fn, n)


def test_the_harness_names_what_it_forbids():
    import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
    sys.modules["nnal_tpu_torch_probe"] = sys    # a longer name is no match
    try:
        assert "nnal_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["nnal_tpu_torch_probe"]
