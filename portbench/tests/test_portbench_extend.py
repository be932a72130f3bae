"""A cell, a traffic mix and a per-layer metric are added by new files and
new manifest entries alone: in a copy of the benchmark, a dummy mix and a
dummy metric run without an edit to any file that was there."""

import json
import os
import shutil
import subprocess
import sys

import tiny

RUN = """
import json, sys, time
sys.path.insert(0, {bench!r})
import harness, run
man = harness.manifest()
cell = harness.cell(man, "pw1.serve.dummy")
cfg = harness.config(cell["config"])
mix = harness.traffic(cell["traffic"], cfg["family"])
lim = harness.load_json({limits!r})
out = run.run_cell(cell, cfg, mix, lim, 11, 0.2, True, "cpu",
                   time.perf_counter())
print(json.dumps(out))
"""


def _write(path, obj):
    with open(path, "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj))


def test_new_files_and_entries_only(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(tiny.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), root)
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in bench.rglob("*") if x.is_file())}

    _write(bench / "traffic" / "serve.dummy.json",
           {"driver": "serve", "op": "posteriors", "blobs": 2})
    _write(bench / "traffic" / "serve.dummy.patchwise.json",
           {"subject_shape": [10, 10, 4], "ring": 1, "grid_spacing": 2,
            "z_chunk": 4, "check_voxels": 16, "check_block": 16})
    _write(bench / "limits" / "pw1.serve.dummy.json", {"logodds_err": 1e-3})
    _write(bench / "metrics" / "subjects.dummy.py",
           "def read(rec):\n    return float(rec['units'])\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "pw1.serve.dummy", "config": "pw1",
                             "traffic": "serve.dummy", "chips": 1,
                             "why": "a dummy mix"})
    for m in man["end_to_end"]:
        if m["name"] == "serve_vox_per_s.patchwise":
            m["workloads"].append("pw1.serve.dummy")
    man["per_layer"].append({"name": "subjects.dummy", "unit": "subjects",
                             "better": "higher", "source": "host_clock",
                             "layer": "serving",
                             "moves": "serve_vox_per_s.patchwise",
                             "workloads": ["pw1.serve.dummy"]})
    _write(root / "BENCHMARK.json", json.dumps(man))

    env = dict(os.environ, PYTHONPATH=tiny.ROOT)
    code = RUN.format(bench=str(bench),
                      limits=str(bench / "limits" / "pw1.serve.dummy.json"))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"]["subjects.dummy"]["value"] == out["attempted"]
    # listed for another cell
    assert "mfu.serve.patchwise" not in out["metrics"]
    for p, body in before.items():
        assert open(p, "rb").read() == body, p
