"""The benchmark's layout: BENCHMARK.json agrees with the files it names,
every piece is found by name, and nothing the harness loads or reads is
JAX or the JAX package's benchmark."""

import glob
import json
import os
import re
import subprocess
import sys

from nwbench import harness

from conftest import ROOT

BENCH = os.path.join(ROOT, "BENCHMARK.json")
HERE = harness.HERE


def _bench():
    with open(BENCH) as f:
        return json.load(f)


def test_benchmark_json_names_the_cell_files():
    b = _bench()
    assert b["paths"] == ["nwbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"nwbench/configs/{c['name']}.json"
    for w in b["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert cell[key] == w[key], (w["name"], key)
        assert w["config"] in configs
        harness.load_json("traffic", w["traffic"])
        assert os.path.exists(os.path.join(HERE, "drivers",
                                           cell["driver"] + ".py"))


def test_metrics_are_found_by_name_and_reported_where_listed():
    """Every per-layer metric has a reader with its unit, and every cell it
    lists reports the end-to-end metric it moves; every end-to-end metric
    is one its cells compute."""
    b = _bench()
    names = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert harness.reader(m["name"]).UNIT == m["unit"]
        assert set(m["workloads"]) <= names
        for w in m["workloads"]:
            assert m["moves"] in harness.load_json("workloads",
                                                   w)["end_to_end"]
            assert m["name"] in harness.per_layer_metrics(
                w, harness.load_json("workloads", w)["end_to_end"])
    for m in b["end_to_end"]:
        cells = m.get("workloads", sorted(names))
        for w in cells:
            listed = harness.load_json("workloads", w)["end_to_end"]
            assert m["name"] == "setup_s" or m["name"] in listed
    for w in names:
        for metric in harness.load_json("workloads", w)["end_to_end"]:
            assert any(m["name"] == metric for m in b["end_to_end"]), metric


def test_split_quantities_share_one_reader():
    same = harness.reader("idle_share.knn")
    assert same.__file__.endswith("idle_share.py")
    assert harness.reader("encoder_mfu.passages").__file__.endswith(
        "encoder_mfu.py")
    try:
        harness.reader("no_such_metric")
    except FileNotFoundError:
        pass
    else:
        raise AssertionError("an unknown metric found a reader")


def test_nothing_reads_the_jax_benchmark():
    pat = re.compile(r"bench\.py|__graft_entry__|BENCH_|MULTICHIP_|BASELINE")
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        if os.path.basename(path) == "test_nwbench_layout.py":
            continue
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_the_harness_loads_no_jax():
    """Every module of the harness and the port modules its drivers use,
    loaded in a fresh process: no top-level jax, jaxlib, flax or
    neighborhoodwatch_tpu (whole names)."""
    code = """
import json, sys
from nwbench import harness, run, calibrate, trace, yardstick, seeds
from nwbench.reference import bert, knn, hash_tokenizer
for kind in ("drivers", "traffic"):
    import glob, os
    for p in glob.glob(os.path.join(harness.HERE, kind, "*.py")):
        harness.load_module(kind, os.path.basename(p)[:-3])
for m in json.load(open(harness.BENCHMARK))["per_layer"]:
    harness.reader(m["name"])
import neighborhoodwatch_tpu_torch.ops.knn
import neighborhoodwatch_tpu_torch.models.e5
import neighborhoodwatch_tpu_torch.utils.cuda_build
run._environment()
from neighborhoodwatch_tpu_torch.models.tokenizer import load_tokenizer
load_tokenizer("intfloat/e5-large-v2", quiet=True)
print(harness.forbidden_modules(sys.modules))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole():
    assert harness.forbidden_modules(
        ["neighborhoodwatch_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["neighborhoodwatch_tpu.ops", "jax.numpy", "flax"]) == \
        ["flax", "jax", "neighborhoodwatch_tpu"]
