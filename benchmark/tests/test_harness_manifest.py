"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, and every configuration, cell, traffic mix and metric found as a
file of its own. Each test reads the checkout at ``root``, the repo's
unless a caller hands it another (a copy with a deployment added)."""

import json
import re

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|per_tok)", re.I)


def line_text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def load_manifest(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command(root=REPO):
    manifest = load_manifest(root)
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(line_text(w) for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (root / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51


def test_configs(root=REPO):
    manifest = load_manifest(root)
    names = [c["name"] for c in manifest["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = [c["file"] for c in manifest["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line_text(c["source"]) and line_text(c["why"])
        assert c["file"].startswith("benchmark/")
        config = json.loads((root / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in config
            assert not WIDTH.search(key)
        for key in ("N", "degree", "int_refsteps", "nitsche_eta", "dtype",
                    "cg_tol", "cg_max_iter"):
            assert key in config


def test_workloads_find_their_files(root=REPO):
    manifest, bench = load_manifest(root), root / "benchmark"
    names = [w["name"] for w in manifest["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_text(w["why"])
        traffic = json.loads((bench / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (bench / "drivers" / f"{traffic['driver']}.py").is_file()
        cell = json.loads((bench / "workloads" /
                           f"{w['name']}.json").read_text())
        assert cell["limits"]
        # every cell names its traced slice (trace.py), so that a --trace 1
        # run reads the device
        assert set(cell["trace"]) == {"target", "argument", "start", "calls"}


def reported(metrics, cell):
    return [m for m in metrics if "workloads" not in m or
            cell in m["workloads"]]


def test_metrics(root=REPO):
    manifest, bench = load_manifest(root), root / "benchmark"
    e2e, layer = manifest["end_to_end"], manifest["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    cells = {w["name"] for w in manifest["workloads"]}
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    e2e_names = {m["name"] for m in e2e}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        # a per-layer metric names its cells, so that it reaches no cell
        # it was not written for
        assert m.get("workloads"), m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_text(m["layer"]) and m["moves"] in e2e_names
    for cell in cells:
        got = {m["name"] for m in reported(e2e, cell)}
        assert "setup_s" in got and len(got) >= 2
        assert reported(layer, cell)
        for m in reported(layer, cell):
            assert m["moves"] in got
