"""BENCHMARK.json: names, units and keys as the contract has them, every
name resolved to its file, and a cell added by new files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import manifest
from perfbench.cell import run_cell

from .util import LANES, small_cell

M = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_command_and_paths():
    assert set(M) == TOP_KEYS
    assert 1 <= len(M["command"]) <= 32
    assert all(_one_line(w) and not w.startswith("/") and ".." not in w
               for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert (manifest.ROOT / p).is_dir() and not p.endswith("_torch")
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in M[k]}) == len(M[k])
    metrics = M["end_to_end"] + M["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in M["workloads"]:
        assert NAME.match(w["config"])
        assert NAME.match(w["traffic"])


def test_entries_have_only_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and _one_line(c["source"])
        assert _one_line(c["why"]) and len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _one_line(w["why"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _one_line(m["layer"])
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])


def test_every_workload_resolves_and_reports():
    e2e = {m["name"] for m in M["end_to_end"]}
    used = set()
    pairs = set()
    for w in M["workloads"]:
        cell = manifest.cell(w["name"])
        used.add(w["config"])
        pairs.add((w["config"], w["traffic"]))
        assert manifest.traffic_file(w["traffic"]).is_file()
        assert manifest.entry_file(cell.traffic["entry"]).is_file()
        entry = manifest.entry(cell.traffic["entry"])
        for hook in ("setup", "window", "release", "compare", "control"):
            assert callable(getattr(entry, hook))
        assert entry.FAULTS
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
    assert len(pairs) == len(M["workloads"])
    for c in M["configs"]:
        assert c["name"] in used
        path = manifest.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith(tuple(M["paths"]))
        cfg = json.loads(path.read_text())
        assert cfg["reduced"] == c["reduced"]
        ref = manifest.reference(cfg)
        assert cfg["numeric"] in ref.NUMERICS
        assert set(cfg["limits"]) and all(
            v >= 0 for v in cfg["limits"].values())
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert callable(manifest.reader(m["name"]))
        for w in m.get("workloads", ()):
            assert w in {x["name"] for x in M["workloads"]}


def test_a_cell_added_by_new_files_alone(tmp_path):
    """A new configuration and mix, as new files and new entries, run
    through the harness with no existing file edited."""
    root = tmp_path
    shutil.copytree(manifest.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    m = json.loads(json.dumps(M))
    m["configs"].append({"name": "voice16k-48k-q5", "source":
                         "https://example.org/new", "file":
                         "perfbench/configs/voice16k-48k-q5.json",
                         "reduced": [], "why": "a throwaway"})
    m["workloads"].append({"name": "tiny.q5", "config": "voice16k-48k-q5",
                           "traffic": "tiny", "chips": 1, "why": "a test"})
    for metric in m["per_layer"]:
        metric["workloads"].append("tiny.q5")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cfg = json.loads((manifest.HERE / "configs" /
                      "cd44k1-48k-q7.json").read_text())
    cfg.update(name="voice16k-48k-q5", in_rate=16000, out_rate=48000,
               quality=5, channels=1, target_in_frames=3072)
    (root / "perfbench/configs/voice16k-48k-q5.json").write_text(
        json.dumps(cfg))
    mix = json.loads(manifest.traffic_file("stage").read_text())
    mix.update(streams=3, pool_min_bytes=1 << 16)
    (root / "perfbench/traffic/tiny.json").write_text(json.dumps(mix))

    cell = manifest.cell("tiny.q5", root)
    assert cell.config["in_rate"] == 16000 and cell.traffic["streams"] == 3
    assert [p["name"] for p in cell.per_layer] == [
        p["name"] for p in M["per_layer"]]
    r = run_cell(cell, 5, 0.2, False, device="cpu")
    assert r["correct"] is True and r["attempted"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data


def test_an_entry_and_a_reference_added_by_new_files_alone(tmp_path):
    """A new entry module and a new reference module, as new files that
    a new mix and a new configuration name, are the ones the run takes."""
    root = tmp_path
    shutil.copytree(manifest.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "entries/stage_copy.py").write_text(
        (pb / "entries/stream_stage.py").read_text()
        + "\nWHO = 'stage_copy'\n")
    (pb / "reference/float_copy.py").write_text(
        (pb / "reference/speex_float.py").read_text()
        + "\nWHO = 'float_copy'\n")
    m = json.loads(json.dumps(M))
    m["configs"].append({"name": "copy-q7", "source": "https://example.org",
                         "file": "perfbench/configs/copy-q7.json",
                         "reduced": [], "why": "a throwaway"})
    m["workloads"].append({"name": "copy.q7", "config": "copy-q7",
                           "traffic": "copy", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cfg = json.loads((pb / "configs/cd44k1-48k-q7.json").read_text())
    cfg.update(name="copy-q7", reference="perfbench/reference/float_copy.py")
    (pb / "configs/copy-q7.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic/stage.json").read_text())
    mix.update(entry="stage_copy", streams=2, pool_min_bytes=1 << 16)
    (pb / "traffic/copy.json").write_text(json.dumps(mix))

    cell = manifest.cell("copy.q7", root)
    assert manifest.entry(cell.traffic["entry"], root).WHO == "stage_copy"
    assert manifest.reference(cell.config, root).WHO == "float_copy"
    r = run_cell(cell, 11, 0.2, False, device="cpu")
    assert r["correct"] is True and r["attempted"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("numeric", ["fixed", "double"])
def test_a_reference_refuses_a_numeric_it_does_not_reproduce(numeric):
    """A fixed-point configuration cannot be held against the float
    reference: the run is refused before it starts."""
    cfg = dict(manifest.cell("stage.q7").config, numeric=numeric)
    with pytest.raises(ValueError, match="numeric"):
        manifest.reference(cfg)
    cell = small_cell("stage.q7")
    with pytest.raises(ValueError, match="numeric"):
        run_cell(manifest.dataclasses.replace(cell, config=cfg), 3, 0.1,
                 False, device="cpu")


@pytest.mark.parametrize("path", ["perfbench/../perfbench/reference/"
                                  "speex_float.py", "/tmp/x.py",
                                  "perfbench/reference/speex_design.json"])
def test_a_reference_outside_the_benchmark_is_refused(path):
    cfg = dict(manifest.cell("stage.q7").config, reference=path)
    with pytest.raises(ValueError):
        manifest.reference(cfg)


def test_names_from_data_files_are_names():
    with pytest.raises(ValueError):
        manifest.entry_file("../cell")
    with pytest.raises(ValueError):
        manifest.traffic_file("a/b")


def test_the_program_runs_the_configurations_quantum():
    """A quantum the port would round is refused, not timed at
    another size than the configuration states."""
    cell = small_cell("stage.q7")
    cfg = dict(cell.config, target_in_frames=16384)
    with pytest.raises(ValueError, match="frames"):
        run_cell(manifest.dataclasses.replace(cell, config=cfg), 3, 0.1,
                 False, device="cpu")


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        manifest.cell("no.such.cell")


def test_lanes_are_streams_times_channels():
    for name in ("stage.q7", "stage.q10"):
        cell = manifest.cell(name)
        assert cell.traffic["streams"] * cell.config["channels"] == 2048
        small = small_cell(name)
        assert small.traffic["streams"] * small.config["channels"] == LANES
