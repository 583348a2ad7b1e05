"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files each entry names, the per-layer metrics' ``moves``, bounds and
the run length. CPU only, under a second."""

import json
import re
from pathlib import Path

import pytest

from bench.lib import common

MAN = common.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = {w["name"]: w for w in MAN["workloads"]}
#: the most cells a benchmark may have: later ones add up to it
MAX_CELLS = 24


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"]
    assert 1 <= len(MAN["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})])
def test_entry_keys_and_names(section, keys):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                            "higher")


def test_configs_files_and_reductions():
    for c in MAN["configs"]:
        path = common.ROOT / c["file"]
        assert c["file"].startswith("bench/") and path.is_file()
        conf = json.loads(path.read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
        assert "limits" in conf and conf["limits"]
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


def test_cells_name_their_files():
    pairs = set()
    for w in MAN["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((common.BENCH / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (common.BENCH / "drivers"
                / f"{traffic['driver']}.py").is_file()


def test_metrics_per_cell():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (common.BENCH / "metrics" / f"{m['name']}.py").is_file()
        if "%" == m["unit"]:
            assert m["name"] not in e2e
    for name in CELLS:
        ends = {m["name"] for m in common.metrics_of(name, MAN,
                                                     "end_to_end")}
        layers = common.metrics_of(name, MAN, "per_layer")
        assert "setup_s" in ends and len(ends) >= 2 and layers, name
        for m in layers:        # a layer metric's cell reports what it moves
            assert m["moves"] in ends, (name, m["name"])
    for m in MAN["per_layer"] + MAN["end_to_end"]:
        assert set(m.get("workloads", [])) <= set(CELLS)


def test_layers_are_named_alike():
    """Metrics of one layer give its name letter for letter: no two names
    differ only by case or spacing."""
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert all(name.strip() == name and name for name in layers)
    plain = {" ".join(name.lower().split()) for name in layers}
    assert len(plain) == len(layers), sorted(layers)


def test_run_seconds_fits_a_full_check():
    """A full check of the most cells a benchmark may have fits its time."""
    r = MAN["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert len(MAN["workloads"]) <= MAX_CELLS
    cells = MAX_CELLS
    assert (2 + 14 * cells) * (r + 60) + cells * 2 * 90 + 1200 <= 43200


def test_paths_hold_only_the_benchmark():
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p)
        assert not p.endswith("_torch")
        assert Path(common.ROOT / p).is_dir()
