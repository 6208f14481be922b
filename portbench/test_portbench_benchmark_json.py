"""``BENCHMARK.json`` against the contract's rules of form, and the files
each of its names needs."""
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits_its_time():
    """2 + 14 runs a cell, each ``run_seconds`` + 60 s, 2 x 90 s a cell to
    compile and 1200 s spare, within 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    texts = [w["why"] for w in BENCH["workloads"] + BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_every_configuration_has_a_cell_and_files():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (HERE / "reference" / f"{cfg['reference']}.py").exists()
    for w in BENCH["workloads"]:
        work = json.loads((HERE / "workloads" / f"{w['name']}.json").read_text())
        assert work["config"] == w["config"] and w["chips"] == 1
        assert work["traffic"]["kind"] in ("closed", "open")


def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    cells_of = lambda m: m.get("workloads", cells)
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in METRICS:
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(cells_of(m)) <= set(cells_of(moved)), m["name"]
    for c in cells:
        own = [m for m in BENCH["end_to_end"] if c in cells_of(m)]
        assert {"setup_s"} < {m["name"] for m in own}
        assert any(c in cells_of(m) for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("config", ["minitron-4b", "mamba2-780m"])
def test_config_file_is_the_ports_config(config):
    """The file's ``port`` fields are the port's own configuration of that
    name: the benchmark serves the model the program ships."""
    import dataclasses

    from repro_torch.configs import get_config

    port = json.loads((HERE / "configs" / f"{config}.json").read_text())["port"]
    ship = get_config(config)
    for key, value in port.items():
        got = getattr(ship, key)
        if key == "stages":
            got = [{"unit": list(s.unit), "n_units": s.n_units} for s in got]
        assert got == value, key
    assert {f.name for f in dataclasses.fields(ship)} >= set(port)
