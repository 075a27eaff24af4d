"""``BENCHMARK.json`` against the contract's shape rules, and every file
it names present."""

import json
import re

import pytest

from chipbench import run as harness

MAN = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head",
          "expansion", "experts_per_token")


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries_have_exactly_their_keys(kind):
    assert 1 <= len(MAN[kind])
    for e in MAN[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[kind] <= set(e) <= ENTRY_KEYS[kind] | extra, e


def test_names_units_and_words():
    names = []
    for kind in ENTRY_KEYS:
        for e in MAN[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and kind != "end_to_end" and kind != "per_layer":
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for kind in ("end_to_end", "per_layer"):
        for m in MAN[kind]:
            assert UNIT.match(m["unit"]) and len(m["unit"]) <= 16, m
            assert m["better"] in ("lower", "higher")
            if kind == "per_layer":
                assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert len(set(names)) == len(names)
    metrics = [m["name"] for k in ("end_to_end", "per_layer") for m in MAN[k]]
    assert len(set(metrics)) == len(metrics)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200


def test_configs_used_reduced_not_widths_files_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        assert (harness.ROOT / c["file"]).exists()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTHS), key
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)


def test_cells_chips_and_pairs():
    cells = MAN["workloads"]
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) for w in cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(len(cells) // 4, 1)


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) for m in MAN["per_layer"])


def test_moves_names_an_e2e_metric_each_of_its_cells_reports():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_layers_spelled_alike_and_shares_named_as_the_contract_asks():
    by_layer: dict = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in by_layer.values())


def test_every_named_file_is_there():
    cell_dir = harness.HERE
    for w in MAN["workloads"]:
        assert (cell_dir / "traffic" / f"{w['traffic']}.json").exists()
        cfg = harness.load_json(harness.ROOT / {
            c["name"]: c for c in MAN["configs"]}[w["config"]]["file"])
        assert (cell_dir / "drivers" / f"{cfg['driver']}.py").exists()
        assert set(cfg["limits"])
    for kind in ("end_to_end", "per_layer"):
        for m in MAN[kind]:
            assert (cell_dir / "metrics" / f"{m['name']}.py").exists()
