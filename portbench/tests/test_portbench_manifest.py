"""BENCHMARK.json against its contract, and the configuration files
against the published configs they name."""

import json
import re

import pytest

from portbench.bench.manifest import NAME, UNIT, Manifest
from portbench.tests._tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")

# huggingface.co/mistralai/<model>/blob/main/config.json, as published
PUBLISHED = {
    "mistral-7b-v0.3": {
        "hidden_size": 4096, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "intermediate_size": 14336, "hidden_act": "silu",
        "vocab_size": 32768, "tie_word_embeddings": False,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-05,
        "sliding_window": None, "max_position_embeddings": 32768,
        "torch_dtype": "bfloat16"},
    "mixtral-8x7b-v0.1": {
        "hidden_size": 4096, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "intermediate_size": 14336, "hidden_act": "silu",
        "num_local_experts": 8, "num_experts_per_tok": 2,
        "vocab_size": 32000, "tie_word_embeddings": False,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-05,
        "router_aux_loss_coef": 0.02, "sliding_window": None,
        "max_position_embeddings": 32768, "torch_dtype": "bfloat16"},
}
WIDTH = re.compile(r"(hidden_size|intermediate_size|latent|state_size|"
                   r"projection|head_dim|_dim$|_rank$|experts_per_tok|"
                   r"expansion)")


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_units_better_sources():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def _reports(cell: str, group: str) -> set:
    return {m["name"] for m in BENCH[group]
            if "workloads" not in m or cell in m["workloads"]}


def test_every_cell_reports_setup_another_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = _reports(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert _reports(w["name"], "per_layer"), w["name"]


def test_moves_and_cells_agree():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for c in m.get("workloads", cells):
            assert c in cells
            assert m["moves"] in _reports(c, "end_to_end"), (m["name"], c)


def test_a_roofline_has_an_mfu_beside_it():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(o.get("workloads", ())) >= set(m["workloads"])
                       for o in BENCH["per_layer"]), m["name"]


def test_cells_configs_and_files():
    man = Manifest(ROOT)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        man.traffic(w)
        man.limits(w)
        for m in man.per_layer(w["name"]):
            assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_config_file_holds_the_published_values(name):
    entry = next((c for c in BENCH["configs"] if c["name"] == name), None)
    path = f"portbench/configs/{name}.json"
    cfg = json.loads((ROOT / path).read_text())
    if entry is not None:
        assert entry["file"] == path
        assert cfg["source"].startswith(entry["source"])
        assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for key, value in PUBLISHED[name].items():
        if key in cfg["reduced"]:
            assert cfg["published"][key] == value
            assert cfg[key] != value
        else:
            assert cfg[key] == value, key
    for key in cfg["reduced"]:
        assert not WIDTH.search(key), key
