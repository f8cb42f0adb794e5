"""Settings: the dataclass copy layers defaults, TOML and SEMCODE_* env
exactly as the JAX package's pydantic model does."""

import dataclasses
from pathlib import Path

import pytest

import semcode_tpu.settings as js
import semcode_tpu_torch.settings as ts

TOML = """
[workspace]
root = "/tmp/semcode-ws"
[index]
kind = "flat"
scan_impl = "pallas"
rerank_weight = 1
snapshot_dir = ""
device_rescore = true
[llm]
default = "m"
endpoints = [{provider = "openai", model = "gpt", api_base = "http://x"}]
"""


def _dump(obj):
    """Field values of the port's settings, nested endpoints as dicts."""
    return dataclasses.asdict(obj)


def test_defaults_equal():
    assert _dump(ts.AppSettings()) == js.AppSettings().model_dump()


def test_toml_and_env_layering_equal(tmp_path, monkeypatch):
    cfg = tmp_path / "semcode_settings.toml"
    cfg.write_text(TOML)
    for name in [n for n in list(__import__("os").environ) if n.startswith("SEMCODE_")]:
        monkeypatch.delenv(name)
    monkeypatch.setenv("SEMCODE_CONFIG_PATH", str(cfg))
    monkeypatch.setenv("SEMCODE_INDEX_FETCH_WIDTH", "64")
    monkeypatch.setenv("SEMCODE_SEARCH_RERANK_DEPTH", "12")
    monkeypatch.setenv("SEMCODE_INDEX_DEVICE_RESCORE", "false")
    monkeypatch.setenv("SEMCODE_EMBEDDING_API_BASE", "")
    a = js.load_settings()
    b = ts.load_settings()
    assert _dump(b) == a.model_dump()
    assert b.workspace_root == Path("/tmp/semcode-ws")
    assert b.search_rerank_weight == 1.0 and isinstance(b.search_rerank_weight, float)
    assert b.index_device_rescore is False and b.index_fetch_width == 64
    assert b.llm_endpoints[0].model == "gpt"


def test_model_copy_and_path_coercion():
    a = ts.AppSettings(workspace_root="/tmp/x", index_snapshot_dir="/tmp/y")
    assert a.workspace_root == Path("/tmp/x") and a.index_snapshot_dir == Path("/tmp/y")
    b = a.model_copy(update={"index_kind": "flat", "workspace_root": None})
    assert b.index_kind == "flat" and b.workspace_root is None
    assert a.index_kind == "auto"
    with pytest.raises(TypeError):
        ts.AppSettings(not_a_field=1)
