"""The HTTP clients of both packages under the same stubbed cases.

``tests/test_frontend.py``'s cases (a stub ``streamlit`` module with
scripted widgets, a faked ``requests``), each run on the JAX package's
clients and on the port's (``semcode_tpu_torch/frontend/app.py`` and
``gradio_app.py``), which must behave the same. Also: the port's clients
import neither ``streamlit`` nor ``gradio`` until ``run()``, read the port's
settings, and the ``semcode-tpu-torch-streamlit`` / ``-gradio`` console
scripts resolve to them.
"""

from __future__ import annotations

import importlib
import sys
import tomllib
from pathlib import Path

import pytest

from semcode_tpu.frontend import app as jax_app
from semcode_tpu.frontend import gradio_app as jax_gradio
from semcode_tpu_torch.frontend import app as torch_app
from semcode_tpu_torch.frontend import gradio_app as torch_gradio
from test_frontend import _Resp, _StubStreamlit, _result

ROOT = Path(__file__).resolve().parents[1]
APPS = pytest.mark.parametrize("fe", [jax_app, torch_app], ids=["jax", "torch"])
GRADIO = pytest.mark.parametrize("ga", [jax_gradio, torch_gradio],
                                 ids=["jax", "torch"])


@pytest.fixture
def stub_st(monkeypatch):
    st = _StubStreamlit()
    monkeypatch.setitem(sys.modules, "streamlit", st)
    return st


# -- pure helpers -------------------------------------------------------------


@APPS
def test_headers_with_and_without_key(fe):
    assert "X-API-Key" not in fe._headers(None)
    assert fe._headers("sk")["X-API-Key"] == "sk"
    assert fe._headers("sk")["Content-Type"] == "application/json"


@APPS
def test_filter_sources_by_repo_and_language(fe):
    sources = [
        {"repo": "a", "language": "python"},
        {"repo": "b", "language": "python"},
        {"repo": "a", "language": "cpp"},
    ]
    assert fe._filter_sources(sources, [], []) == sources
    assert fe._filter_sources(sources, ["a"], []) == [sources[0], sources[2]]
    assert fe._filter_sources(sources, ["a"], ["python"]) == [sources[0]]
    assert fe._filter_sources(sources, ["zzz"], []) == []


@APPS
def test_render_diff_unified_format(fe):
    out = fe._render_diff("a\nb\nc", "a\nx\nc", "one.py", "two.py")
    assert "--- one.py" in out and "+++ two.py" in out
    assert "-b" in out and "+x" in out
    # identical snippets diff to nothing
    assert fe._render_diff("same", "same", "a", "b") == ""


@APPS
def test_run_query_builds_filter_body(fe, monkeypatch):
    seen = {}

    def fake_request(method, url, headers=None, json=None, timeout=None):
        seen.update(method=method, url=url, headers=headers, body=json)
        return _Resp({"answer": "ok", "sources": [], "meta": {}})

    monkeypatch.setattr(fe.requests, "request", fake_request)
    out = fe._run_query(
        "http://api:8000/", "key", "q?", repos=["r1"], languages=["python"]
    )
    assert out["answer"] == "ok"
    assert seen["method"] == "POST"
    assert seen["url"] == "http://api:8000/query"  # trailing slash stripped
    assert seen["headers"]["X-API-Key"] == "key"
    assert seen["body"] == {
        "question": "q?",
        "filters": {"repo": ["r1"], "language": ["python"]},
    }


@APPS
def test_run_query_raises_on_http_error(fe, monkeypatch):
    monkeypatch.setattr(
        fe.requests, "request", lambda *a, **k: _Resp({}, status=502)
    )
    with pytest.raises(RuntimeError):
        fe._run_query("http://api", None, "q")


@APPS
def test_fetch_repositories_error_path_returns_empty(fe, monkeypatch):
    def boom(*a, **k):
        raise ConnectionError("down")

    monkeypatch.setattr(fe.requests, "request", boom)
    assert fe._fetch_repositories("http://api", None) == []


@APPS
def test_run_search_appends_history_and_renders(fe, stub_st, monkeypatch):
    monkeypatch.setattr(fe, "_fetch_repositories", lambda *a: [])
    monkeypatch.setattr(fe, "_run_query", lambda *a, **k: _result(n_sources=2))
    stub_st.text_area_value_override = "what is the scan step?"
    stub_st.pressed = {"Search"}
    fe.run()
    assert stub_st.session_state.history == ["what is the scan step?"]
    assert stub_st.session_state.active_result["answer"] == "the answer"
    kinds = [r[0] for r in stub_st.rendered]
    assert "markdown" in kinds  # answer rendered
    assert kinds.count("caption") == 2  # one per source
    # two sources -> compare UI renders a unified diff
    assert ("subheader", "Compare snippets") in stub_st.rendered
    diff_blocks = [r for r in stub_st.rendered if r[0] == "code" and r[2] == "diff"]
    assert diff_blocks and "-line0" in diff_blocks[0][1]


@APPS
def test_run_history_dedup_and_limit(fe, stub_st, monkeypatch):
    monkeypatch.setattr(fe, "_fetch_repositories", lambda *a: [])
    monkeypatch.setattr(fe, "_run_query", lambda *a, **k: _result())
    stub_st.session_state.history = [f"old {i}" for i in range(fe.HISTORY_LIMIT)]
    stub_st.text_area_value_override = "old 3"  # re-asking moves to front
    stub_st.pressed = {"Search"}
    fe.run()
    hist = stub_st.session_state.history
    assert hist[0] == "old 3"
    assert len(hist) == fe.HISTORY_LIMIT  # capped, duplicate removed
    assert hist.count("old 3") == 1


@APPS
def test_run_replay_button_sets_question(fe, stub_st, monkeypatch):
    monkeypatch.setattr(fe, "_fetch_repositories", lambda *a: [])
    monkeypatch.setattr(fe, "_run_query", lambda *a, **k: _result())
    q = "replayed question"
    stub_st.session_state.history = [q]
    stub_st.pressed = {f"hist_{hash(q)}"}  # click the history button
    fe.run()
    # the replay key is consumed into the question box (popped after render)
    assert "replay" not in stub_st.session_state


@APPS
def test_run_query_error_renders_st_error(fe, stub_st, monkeypatch):
    monkeypatch.setattr(fe, "_fetch_repositories", lambda *a: [])

    def boom(*a, **k):
        raise RuntimeError("api down")

    monkeypatch.setattr(fe, "_run_query", boom)
    stub_st.text_area_value_override = "q"
    stub_st.pressed = {"Search"}
    fe.run()
    errs = [r for r in stub_st.rendered if r[0] == "error"]
    assert errs and "api down" in errs[0][1]
    assert stub_st.session_state.history == []  # failed query not recorded


@APPS
def test_run_clear_button_resets_result(fe, stub_st, monkeypatch):
    monkeypatch.setattr(fe, "_fetch_repositories", lambda *a: [])
    stub_st.session_state.active_result = _result()
    stub_st.pressed = {"Clear"}
    fe.run()
    assert stub_st.session_state.active_result is None


@APPS
def test_run_fallback_warning(fe, stub_st, monkeypatch):
    monkeypatch.setattr(fe, "_fetch_repositories", lambda *a: [])
    monkeypatch.setattr(
        fe, "_run_query", lambda *a, **k: _result(fallback=True)
    )
    stub_st.text_area_value_override = "q"
    stub_st.pressed = {"Search"}
    fe.run()
    warns = [r for r in stub_st.rendered if r[0] == "warning"]
    assert warns and "no_llm_configured" in warns[0][1]


# -- gradio client logic -------------------------------------------------------


@GRADIO
def test_gradio_search_filters_and_rows(ga, monkeypatch):
    payload = {
        "answer": "A",
        "meta": {"fallback_used": False},
        "sources": [
            {"repo": "r1", "path": "a.py", "language": "python",
             "score": 0.5, "snippet": "x" * 400},
            {"repo": "r2", "path": "b.cpp", "language": "cpp",
             "score": 0.4, "snippet": "y"},
        ],
    }
    seen = {}

    def fake_post(url, headers=None, json=None, timeout=None):
        seen.update(url=url, body=json)
        return _Resp(payload)

    monkeypatch.setattr(ga.requests, "post", fake_post)
    answer, meta, rows = ga._search("q", "http://api", "", "r1", "")
    assert answer == "A"
    assert seen["body"]["filters"] == {"repo": ["r1"]}
    assert len(rows) == 1 and rows[0][0] == "r1"
    assert len(rows[0][4]) == 300  # snippet truncated for the table


@GRADIO
def test_gradio_search_empty_question_and_error(ga, monkeypatch):
    answer, msg, rows = ga._search("  ", "http://api", "", "", "")
    assert rows == [] and "Enter a question" in msg

    def boom(*a, **k):
        raise ConnectionError("down")

    monkeypatch.setattr(ga.requests, "post", boom)
    answer, msg, rows = ga._search("q", "http://api", "", "", "")
    assert answer == "" and "Query failed" in msg and rows == []


@GRADIO
def test_gradio_load_filters(ga, monkeypatch):
    repos = [
        {"name": "alpha", "languages": ["python", "cpp"]},
        {"name": "beta", "languages": ["python"]},
    ]
    monkeypatch.setattr(ga.requests, "get", lambda *a, **k: _Resp(repos))
    names, langs = ga._load_filters("http://api", "")
    assert names == "alpha,beta"
    assert langs == "cpp,python"

    def boom(*a, **k):
        raise ConnectionError("down")

    monkeypatch.setattr(ga.requests, "get", boom)
    assert ga._load_filters("http://api", "") == ("", "")


# -- the port's clients on their own ------------------------------------------


def test_port_clients_read_the_port_settings_and_import_lazily():
    from semcode_tpu_torch.settings import settings

    assert torch_app.settings is settings and torch_gradio.settings is settings
    assert "streamlit" not in vars(torch_app) and "gradio" not in vars(torch_gradio)
    for mod in (torch_app, torch_gradio):
        src = Path(mod.__file__).read_text(encoding="utf-8")
        assert "semcode_tpu." not in src.replace("semcode_tpu_torch", "")


def test_gradio_run_without_gradio_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import raises
    with pytest.raises(SystemExit, match="gradio is not installed"):
        torch_gradio.run()


@pytest.mark.parametrize("name,target", [
    ("semcode-tpu-torch-streamlit", "semcode_tpu_torch.frontend.cli:main"),
    ("semcode-tpu-torch-gradio", "semcode_tpu_torch.frontend.gradio_app:run"),
])
def test_console_scripts_resolve(name, target):
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts[name] == target
    module, attr = target.split(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_streamlit_launcher_runs_the_port_app(monkeypatch, stub_st):
    from semcode_tpu_torch.frontend import cli

    seen = {}
    monkeypatch.setattr(cli.subprocess, "call",
                        lambda cmd: seen.setdefault("cmd", cmd) and 0)
    assert cli.main() == 0
    assert seen["cmd"][:4] == [sys.executable, "-m", "streamlit", "run"]
    assert Path(seen["cmd"][4]) == Path(torch_app.__file__)
