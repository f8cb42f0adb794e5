"""Streamlit client (optional).

Counterpart of ``semcode_tpu/frontend/app.py`` (34-199) on the port's
settings: sidebar API config, repo/language filters from /repos, query
history with replay, fallback warning, filtered sources as code blocks, and
a unified-diff compare of two snippets. It talks to the API over HTTP with
``requests`` only, so it drives either package's server. Requires the
optional ``streamlit`` package, imported inside ``run()``; the
dependency-free built-in web UI at ``GET /`` (frontend/webui.py) covers the
same features when streamlit is not installed.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, List, Optional

import requests

try:
    from ..settings import settings
except ImportError:
    # ``streamlit run .../app.py`` executes this file as a path script with
    # no package context, so the relative import has no parent package —
    # bootstrap the repo root onto sys.path and import absolutely
    import sys
    from pathlib import Path as _Path

    sys.path.insert(0, str(_Path(__file__).resolve().parents[2]))
    from semcode_tpu_torch.settings import settings

HISTORY_LIMIT = 20


def _headers(api_key: Optional[str]) -> Dict[str, str]:
    headers = {"Content-Type": "application/json"}
    if api_key:
        headers["X-API-Key"] = api_key
    return headers


def _request(
    method: str,
    api_root: str,
    path: str,
    api_key: Optional[str],
    json_body: Optional[Dict[str, Any]] = None,
):
    url = f"{api_root.rstrip('/')}{path}"
    resp = requests.request(
        method,
        url,
        headers=_headers(api_key),
        json=json_body,
        timeout=settings.frontend_request_timeout,
    )
    resp.raise_for_status()
    return resp.json()


def _fetch_repositories(api_root: str, api_key: Optional[str]) -> List[Dict]:
    try:
        return _request("GET", api_root, "/repos", api_key)
    except Exception:
        return []


def _run_query(
    api_root: str,
    api_key: Optional[str],
    question: str,
    repos: Optional[List[str]] = None,
    languages: Optional[List[str]] = None,
) -> Dict:
    # push the sidebar filters into the query so retrieval searches the
    # filtered subset on device (server-side tag mask); the client-side
    # source filter below stays as a second line of defence
    body: Dict = {"question": question}
    filters: Dict = {}
    if repos:
        filters["repo"] = list(repos)
    if languages:
        filters["language"] = list(languages)
    if filters:
        body["filters"] = filters
    return _request("POST", api_root, "/query", api_key, body)


def _filter_sources(
    sources: List[Dict], repos: List[str], languages: List[str]
) -> List[Dict]:
    out = sources
    if repos:
        out = [s for s in out if s.get("repo") in repos]
    if languages:
        out = [s for s in out if s.get("language") in languages]
    return out


def _render_diff(a: str, b: str, name_a: str, name_b: str) -> str:
    return "\n".join(
        difflib.unified_diff(
            (a or "").splitlines(),
            (b or "").splitlines(),
            fromfile=name_a,
            tofile=name_b,
            lineterm="",
        )
    )


def run() -> None:  # pragma: no cover - requires streamlit
    import streamlit as st

    st.set_page_config(page_title="semcode-tpu", layout="wide")
    st.title("semcode-tpu · semantic code search")

    if "history" not in st.session_state:
        st.session_state.history = []
    if "active_result" not in st.session_state:
        st.session_state.active_result = None

    with st.sidebar:
        st.header("API")
        api_root = st.text_input("API root", settings.frontend_api_root)
        api_key = st.text_input(
            "API key", settings.frontend_api_key or "", type="password"
        )
        repos = _fetch_repositories(api_root, api_key or None)
        repo_names = [r["name"] for r in repos]
        langs = sorted({l for r in repos for l in (r.get("languages") or [])})
        st.header("Filters")
        repo_sel = st.multiselect("Repositories", repo_names)
        lang_sel = st.multiselect("Languages", langs)
        with st.expander("History"):
            for q in st.session_state.history:
                if st.button(q[:60], key=f"hist_{hash(q)}"):
                    st.session_state.replay = q

    question = st.text_area(
        "Question", value=st.session_state.pop("replay", "")
    )
    col1, col2 = st.columns([1, 1])
    if col1.button("Search") and question.strip():
        try:
            result = _run_query(
                api_root, api_key or None, question.strip(),
                repos=repo_sel, languages=lang_sel,
            )
            st.session_state.active_result = result
            hist = [q for q in st.session_state.history if q != question]
            st.session_state.history = [question, *hist][:HISTORY_LIMIT]
        except Exception as exc:
            st.error(f"Query failed: {exc}")
    if col2.button("Clear"):
        st.session_state.active_result = None

    result = st.session_state.active_result
    if result:
        meta = result.get("meta") or {}
        if meta.get("fallback_used"):
            st.warning(f"Fallback answer ({meta.get('reason', 'LLM unavailable')})")
        st.markdown(result.get("answer", ""))
        sources = _filter_sources(result.get("sources", []), repo_sel, lang_sel)
        for i, s in enumerate(sources, 1):
            st.caption(
                f"{i}. {s.get('repo')}/{s.get('path')} · {s.get('language')}"
                f" · score {s.get('score')}"
            )
            st.code(s.get("snippet") or "", language=s.get("language") or "text")
        if len(sources) >= 2:
            st.subheader("Compare snippets")
            names = [f"{i+1}. {s.get('path')}" for i, s in enumerate(sources)]
            a = st.selectbox("A", names, index=0)
            b = st.selectbox("B", names, index=1)
            ia, ib = names.index(a), names.index(b)
            st.code(
                _render_diff(
                    sources[ia].get("snippet", ""),
                    sources[ib].get("snippet", ""),
                    a,
                    b,
                ),
                language="diff",
            )


def _run_if_under_streamlit() -> None:
    """``streamlit run`` executes this file top-to-bottom and renders
    whatever the script body draws — without this call the page would be
    blank (run() alone just defines the UI)."""
    try:
        from streamlit.runtime.scriptrunner import get_script_run_ctx
    except Exception:  # streamlit absent or private API moved
        return
    if get_script_run_ctx(suppress_warning=True) is not None:
        run()


_run_if_under_streamlit()
