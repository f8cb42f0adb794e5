"""Gradio client (optional).

Counterpart of ``semcode_tpu/frontend/gradio_app.py`` (19-132) on the
port's settings: lazy gradio import with a helpful error, question box +
API config + comma-separated repo/language filters, answer textbox,
metadata repr, sources dataframe, and a "Load filters" button pulling from
/repos. It talks to the API over HTTP with ``requests`` only. Requires the
optional ``gradio`` package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import requests

from ..settings import settings


def _headers(api_key: Optional[str]) -> dict:
    headers = {"Content-Type": "application/json"}
    if api_key:
        headers["X-API-Key"] = api_key
    return headers


def _search(
    question: str,
    api_root: str,
    api_key: str,
    repo_filter: str,
    language_filter: str,
) -> Tuple[str, str, List[List[str]]]:
    if not question.strip():
        return "", "Enter a question first.", []
    repos = {r.strip() for r in repo_filter.split(",") if r.strip()}
    langs = {l.strip() for l in language_filter.split(",") if l.strip()}
    body = {"question": question}
    filters = {}
    if repos:
        filters["repo"] = sorted(repos)
    if langs:
        filters["language"] = sorted(langs)
    if filters:
        # server-side device tag mask: retrieval searches the filtered subset
        body["filters"] = filters
    try:
        resp = requests.post(
            f"{api_root.rstrip('/')}/query",
            headers=_headers(api_key or None),
            json=body,
            timeout=settings.frontend_request_timeout,
        )
        resp.raise_for_status()
        data = resp.json()
    except Exception as exc:
        return "", f"Query failed: {exc}", []
    rows: List[List[str]] = []
    for s in data.get("sources", []):
        if repos and s.get("repo") not in repos:
            continue
        if langs and s.get("language") not in langs:
            continue
        rows.append(
            [
                s.get("repo") or "",
                s.get("path") or "",
                s.get("language") or "",
                f"{s.get('score'):.4f}" if s.get("score") is not None else "",
                (s.get("snippet") or "")[:300],
            ]
        )
    return data.get("answer", ""), repr(data.get("meta")), rows


def _load_filters(api_root: str, api_key: str) -> Tuple[str, str]:
    try:
        resp = requests.get(
            f"{api_root.rstrip('/')}/repos",
            headers=_headers(api_key or None),
            timeout=settings.frontend_request_timeout,
        )
        resp.raise_for_status()
        repos = resp.json()
    except Exception:
        return "", ""
    names = ",".join(r["name"] for r in repos)
    langs = ",".join(sorted({l for r in repos for l in (r.get("languages") or [])}))
    return names, langs


def run() -> None:  # pragma: no cover - requires gradio
    try:
        import gradio as gr
    except ImportError as exc:
        raise SystemExit(
            "gradio is not installed; use the built-in web UI at "
            f"{settings.frontend_api_root}/ or `pip install gradio`."
        ) from exc

    with gr.Blocks(title="semcode-tpu") as demo:
        gr.Markdown("# semcode-tpu · semantic code search")
        with gr.Row():
            api_root = gr.Textbox(label="API root", value=settings.frontend_api_root)
            api_key = gr.Textbox(
                label="API key", value=settings.frontend_api_key or "",
                type="password",
            )
        with gr.Row():
            repo_filter = gr.Textbox(label="Repositories (comma-separated)")
            language_filter = gr.Textbox(label="Languages (comma-separated)")
            load_btn = gr.Button("Load filters")
        question = gr.Textbox(label="Question", lines=3)
        search_btn = gr.Button("Search", variant="primary")
        answer = gr.Textbox(label="Answer", lines=6)
        meta = gr.Textbox(label="Meta")
        sources = gr.Dataframe(
            headers=["repo", "path", "language", "score", "snippet"],
            label="Sources",
        )
        load_btn.click(
            _load_filters, [api_root, api_key], [repo_filter, language_filter]
        )
        search_btn.click(
            _search,
            [question, api_root, api_key, repo_filter, language_filter],
            [answer, meta, sources],
        )
    demo.launch(server_port=settings.frontend_port)


if __name__ == "__main__":
    run()
