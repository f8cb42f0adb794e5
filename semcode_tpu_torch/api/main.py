"""HTTP API service.

Counterpart of ``semcode_tpu/api/main.py``, with its routes, statuses and
JSON, serving the PyTorch engine:

    GET  /healthz          liveness
    GET  /stats            index/engine introspection  (auth)
    GET  /repos            registry listing           (auth)
    POST /ingest           synchronous ingest         (auth)
    DELETE /repos/{name}   remove a repo + its vectors (auth)
    POST /jobs/ingest      async ingest job           (auth)
    GET  /jobs             all jobs                   (auth)
    GET  /jobs/{id}        one job                    (auth)
    GET  /telemetry        counters snapshot          (auth, 404 if disabled)
    POST /query            RAG query                  (auth, 502 on failure)
    POST /compact          reclaim tombstoned rows    (auth)
    GET  /chunks           chunk listing              (auth)
    POST /chunks/delete    delete by filter           (auth)
    GET  /                 built-in web UI

Implemented on aiohttp. Heavy pipeline work runs in a worker thread pool so
the event loop stays responsive while the card is busy; the engine itself
serializes writes behind the store lock, and searches read one immutable
snapshot of the device tensors. The engine runs on CUDA unless ``device``
(or ``SEMCODE_TORCH_DEVICE``) names the CPU; a kernel that fails to build or
launch fails the request (502), it never drops to a plain version.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from aiohttp import web

from ..device import DeviceLike
from ..logger import configure_logging, get_logger
from ..protocols import IndexerLike, QueryPipelineLike
from ..rag import SemanticSearchPipeline
from ..rag.llm import LOCAL_LLM_PROVIDERS
from ..services import IndexerService, IndexingCallbacks
from ..settings import AppSettings, settings as default_settings
from .batcher import BatcherOverloaded, QueryBatcher
from .dependencies import API_KEY_HEADER, check_api_key, telemetry_enabled
from .jobs import JobLedger, JobSnapshot
from .telemetry import Telemetry

log = get_logger("api")

_OPEN_PATHS = {"/healthz", "/"}
# seconds a shutting-down app waits for its startup warmup (a kernel build
# takes ~12 s on the card)
WARMUP_JOIN_S = 60.0


def build_kernels(config: AppSettings, store) -> List[str]:
    """Build and load the kernel libraries ``store``'s searches can launch
    (nvcc at first use, ~12 s on the card) and return their names; none on
    the CPU. The libraries' own locks make a query that arrives meanwhile
    wait for the same build."""
    device = getattr(store, "device", None)
    if device is None or device.type != "cuda":
        return []
    from ..ops import ivf_scan, scan_top2

    built = []
    if config.index_scan_impl == "pallas":
        scan_top2.load_library()
        built.append("top2_scan")
    if config.index_kind in ("ivf", "auto"):
        ivf_scan.load_library()
        built.append("ivf_scan")
    return built


def warm_encoder(config: AppSettings, pipeline) -> bool:
    """Load the transformer encoder the query path embeds with
    (``tpu-encoder`` / ``tpu-hybrid``) and run it once, so the first query
    finds its weights on the card and cuBLAS initialised; False for the
    other providers, whose first call costs nothing to speak of (or is a
    remote request the warmup must not make)."""
    from ..embeddings.providers import ENCODER_PROVIDERS

    if config.embedding_provider.lower() not in ENCODER_PROVIDERS:
        return False
    pipeline.embeddings.embed_queries(["__warmup__ encoder probe"])
    return True


def warm_decoder(config: AppSettings, pipeline) -> List[int]:
    """Load the ``tpu-lm`` decoder and run one generation at every prompt
    bucket a query can take, so the first answers find the weights on the
    card and every decode graph captured; the buckets, or none for the
    other providers. The warmup query alone would ready one bucket, and
    only over a non-empty store."""
    if (config.rag_provider or "").lower() not in LOCAL_LLM_PROVIDERS:
        return []
    return pipeline._get_llm().warm()


def engine_devices(store) -> Dict[str, Any]:
    """``/stats``' device keys: the engine's backend ("cuda" or "cpu") and
    each card's name, or ``["cpu"]``."""
    device = getattr(store, "device", None)
    if device is not None:
        backend = device.type
    else:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if backend == "cuda":
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
    else:
        names = ["cpu"]
    return {"devices": names, "backend": backend}


def create_app(
    *,
    config: Optional[AppSettings] = None,
    indexer: Optional[IndexerLike] = None,
    pipeline: Optional[QueryPipelineLike] = None,
    job_manager: Optional[JobLedger] = None,
    telemetry: Optional[Telemetry] = None,
    device: DeviceLike = None,
) -> web.Application:
    config = config or default_settings
    indexer = indexer or IndexerService(
        config=config, auto_connect=False, device=device
    )
    pipeline = pipeline or SemanticSearchPipeline(
        config=config, vector_store=indexer.vector_store, device=device
    )
    # durable by default: job state survives API restarts (journal replay
    # marks mid-flight jobs 'interrupted' instead of silently dropping them);
    # workspace_root=None (ephemeral in-memory store) keeps jobs in memory
    job_manager = job_manager or JobLedger(
        Path(config.workspace_root) / "jobs.jsonl"
        if config.workspace_root
        else None
    )
    telemetry = telemetry or Telemetry()
    executor = ThreadPoolExecutor(
        max_workers=config.api_max_workers, thread_name_prefix="semcode"
    )
    # ingest jobs run for minutes-to-hours: give them their OWN worker so
    # N concurrent ingests can never occupy every thread and starve /query
    # traffic into 504s behind them (head-of-line blocking)
    ingest_executor = ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="semcode-ingest"
    )
    batcher = None
    if config.api_batch_window_ms > 0:
        batcher = QueryBatcher(
            pipeline,
            executor,
            max_batch=config.api_batch_max,
            window_ms=config.api_batch_window_ms,
            queue_max=config.api_queue_max,
            split=config.api_batch_split,
        )

    @web.middleware
    async def auth_middleware(request: web.Request, handler):
        if request.path not in _OPEN_PATHS and not check_api_key(
            config, request.headers.get(API_KEY_HEADER)
        ):
            return web.json_response({"detail": "Invalid API key"}, status=401)
        return await handler(request)

    app = web.Application(middlewares=[auth_middleware])
    app["config"] = config
    app["indexer"] = indexer
    app["pipeline"] = pipeline
    app["jobs"] = job_manager
    app["telemetry"] = telemetry

    async def _warmup(app_):
        """Ready the serving path at startup (background, off the event
        loop). On the card the first query would otherwise pay the kernel
        libraries' nvcc build, the encoder's load (``tpu-encoder`` /
        ``tpu-hybrid``) and the decoder's load and graph captures
        (``tpu-lm``); a restarted server over an existing
        workspace also runs one default query, so the first user query
        finds the store loaded and every lazy piece built. The server
        accepts traffic immediately; a query that arrives mid-warmup waits
        on the same build lock. The query is skipped on an empty store,
        everything with ``api_warmup = false``.

        Runs on a DAEMON thread, not the request executor: executor
        threads are non-daemon and joined at interpreter exit, so a
        restart arriving mid-build would block process shutdown; the app's
        cleanup waits for the warmup at most ``WARMUP_JOIN_S``."""
        if not config.api_warmup:
            return

        def go():
            try:
                store = indexer.vector_store
                # connect() loads the workspace snapshot — count() alone
                # reads the init-empty view and reports 0 on a restarted
                # server, which is exactly the case warmup exists for
                store.connect()
                built = build_kernels(config, store)
                if built:
                    log.info("kernels_built", kernels=",".join(built))
                if warm_encoder(config, pipeline):
                    log.info("encoder_warm", provider=config.embedding_provider)
                buckets = warm_decoder(config, pipeline)
                if buckets:
                    log.info("decoder_warm", buckets=",".join(map(str, buckets)))
                if store.count() > 0:
                    pipeline.query("__warmup__ serving path compile probe")
                    log.info("serving_path_warm")
            except Exception as exc:  # noqa: BLE001 — warmup must never kill startup
                log.warning("warmup_failed", error=str(exc))

        t = threading.Thread(target=go, name="semcode-warmup", daemon=True)
        t.start()
        app_["warmup_thread"] = t

    async def _join_warmup(app_):
        """At shutdown, give a warmup still running up to
        ``WARMUP_JOIN_S`` to finish: torch work left on a daemon thread
        while the interpreter exits can abort the process ("terminate
        called without an active exception")."""
        t = app_.get("warmup_thread")
        if t is not None and t.is_alive():
            await asyncio.to_thread(t.join, WARMUP_JOIN_S)

    app.on_startup.append(_warmup)
    app.on_cleanup.append(_join_warmup)

    def _run_blocking(fn, *args):
        return asyncio.get_event_loop().run_in_executor(executor, fn, *args)

    def _run_ingest_blocking(fn, *args):
        return asyncio.get_event_loop().run_in_executor(
            ingest_executor, fn, *args
        )

    # -- helpers ---------------------------------------------------------------

    def _repo_response(
        name: str, path: str, languages, chunk_count, revision=None, result=None
    ) -> Dict:
        out = {
            "name": name,
            "path": path,
            "revision": revision,
            "languages": languages,
            "chunk_count": chunk_count,
        }
        if result is not None:  # ingest outcomes: incremental accounting
            out["embedded_count"] = result.embedded_count
            out["reused_count"] = result.reused_count
            out["pruned_count"] = result.pruned_count
        return out

    def _job_response(job: JobSnapshot) -> Dict[str, Any]:
        return {
            "id": job.id,
            "type": job.type,
            "status": job.status,
            "stage": job.stage,
            "progress": dict(job.progress),
            "result": job.result,
            "error": job.error,
            "duration_ms": job.duration_ms(),
            "created_at": datetime.fromtimestamp(job.created_at).isoformat(),
            "updated_at": datetime.fromtimestamp(job.updated_at).isoformat(),
        }

    def _resolve_include_paths(root: str, include: List[str]) -> List[Path]:
        root_path = Path(root)
        if not root_path.exists():
            raise web.HTTPBadRequest(reason=f"Root path not found: {root_path}")
        paths = []
        for folder in include:
            candidate = root_path / folder
            if not candidate.exists():
                raise web.HTTPBadRequest(
                    reason=f"Included folder not found: {candidate}"
                )
            paths.append(candidate)
        return paths

    def _record_ingest(start: float, ok: bool, metadata=None) -> None:
        if telemetry_enabled(config):
            telemetry.record_ingest(
                duration_ms=(time.time() - start) * 1000.0, ok=ok, metadata=metadata
            )

    def _record_query(start: float, ok: bool, fallback: bool) -> None:
        if telemetry_enabled(config):
            telemetry.record_query(
                duration_ms=(time.time() - start) * 1000.0,
                ok=ok,
                used_fallback=fallback,
            )

    # -- handlers -----------------------------------------------------------------

    async def health(_request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def list_repositories(_request: web.Request) -> web.Response:
        repos = indexer.registry.list()
        return web.json_response(
            [
                _repo_response(
                    r.name,
                    str(indexer.ingestion_manager.workspace / r.name),
                    r.languages,
                    r.chunk_count,
                    r.revision,
                )
                for r in repos
            ]
        )

    async def _parse_ingest_request(request: web.Request) -> Dict[str, Any]:
        try:
            body = await request.json()
        except Exception:
            raise web.HTTPBadRequest(reason="Invalid JSON body")
        if not body.get("name"):
            raise web.HTTPBadRequest(reason="'name' is required")
        include = body.get("include") or []
        if not include:
            raise web.HTTPBadRequest(reason="Include list cannot be empty")
        return {
            "name": body["name"],
            "root": body.get("root", "."),
            "include": include,
            "force": bool(body.get("force", False)),
            "ignore": body.get("ignore"),
        }

    async def ingest_repository(request: web.Request) -> web.Response:
        payload = await _parse_ingest_request(request)
        include_paths = _resolve_include_paths(payload["root"], payload["include"])
        start = time.time()
        try:
            result = await _run_ingest_blocking(
                lambda: indexer.index_repository(
                    include_paths,
                    payload["name"],
                    force=payload["force"],
                    ignore_dirs=payload["ignore"],
                )
            )
        except ValueError as exc:
            # bad client input (e.g. unsafe repo name) — not a server fault
            _record_ingest(
                start, ok=False, metadata={"repo": payload["name"], "error": str(exc)}
            )
            raise web.HTTPBadRequest(reason=str(exc))
        except Exception as exc:
            _record_ingest(
                start, ok=False, metadata={"repo": payload["name"], "error": str(exc)}
            )
            raise web.HTTPInternalServerError(reason=str(exc))
        _record_ingest(start, ok=True, metadata={"repo": payload["name"]})
        return web.json_response(
            _repo_response(
                result.repository.name,
                str(result.repository.path),
                result.repository.languages,
                result.chunk_count,
                result=result,
            )
        )

    def _run_ingest_job(job_id: str, payload: Dict[str, Any]) -> None:
        job_manager.set_status(job_id, "running", stage="initializing")
        start = time.time()
        try:
            include_paths = _resolve_include_paths(
                payload["root"], payload["include"]
            )
            counters = {"copy": 0, "chunk": 0}

            def on_copy(path: Path) -> None:
                counters["copy"] += 1
                job_manager.update_progress(
                    job_id, copy_processed=counters["copy"], last_file=str(path)
                )

            def on_chunk(path: Path) -> None:
                counters["chunk"] += 1
                job_manager.update_progress(
                    job_id, chunk_processed=counters["chunk"], last_chunk=str(path)
                )

            callbacks = IndexingCallbacks(
                copy=on_copy,
                chunk=on_chunk,
                stage=lambda s: job_manager.update_stage(job_id, s),
                embed_progress=lambda done, total: job_manager.update_progress(
                    job_id, embed_completed=done, embed_total=total
                ),
                upsert_progress=lambda done, total: job_manager.update_progress(
                    job_id, upsert_completed=done, upsert_total=total
                ),
            )
            result = indexer.index_repository(
                include_paths,
                payload["name"],
                force=payload["force"],
                ignore_dirs=payload["ignore"],
                callbacks=callbacks,
            )
            repo_payload = _repo_response(
                result.repository.name,
                str(result.repository.path),
                result.repository.languages,
                result.chunk_count,
                result=result,
            )
            job_manager.complete(job_id, repo_payload)
            _record_ingest(
                start, ok=True, metadata={"job_id": job_id, "repo": payload["name"]}
            )
        except web.HTTPException as exc:
            job_manager.fail(job_id, error=exc.reason or str(exc))
            _record_ingest(
                start,
                ok=False,
                metadata={
                    "job_id": job_id,
                    "repo": payload.get("name"),
                    "error": exc.reason,
                },
            )
        except Exception as exc:
            job_manager.fail(job_id, error=str(exc))
            _record_ingest(
                start,
                ok=False,
                metadata={
                    "job_id": job_id,
                    "repo": payload.get("name"),
                    "error": str(exc),
                },
            )

    async def enqueue_ingest(request: web.Request) -> web.Response:
        payload = await _parse_ingest_request(request)
        # validate eagerly so failures bubble to the client immediately
        _resolve_include_paths(payload["root"], payload["include"])
        job = job_manager.create(
            "ingest",
            metadata={"name": payload["name"], "include": payload["include"]},
        )
        # snapshot the queued state before the worker can mutate it
        response = _job_response(job)
        asyncio.get_event_loop().run_in_executor(
            ingest_executor, _run_ingest_job, job.id, payload
        )
        return web.json_response(response)

    async def delete_repository(request: web.Request) -> web.Response:
        """Remove a repo from the registry and delete its vectors."""
        name = request.match_info["name"]
        removed = await _run_blocking(lambda: indexer.remove_repository(name))
        if not removed:
            raise web.HTTPNotFound(reason="Repository not found")
        return web.json_response({"removed": name})

    async def list_chunks(request: web.Request) -> web.Response:
        """Paginated chunk listing with metadata filters."""
        store = indexer.vector_store
        if store is None:
            raise web.HTTPServiceUnavailable(reason="engine unavailable")
        q = request.rel_url.query
        filters = {
            k: q[k] for k in ("repo", "language", "path", "symbol") if k in q
        }
        try:
            offset = max(0, int(q.get("offset", 0)))
            limit = min(max(1, int(q.get("limit", 100))), 1000)
        except ValueError:
            raise web.HTTPBadRequest(reason="offset/limit must be integers")
        include_text = q.get("include_text", "") in ("1", "true", "yes")

        def work():
            store.connect()
            return store.list_chunks(
                filters or None,
                offset=offset,
                limit=limit,
                include_text=include_text,
            )

        return web.json_response(await _run_blocking(work))

    async def delete_chunks(request: web.Request) -> web.Response:
        """Delete-by-filter. Body: {"filters": {...}} — refuses an empty
        filter set."""
        store = indexer.vector_store
        if store is None:
            raise web.HTTPServiceUnavailable(reason="engine unavailable")
        try:
            body = await request.json()
        except Exception:
            raise web.HTTPBadRequest(reason="invalid JSON body")
        filters = (body or {}).get("filters")
        if not isinstance(filters, dict) or not filters:
            raise web.HTTPBadRequest(
                reason="'filters' must be a non-empty object"
            )

        def work():
            store.connect()
            n = store.delete_where(filters)
            if n:
                store.save()
            return {"deleted": n, "rows": store.count()}

        return web.json_response(await _run_blocking(work))

    async def compact_index(_request: web.Request) -> web.Response:
        """Reclaim tombstoned rows and persist (accumulates after
        deletes/re-ingests)."""
        store = indexer.vector_store
        if store is None:
            raise web.HTTPServiceUnavailable(reason="engine unavailable")

        def work() -> dict:
            reclaimed = store.compact()
            if reclaimed:
                store.save()
            return {"reclaimed": reclaimed, "rows": store.count()}

        return web.json_response(await _run_blocking(work))

    async def list_jobs(_request: web.Request) -> web.Response:
        return web.json_response(
            [_job_response(j) for j in job_manager.list().values()]
        )

    async def get_job(request: web.Request) -> web.Response:
        job = job_manager.get(request.match_info["job_id"])
        if job is None:
            raise web.HTTPNotFound(reason="Job not found")
        return web.json_response(_job_response(job))

    async def telemetry_snapshot(_request: web.Request) -> web.Response:
        if not telemetry_enabled(config):
            raise web.HTTPNotFound(reason="Telemetry disabled")
        return web.json_response(telemetry.snapshot())

    async def query(request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except Exception:
            raise web.HTTPBadRequest(reason="Invalid JSON body")
        question = (body.get("question") or "").strip()
        if not question:
            raise web.HTTPBadRequest(reason="Question cannot be empty.")
        top_k = body.get("top_k")
        if top_k is not None:
            from ..index.store import validate_top_k

            try:
                top_k = validate_top_k(top_k, config.search_top_k_max)
            except ValueError as exc:
                raise web.HTTPBadRequest(reason=str(exc))
        filters = body.get("filters")
        if filters is not None and not isinstance(filters, dict):
            raise web.HTTPBadRequest(reason="'filters' must be an object")
        if filters:
            # values must be hashable scalars or lists of them: the batcher
            # groups compatible requests by a frozen (key, value) tuple, and
            # an unhashable value (e.g. a nested object) would otherwise fail
            # EVERY request in the same batch window, not just this one
            for fk, fv in filters.items():
                ok = isinstance(fv, (str, int, float, bool)) or (
                    isinstance(fv, list)
                    and all(isinstance(i, (str, int, float, bool)) for i in fv)
                )
                if not ok:
                    raise web.HTTPBadRequest(
                        reason=(
                            f"filter {fk!r} must be a string/number/bool or a "
                            "list of them"
                        )
                    )
        start = time.time()
        try:
            if batcher is not None:
                coro = batcher.query(question, top_k=top_k, filters=filters)
            else:
                coro = _run_blocking(
                    lambda: pipeline.query(question, top_k=top_k, filters=filters)
                )
            timeout = config.api_query_timeout_s
            result = (
                await asyncio.wait_for(coro, timeout) if timeout > 0 else await coro
            )
        except BatcherOverloaded as exc:
            _record_query(start, ok=False, fallback=False)
            return web.json_response({"detail": str(exc)}, status=503)
        except asyncio.TimeoutError:
            _record_query(start, ok=False, fallback=False)
            return web.json_response(
                {"detail": f"query timed out after {config.api_query_timeout_s}s"},
                status=504,
            )
        except Exception as exc:
            _record_query(start, ok=False, fallback=False)
            return web.json_response({"detail": str(exc)}, status=502)
        meta = result.get("meta", {}) or {}
        fallback = bool(meta.get("fallback_used"))
        _record_query(start, ok=True, fallback=fallback)
        if telemetry_enabled(config) and not meta.get("cached"):
            # per-stage serving attribution (embed/search_device/rerank/...):
            # batch-level timings land once per executed batch — the batcher
            # stamps identical dicts on every result of a batch, so only the
            # de-duplicating first-of-batch share is recorded via batch_size
            stages = meta.get("batch_timings_ms") or meta.get("timings_ms")
            bs = int(meta.get("batch_size") or 1)
            telemetry.record_query_stages(
                stages, batch_size=bs if meta.get("batch_timings_ms") else 1
            )
        return web.json_response(
            {
                "answer": result.get("answer", ""),
                "sources": result.get("sources", []),
                "meta": result.get("meta"),
            }
        )

    async def engine_stats(_request: web.Request) -> web.Response:
        """Index/engine introspection in one JSON blob."""
        store = indexer.vector_store
        index_stats = {}
        if store is not None:
            try:
                await _run_blocking(store.connect)
                index_stats = store.stats()
            except Exception as exc:
                index_stats = {"error": str(exc)}
        return web.json_response({"index": index_stats, **engine_devices(store)})

    async def index_page(_request: web.Request) -> web.Response:
        from ..frontend.webui import INDEX_HTML

        return web.Response(text=INDEX_HTML, content_type="text/html")

    app.router.add_get("/healthz", health)
    app.router.add_get("/stats", engine_stats)
    app.router.add_get("/repos", list_repositories)
    app.router.add_post("/ingest", ingest_repository)
    app.router.add_delete("/repos/{name}", delete_repository)
    app.router.add_post("/jobs/ingest", enqueue_ingest)
    app.router.add_get("/jobs", list_jobs)
    app.router.add_get("/jobs/{job_id}", get_job)
    app.router.add_get("/telemetry", telemetry_snapshot)
    app.router.add_post("/query", query)
    app.router.add_post("/compact", compact_index)
    app.router.add_get("/chunks", list_chunks)
    app.router.add_post("/chunks/delete", delete_chunks)
    app.router.add_get("/", index_page)
    return app


def run() -> None:
    """Console entrypoint: run the API server."""
    configure_logging()
    config = default_settings
    app = create_app(config=config)
    log.info("api_starting", host=config.api_host, port=config.api_port)
    web.run_app(app, host=config.api_host, port=config.api_port, print=None)


if __name__ == "__main__":
    run()
