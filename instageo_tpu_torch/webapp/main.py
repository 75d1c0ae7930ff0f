"""Web backend: the REST API on the standard library's HTTP server.

The port's own copy of ``instageo_tpu/webapp/main.py``, with the same
endpoint surface as the reference (``instageo/new_apps/backend/app/
main.py``): ``POST /api/run-model``, ``GET /api/task/{id}``, ``/api/tasks``,
``/api/queues/status``, ``/api/jobs``, ``/api/models[/{name}]``,
``/api/health``, ``/api/visualize/{task_id}``, and the tile endpoints under
``/api/titiler`` (task-id-keyed, no filesystem paths exposed). JWT
middleware protects all non-public routes; tile routes also take
``?access_token=``. Requests run on threads of a ``ThreadingHTTPServer``
(``webapp/web.py``). The server never touches the card: the stages run in
the queue workers' job processes, on ``INSTAGEO_DEVICE``.

Run: ``python -m instageo_tpu_torch.webapp.main`` (port 8000, or ``PORT``;
``PORT=0`` takes a free port and logs it; workers started unless
INSTAGEO_NO_WORKERS=1).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

from instageo_tpu_torch.webapp import auth, db, queue, web
from instageo_tpu_torch.webapp.auth import AuthError, get_current_user, is_task_owner
from instageo_tpu_torch.webapp.settings import settings
from instageo_tpu_torch.webapp.tasks import Task, TaskStatus
from instageo_tpu_torch.webapp.tiler import TilerService

log = logging.getLogger(__name__)

PUBLIC_ROUTES = {"/api/health", "/api/docs", "/api/openapi.json"}


# ---------------------------------------------------------------------------
# Middleware
# ---------------------------------------------------------------------------


def auth_middleware(request: web.Request, handler) -> web.Response:
    """JWT check for all non-public routes (reference main.py:61-101)."""
    path = request.path
    if path in PUBLIC_ROUTES or not path.startswith("/api"):
        return handler(request)
    if settings.AUTH_DISABLED:
        request["user"] = {"sub": "test-user", "email": "test@example.com"}
        return handler(request)
    header = request.headers.get("Authorization", "")
    token = header[len("Bearer "):] if header.startswith("Bearer ") else ""
    if not token and path.startswith("/api/titiler/"):
        # Map tile layers load through plain <img src> (no headers), so
        # tile routes also accept the token as a query parameter.
        token = request.query.get("access_token", "")
    if not token:
        return web.json_response({"detail": "Missing bearer token"}, status=401)
    try:
        request["user"] = get_current_user(token)
    except AuthError as e:
        return web.json_response({"detail": str(e)}, status=e.status)
    return handler(request)


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------


def run_model(request: web.Request) -> web.Response:
    """POST /api/run-model (reference main.py:242-326)."""
    try:
        body = request.json()
    except json.JSONDecodeError:
        return web.json_response({"detail": "Invalid JSON body"}, status=400)
    if not isinstance(body, dict):
        return web.json_response({"detail": "Body must be a JSON object"},
                                 status=422)
    if body.get("parameters") is not None \
            and not isinstance(body["parameters"], dict):
        return web.json_response(
            {"detail": "parameters must be a JSON object"}, status=422)
    bboxes = body.get("bboxes")
    model_key = body.get("model_key") or body.get("model")
    if not bboxes or not isinstance(bboxes, list):
        return web.json_response({"detail": "bboxes list is required"},
                                 status=422)
    if not model_key:
        return web.json_response({"detail": "model_key is required"},
                                 status=422)
    registry = request.app["registry"]
    try:
        # Reject unknown sizes up front (422): otherwise the task is
        # accepted and only fails in stage 2 when the checkpoint path
        # models/{key}/{size} turns out not to exist.
        req_size = body.get("model_size")
        if req_size:
            sizes = (registry.get_model_metadata(model_key) or {}
                     ).get("sizes") or {}
            if sizes and req_size not in sizes:
                return web.json_response(
                    {"detail": f"Unknown model_size {req_size!r} for "
                               f"{model_key}; available: {sorted(sizes)}"},
                    status=422)
        meta = registry.get_model_metadata_for_size(model_key, req_size)
    except KeyError:
        return web.json_response({"detail": f"Unknown model {model_key}"},
                                 status=404)

    user = request.get("user", {})
    # User-tunable knobs arrive at the TOP LEVEL of the payload (the SPA
    # posts {bboxes, ...modelParams}); a nested "parameters" object is
    # also honored.
    user_overrides = {
        k: body[k]
        for k in ("date", "temporal_tolerance", "cloud_coverage",
                  "temporal_step")
        if body.get(k) not in (None, "")
    }
    parameters = {
        "data_source": meta.get("data_source", "HLS"),
        "chip_size": meta.get("chip_size", 224),
        "num_steps": meta.get("num_steps", 1),
        "temporal_step": meta.get("temporal_step", 30),
        "temporal_tolerance": meta.get("temporal_tolerance", 5),
        **user_overrides,
        **(body.get("parameters") or {}),
    }
    task = Task(bboxes=bboxes, parameters=parameters,
                user_sub=user.get("sub", ""), model_key=model_key,
                model_size=meta.get("size") or "",
                db_path=request.app["db_path"])

    auth_header = request.headers.get("Authorization", "")
    token = auth_header[len("Bearer "):] \
        if auth_header.startswith("Bearer ") else ""

    email = user.get("email", "")
    name = user.get("name", "")
    if not settings.AUTH_DISABLED and token and not email:
        # Access tokens rarely carry profile claims; enrich the user row
        # from Auth0 /userinfo on first sight (reference auth.py:104-159),
        # only when the row isn't already enriched (one network call per
        # user, not per task).
        existing = db.get_user(user.get("sub", ""),
                               db_path=request.app["db_path"])
        if not (existing and existing.get("email")):
            try:
                info = auth.get_userinfo(token)
                email = info.get("email") or ""
                name = info.get("name") or ""
            except Exception as e:
                log.warning("userinfo enrichment failed: %s", e)
    db.upsert_user(user.get("sub", ""), email, name,
                   db_path=request.app["db_path"])
    task.save()
    task.start_data_processing()
    return web.json_response({"task_id": task.task_id,
                              "status": task.status}, status=202)


def get_task(request: web.Request) -> web.Response:
    """GET /api/task/{task_id} (reference main.py:329-362)."""
    task = Task.load(request.match_info["task_id"], request.app["db_path"])
    if task is None:
        return web.json_response({"detail": "Task not found"}, status=404)
    user = request.get("user", {})
    if not settings.AUTH_DISABLED and not is_task_owner(task.to_dict(), user):
        return web.json_response({"detail": "Forbidden"}, status=403)
    return web.json_response(task.to_dict())


def list_tasks_handler(request: web.Request) -> web.Response:
    """GET /api/tasks (reference main.py:365-391)."""
    user = request.get("user", {})
    return web.json_response({"tasks": db.list_tasks(
        user_sub=user.get("sub"), db_path=request.app["db_path"])})


def queues_status(request: web.Request) -> web.Response:
    """GET /api/queues/status (reference main.py:394-400)."""
    return web.json_response(queue.get_queues_status(request.app["db_path"]))


def list_jobs_handler(request: web.Request) -> web.Response:
    """GET /api/jobs: job listing for the queue dashboard (the reference
    deploys rq-dashboard on :9181). With auth enabled, jobs are restricted
    to tasks the caller owns (args/errors carry bboxes and tracebacks)."""
    q = request.query
    try:
        limit = int(q.get("limit", 100))
    except ValueError:
        return web.json_response(
            {"detail": "limit must be an integer"}, status=422)
    jobs = queue.list_jobs(queue_name=q.get("queue"), status=q.get("status"),
                           limit=min(limit, 500), db_path=request.app["db_path"])
    if not settings.AUTH_DISABLED:
        user_sub = request.get("user", {}).get("sub")
        owned = {t["task_id"] for t in db.list_tasks(
            user_sub=user_sub, db_path=request.app["db_path"])}
        jobs = [j for j in jobs if j.get("task_id") in owned]
    return web.json_response({"jobs": jobs})


def list_models(request: web.Request) -> web.Response:
    """GET /api/models (reference main.py:403-441)."""
    return web.json_response(
        {"models": request.app["registry"].get_available_models()})


def get_model(request: web.Request) -> web.Response:
    """GET /api/models/{name} (reference main.py:516-526)."""
    try:
        return web.json_response(
            request.app["registry"].get_model_metadata(
                request.match_info["name"]))
    except KeyError:
        return web.json_response({"detail": "Model not found"}, status=404)


def health(request: web.Request) -> web.Response:
    """GET /api/health: DB + queue/worker probing (reference main.py:444-513)."""
    checks: Dict[str, Any] = {"status": "healthy"}
    try:
        db.get_conn(request.app["db_path"]).execute("SELECT 1")
        checks["database"] = "ok"
    except Exception as e:
        checks["database"] = f"error: {e}"
        checks["status"] = "unhealthy"
    try:
        checks["queues"] = queue.get_queues_status(request.app["db_path"])
    except Exception as e:
        checks["queues"] = f"error: {e}"
        checks["status"] = "unhealthy"
    workers = request.app.get("workers") or []
    checks["workers"] = {
        "count": len(workers),
        "alive": sum(1 for w in workers if w.is_alive()),
    }
    status = 200 if checks["status"] == "healthy" else 503
    return web.json_response(checks, status=status)


def _task_access(request: web.Request, task_id: str):
    """(task, error_response): 404 unknown, 403 not the owner.

    Tile/visualize routes are task-scoped: without this, any authenticated
    user holding a task id could read another user's imagery and
    statistics (reference ``is_task_owner``, auth.py:76-101).
    """
    task = Task.load(task_id, request.app["db_path"])
    if settings.AUTH_DISABLED:
        # Dev/test mode: no ownership to enforce; handlers decide what a
        # missing task row means for them (tiles fall back to file
        # existence).
        return task, None
    if task is None:
        return None, web.json_response({"detail": "Task not found"},
                                       status=404)
    user = request.get("user", {})
    if not is_task_owner(task.to_dict(), user):
        return None, web.json_response({"detail": "Forbidden"}, status=403)
    return task, None


def visualize(request: web.Request) -> web.Response:
    """GET /api/visualize/{task_id} (reference tiler_service.py:45-92)."""
    task_id = request.match_info["task_id"]
    task, err = _task_access(request, task_id)
    if err is not None:
        return err
    if task is None:
        return web.json_response({"detail": "Task not found"}, status=404)
    if task.status != TaskStatus.COMPLETED:
        return web.json_response(
            {"detail": f"Task not completed (status={task.status})"},
            status=409)
    urls = request.app["tiler"].visualize_urls(task_id)
    return web.json_response({"task_id": task_id, "layers": urls})


def _layer_mode(layer: str) -> str:
    return "classes" if layer == "predictions" else "rgb"


def _render_params(request: web.Request, layer: str) -> Dict[str, Any]:
    """Parse TiTiler-style render params the SPA sends: ``mode``,
    ``colormap`` (JSON {class: [r,g,b(,a)]}) and ``rescale=lo,hi``."""
    q = request.query
    params: Dict[str, Any] = {"mode": q.get("mode", _layer_mode(layer))}
    if "colormap" in q:
        try:
            raw = json.loads(q["colormap"])
            cmap = {}
            for k, v in raw.items():  # raises if raw isn't a mapping
                color = tuple(int(c) for c in v)
                if len(color) not in (3, 4):
                    raise ValueError(f"bad color length for class {k}")
                cmap[int(k)] = tuple(min(255, max(0, c)) for c in color)
            params["colormap"] = cmap
        except Exception:
            pass  # malformed colormap: the default class colors, not a 500
    if "rescale" in q:
        try:
            lo, hi = (float(v) for v in q["rescale"].split(","))
            params["value_range"] = (lo, hi)
        except ValueError:
            pass
    return params


def tile_png(request: web.Request) -> web.Response:
    m = request.match_info
    _, err = _task_access(request, m["task_id"])
    if err is not None:
        return err
    try:
        z, x, y = int(m["z"]), int(m["x"]), int(m["y"])
    except ValueError:
        return web.json_response({"detail": "Bad tile coordinates"},
                                 status=422)
    try:
        tiler = request.app["tiler"].get_tiler(m["task_id"], m["layer"])
        png = tiler.render_tile(z, x, y, **_render_params(request, m["layer"]))
    except FileNotFoundError as e:
        return web.json_response({"detail": str(e)}, status=404)
    return web.Response(body=png, content_type="image/png")


def tilejson(request: web.Request) -> web.Response:
    m = request.match_info
    _, err = _task_access(request, m["task_id"])
    if err is not None:
        return err
    try:
        tiler = request.app["tiler"].get_tiler(m["task_id"], m["layer"])
    except FileNotFoundError as e:
        return web.json_response({"detail": str(e)}, status=404)
    url = (f"/api/titiler/{m['task_id']}/{m['layer']}"
           "/tiles/{z}/{x}/{y}.png")
    return web.json_response(tiler.tilejson(url))


def preview_png(request: web.Request) -> web.Response:
    m = request.match_info
    _, err = _task_access(request, m["task_id"])
    if err is not None:
        return err
    try:
        tiler = request.app["tiler"].get_tiler(m["task_id"], m["layer"])
        png = tiler.preview(**_render_params(request, m["layer"]))
    except FileNotFoundError as e:
        return web.json_response({"detail": str(e)}, status=404)
    return web.Response(body=png, content_type="image/png")


def statistics(request: web.Request) -> web.Response:
    m = request.match_info
    _, err = _task_access(request, m["task_id"])
    if err is not None:
        return err
    try:
        tiler = request.app["tiler"].get_tiler(m["task_id"], m["layer"])
        stats = tiler.statistics()
    except FileNotFoundError as e:
        return web.json_response({"detail": str(e)}, status=404)
    return web.json_response(stats)


# ---------------------------------------------------------------------------
# App factory
# ---------------------------------------------------------------------------


def create_app(db_path: Optional[str] = None,
               start_workers: bool = False) -> web.Application:
    from instageo_tpu_torch.serve.registry import ModelRegistry
    from instageo_tpu_torch.webapp.docs import docs_page, openapi_json

    app = web.Application(middlewares=(auth_middleware,))
    if settings.AUTH_DISABLED and not os.environ.get("TESTING"):
        log.warning("API authentication is DISABLED (no AUTH0_DOMAIN "
                    "configured) — do not expose this deployment publicly")
    app["db_path"] = db_path or settings.DATABASE_URL
    app["registry"] = ModelRegistry()
    app["tiler"] = TilerService(settings.TASKS_DATA_DIR)
    db.init_db(app["db_path"])
    app["workers"] = (queue.start_workers(db_path=app["db_path"])
                      if start_workers else [])
    # Non-daemonic workers must be reaped when the server stops.
    app.on_cleanup.append(lambda app: queue.stop_workers(app["workers"]))

    app.add_post("/api/run-model", run_model)
    app.add_get("/api/task/{task_id}", get_task)
    app.add_get("/api/tasks", list_tasks_handler)
    app.add_get("/api/queues/status", queues_status)
    app.add_get("/api/jobs", list_jobs_handler)
    app.add_get("/api/models", list_models)
    app.add_get("/api/models/{name}", get_model)
    app.add_get("/api/health", health)
    # API reference (the reference's FastAPI auto-serves Swagger/openapi).
    app.add_get("/api/docs", docs_page)
    app.add_get("/api/openapi.json", openapi_json)
    app.add_get("/api/visualize/{task_id}", visualize)
    app.add_get("/api/titiler/{task_id}/{layer}/tiles/{z}/{x}/{y}.png", tile_png)
    app.add_get("/api/titiler/{task_id}/{layer}/tilejson.json", tilejson)
    app.add_get("/api/titiler/{task_id}/{layer}/preview.png", preview_png)
    app.add_get("/api/titiler/{task_id}/{layer}/statistics", statistics)

    # Single-page frontend (replaces the reference's React SPA surface).
    static_dir = os.path.join(os.path.dirname(__file__), "static")

    # Inject deployment config (Auth0 tenant, API base) into the SPA at
    # serve time (the reference bakes it in at build time via frontend/.env),
    # so one artifact fits every deploy; rendered once per app.
    with open(os.path.join(static_dir, "index.html")) as fh:
        index_html = fh.read()
    cfg_lines = []
    if settings.AUTH0_DOMAIN and settings.AUTH0_CLIENT_ID:
        cfg_lines.append("window.INSTAGEO_AUTH0 = " + json.dumps({
            "domain": settings.AUTH0_DOMAIN,
            "clientId": settings.AUTH0_CLIENT_ID,
            "audience": settings.AUTH0_AUDIENCE,
        }) + ";")
    if settings.API_BASE_URL:
        cfg_lines.append("window.INSTAGEO_API_BASE = "
                         + json.dumps(settings.API_BASE_URL) + ";")
    index_html = index_html.replace("/*__INSTAGEO_SERVER_CONFIG__*/",
                                    "\n  ".join(cfg_lines))

    def index(_request: web.Request) -> web.Response:
        return web.Response(text=index_html, content_type="text/html")

    def dashboard(_request: web.Request) -> web.Response:
        # Queue dashboard (the reference runs rq-dashboard on :9181; prod
        # deployments should basic-auth this path at the proxy).
        return web.FileResponse(os.path.join(static_dir, "dashboard.html"))

    app.add_get("/", index)
    app.add_get("/dashboard", dashboard)
    app.add_static("/static", static_dir)
    return app


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    start = os.environ.get("INSTAGEO_NO_WORKERS", "") != "1"
    app = create_app(start_workers=start)
    web.run_app(app, port=int(os.environ.get("PORT", 8000)))


if __name__ == "__main__":
    main()
