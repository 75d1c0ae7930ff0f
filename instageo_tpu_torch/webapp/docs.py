"""API documentation: OpenAPI 3.1 spec + a self-contained docs page.

The port's own copy of ``instageo_tpu/webapp/docs.py``. The reference
backend is FastAPI, which auto-serves ``/openapi.json`` and Swagger UI at
``/docs`` (reference ``new_apps/backend/app/main.py:47``); here the spec is
declared explicitly, one entry per registered route, and the docs page is
rendered server-side (no CDN assets; deployments are often air-gapped).
"""

from __future__ import annotations

import html
import json
from typing import Any, Dict

from instageo_tpu_torch.webapp import web

_TASK_SCHEMA = {
    "type": "object",
    "properties": {
        "task_id": {"type": "string"},
        "user_sub": {"type": "string"},
        "status": {"type": "string", "enum": [
            "pending", "data_processing", "model_prediction",
            "visualization_preparation", "completed", "failed"]},
        "bboxes": {"type": "array", "items": {
            "type": "array", "items": {"type": "number"},
            "minItems": 4, "maxItems": 4,
            "description": "[west, south, east, north] in EPSG:4326"}},
        "parameters": {"type": "object"},
        "stages": {"type": "object"},
        "model_key": {"type": "string"},
        "model_size": {"type": "string"},
        "error": {"type": ["string", "null"]},
        "created_at": {"type": "number"},
    },
}

_MODEL_SCHEMA = {
    "type": "object",
    "properties": {
        "model_key": {"type": "string"},
        "name": {"type": "string"},
        "description": {"type": "string"},
        "model_type": {"type": "string", "enum": ["seg", "reg"]},
        "classes_mapping": {"type": "object"},
        "data_source": {"type": "string", "enum": ["HLS", "S2", "S1"]},
        "chip_size": {"type": "integer"},
        "num_steps": {"type": "integer"},
        "temporal_step": {"type": "integer"},
        "temporal_tolerance": {"type": "integer"},
        "default_size": {"type": "string"},
        "sizes": {"type": "object"},
    },
}

_ERROR = {"type": "object",
          "properties": {"detail": {"type": "string"}}}

_TILE_PARAMS = [
    {"name": "task_id", "in": "path", "required": True,
     "schema": {"type": "string"}},
    {"name": "layer", "in": "path", "required": True,
     "schema": {"type": "string", "enum": ["chips", "predictions"]}},
]

_RENDER_QUERY = [
    {"name": "mode", "in": "query", "required": False,
     "schema": {"type": "string", "enum": ["rgb", "classes", "gray"]},
     "description": "Render mode; defaults to rgb for chips, "
                    "classes for predictions."},
    {"name": "colormap", "in": "query", "required": False,
     "schema": {"type": "string"},
     "description": 'JSON {class: [r,g,b(,a)]} per-class color override.'},
    {"name": "rescale", "in": "query", "required": False,
     "schema": {"type": "string"},
     "description": '"lo,hi" value range for rgb/gray stretching.'},
    {"name": "access_token", "in": "query", "required": False,
     "schema": {"type": "string"},
     "description": "JWT for <img>-loaded tiles (no headers available)."},
]


def _json_response(desc: str, schema: Dict[str, Any]) -> Dict[str, Any]:
    return {"description": desc,
            "content": {"application/json": {"schema": schema}}}


def build_openapi_spec() -> Dict[str, Any]:
    """The full REST surface (same endpoints as reference main.py)."""
    xyz = [{"name": n, "in": "path", "required": True,
            "schema": {"type": "integer"}} for n in ("z", "x", "y")]
    return {
        "openapi": "3.1.0",
        "info": {
            "title": "InstaGeo API",
            "version": "1.0.0",
            "description": (
                "Geospatial ML task API: submit bounding boxes + a model, "
                "poll the 3-stage task pipeline (data processing → model "
                "prediction → visualization preparation), then stream map "
                "tiles of the inputs and predictions."),
        },
        "components": {
            "schemas": {"Task": _TASK_SCHEMA, "Model": _MODEL_SCHEMA,
                        "Error": _ERROR},
            "securitySchemes": {
                "bearerAuth": {"type": "http", "scheme": "bearer",
                               "bearerFormat": "JWT"}},
        },
        "security": [{"bearerAuth": []}],
        "paths": {
            "/api/run-model": {"post": {
                "summary": "Submit an inference task",
                "requestBody": {"required": True, "content": {
                    "application/json": {"schema": {
                        "type": "object",
                        "required": ["bboxes", "model_key"],
                        "properties": {
                            "bboxes": _TASK_SCHEMA["properties"]["bboxes"],
                            "model_key": {"type": "string"},
                            "model_size": {"type": "string"},
                            "date": {"type": "string", "format": "date"},
                            "temporal_tolerance": {"type": "integer"},
                            "temporal_step": {"type": "integer"},
                            "cloud_coverage": {"type": "integer"},
                            "parameters": {"type": "object"},
                        }}}}},
                "responses": {
                    "202": _json_response("Task accepted", {
                        "type": "object", "properties": {
                            "task_id": {"type": "string"},
                            "status": {"type": "string"}}}),
                    "404": _json_response("Unknown model", _ERROR),
                    "422": _json_response("Invalid payload", _ERROR)}}},
            "/api/task/{task_id}": {"get": {
                "summary": "Task status + stage detail",
                "parameters": [{"name": "task_id", "in": "path",
                                "required": True,
                                "schema": {"type": "string"}}],
                "responses": {
                    "200": _json_response("Task", _TASK_SCHEMA),
                    "403": _json_response("Not the task owner", _ERROR),
                    "404": _json_response("Unknown task", _ERROR)}}},
            "/api/tasks": {"get": {
                "summary": "List the caller's tasks",
                "responses": {"200": _json_response("Tasks", {
                    "type": "object", "properties": {
                        "tasks": {"type": "array",
                                  "items": _TASK_SCHEMA}}})}}},
            "/api/queues/status": {"get": {
                "summary": "Per-queue job counts",
                "responses": {"200": _json_response("Counts by status", {
                    "type": "object"})}}},
            "/api/jobs": {"get": {
                "summary": "Job listing (queue dashboard)",
                "parameters": [
                    {"name": "queue", "in": "query", "required": False,
                     "schema": {"type": "string"}},
                    {"name": "status", "in": "query", "required": False,
                     "schema": {"type": "string"}},
                    {"name": "limit", "in": "query", "required": False,
                     "schema": {"type": "integer", "maximum": 500}}],
                "responses": {"200": _json_response("Jobs", {
                    "type": "object", "properties": {
                        "jobs": {"type": "array",
                                 "items": {"type": "object"}}}})}}},
            "/api/models": {"get": {
                "summary": "Deployable-model catalog",
                "responses": {"200": _json_response("Models", {
                    "type": "object", "properties": {
                        "models": {"type": "array",
                                   "items": _MODEL_SCHEMA}}})}}},
            "/api/models/{name}": {"get": {
                "summary": "One model's metadata",
                "parameters": [{"name": "name", "in": "path",
                                "required": True,
                                "schema": {"type": "string"}}],
                "responses": {
                    "200": _json_response("Model", _MODEL_SCHEMA),
                    "404": _json_response("Unknown model", _ERROR)}}},
            "/api/health": {"get": {
                "summary": "Liveness: DB, queues, workers",
                "security": [],
                "responses": {
                    "200": _json_response("Healthy", {"type": "object"}),
                    "503": _json_response("Unhealthy", {"type": "object"})}}},
            "/api/visualize/{task_id}": {"get": {
                "summary": "Tile/tilejson/preview/statistics URLs per layer",
                "parameters": [{"name": "task_id", "in": "path",
                                "required": True,
                                "schema": {"type": "string"}}],
                "responses": {
                    "200": _json_response("Layer URL map", {"type": "object"}),
                    "404": _json_response("Unknown task", _ERROR),
                    "409": _json_response("Task not completed", _ERROR)}}},
            "/api/titiler/{task_id}/{layer}/tiles/{z}/{x}/{y}.png": {"get": {
                "summary": "XYZ map tile (Web Mercator)",
                "parameters": _TILE_PARAMS + xyz + _RENDER_QUERY,
                "responses": {
                    "200": {"description": "PNG tile", "content": {
                        "image/png": {"schema": {
                            "type": "string", "format": "binary"}}}},
                    "404": _json_response("No COG for task/layer", _ERROR)}}},
            "/api/titiler/{task_id}/{layer}/tilejson.json": {"get": {
                "summary": "TileJSON for the layer",
                "parameters": _TILE_PARAMS,
                "responses": {
                    "200": _json_response("TileJSON", {"type": "object"}),
                    "404": _json_response("No COG for task/layer", _ERROR)}}},
            "/api/titiler/{task_id}/{layer}/preview.png": {"get": {
                "summary": "Whole-layer preview image",
                "parameters": _TILE_PARAMS + _RENDER_QUERY,
                "responses": {
                    "200": {"description": "PNG preview", "content": {
                        "image/png": {"schema": {
                            "type": "string", "format": "binary"}}}},
                    "404": _json_response("No COG for task/layer", _ERROR)}}},
            "/api/titiler/{task_id}/{layer}/statistics": {"get": {
                "summary": "Per-band statistics of the layer COG",
                "parameters": _TILE_PARAMS,
                "responses": {
                    "200": _json_response("Band stats", {"type": "object"}),
                    "404": _json_response("No COG for task/layer", _ERROR)}}},
        },
    }


_METHOD_ORDER = ("get", "post", "put", "patch", "delete")


def _render_docs_html(spec: Dict[str, Any]) -> str:
    """Server-rendered reference page (Swagger-UI stand-in, zero CDN)."""
    rows = []
    for path, methods in spec["paths"].items():
        for method in _METHOD_ORDER:
            op = methods.get(method)
            if not op:
                continue
            params = "".join(
                f"<li><code>{html.escape(p['name'])}</code> "
                f"<em>({p['in']}{', required' if p.get('required') else ''})"
                f"</em> {html.escape(p.get('description', ''))}</li>"
                for p in op.get("parameters", []))
            responses = ", ".join(
                f"<code>{html.escape(code)}</code> "
                f"{html.escape(r.get('description', ''))}"
                for code, r in sorted(op.get("responses", {}).items()))
            body = ""
            if "requestBody" in op:
                schema = (op["requestBody"]["content"]
                          ["application/json"]["schema"])
                body = ("<details><summary>Request body</summary><pre>"
                        + html.escape(json.dumps(schema, indent=2))
                        + "</pre></details>")
            rows.append(
                f'<section class="op"><h3><span class="m {method}">'
                f"{method.upper()}</span> <code>{html.escape(path)}</code>"
                f"</h3><p>{html.escape(op.get('summary', ''))}</p>"
                + (f"<ul>{params}</ul>" if params else "")
                + body
                + (f"<p class='resp'>Responses: {responses}</p>"
                   if responses else "")
                + "</section>")
    info = spec["info"]
    return f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{html.escape(info['title'])} — API docs</title>
<style>
 body {{ font: 15px/1.5 system-ui, sans-serif; margin: 0 auto;
        max-width: 60rem; padding: 2rem 1rem; color: #1c2733; }}
 h1 {{ margin-bottom: .2rem; }}
 .sub {{ color: #5b6b7b; margin-top: 0; }}
 .op {{ border: 1px solid #d7dee6; border-radius: 8px;
       padding: .2rem 1rem .6rem; margin: .8rem 0; }}
 .op h3 {{ margin: .6rem 0 .2rem; font-size: 1rem; }}
 .m {{ display: inline-block; min-width: 3.4rem; text-align: center;
      border-radius: 4px; color: #fff; font-size: .78rem;
      padding: .15rem .4rem; vertical-align: 2px; }}
 .m.get {{ background: #2f7d4f; }} .m.post {{ background: #b35309; }}
 code {{ background: #f2f5f8; padding: .05rem .3rem; border-radius: 3px; }}
 .resp {{ color: #5b6b7b; font-size: .9rem; margin: .3rem 0 0; }}
 pre {{ background: #f2f5f8; padding: .6rem; border-radius: 6px;
       overflow-x: auto; font-size: .82rem; }}
 a {{ color: #1160a8; }}
</style></head><body>
<h1>{html.escape(info['title'])}</h1>
<p class="sub">{html.escape(info['description'])}<br>
Machine-readable spec: <a href="/api/openapi.json">/api/openapi.json</a>
&middot; version {html.escape(info['version'])}</p>
{''.join(rows)}
</body></html>"""


def openapi_json(_request: web.Request) -> web.Response:
    return web.json_response(build_openapi_spec())


def docs_page(_request: web.Request) -> web.Response:
    return web.Response(text=_render_docs_html(build_openapi_spec()),
                        content_type="text/html")
