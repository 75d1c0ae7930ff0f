"""Web backend settings (env-overridable).

Counterpart of ``instageo_tpu/webapp/settings.py`` (reference
``instageo/new_apps/backend/app/settings.py``): Auth0 domain/audience,
database URL (sqlite dir auto-created), task TTL, with the same environment
names and defaults, read when the settings are made. A dataclass stands in
for pydantic's ``BaseModel``. One setting the JAX backend lacks: ``DEVICE``
(``INSTAGEO_DEVICE``, ``cuda`` by default), where the stage jobs run the
chip math and the model, as ``--device`` of the data CLIs and ``device=`` of
the run CLI choose it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env(name: str, default: str):
    return field(default_factory=lambda: os.environ.get(name, default))


def _auth_disabled() -> bool:
    # Auth is active only when an Auth0 tenant is configured, matching the
    # SPA, which sends no tokens when window.INSTAGEO_AUTH0 is empty.
    # AUTH_DISABLED=true / TESTING=true force it off; AUTH_DISABLED=false
    # forces it ON even without a domain (hard-fail deployment guard).
    return (
        os.environ.get("AUTH_DISABLED", os.environ.get("TESTING", "")).lower() == "true"
        or (os.environ.get("AUTH_DISABLED", "").lower() != "false"
            and not os.environ.get("AUTH0_DOMAIN", ""))
    )


@dataclass
class BackendSettings:
    AUTH0_DOMAIN: str = _env("AUTH0_DOMAIN", "")
    AUTH0_AUDIENCE: str = _env("AUTH0_AUDIENCE", "")
    # SPA client id, injected into index.html.
    AUTH0_CLIENT_ID: str = _env("AUTH0_CLIENT_ID", "")
    # Optional absolute API base for the SPA when the API is served from a
    # different origin than the static files.
    API_BASE_URL: str = _env("API_BASE_URL", "")
    DATABASE_URL: str = _env("DATABASE_URL", "data/backend.sqlite")
    TASK_TTL: int = field(default_factory=lambda: int(os.environ.get("REDIS_TTL", 24 * 3600)))
    TASKS_DATA_DIR: str = _env("TASKS_DATA_DIR", "data/tasks")
    MODELS_PATH: str = _env("MODELS_PATH", "models")
    AUTH_DISABLED: bool = field(default_factory=_auth_disabled)
    DEVICE: str = _env("INSTAGEO_DEVICE", "cuda")

    def __post_init__(self) -> None:
        # Auto-create the sqlite directory; URL-style DSNs
        # (postgresql://...) are not paths.
        if "://" not in self.DATABASE_URL:
            db_dir = os.path.dirname(self.DATABASE_URL)
            if db_dir:
                os.makedirs(db_dir, exist_ok=True)


settings = BackendSettings()
