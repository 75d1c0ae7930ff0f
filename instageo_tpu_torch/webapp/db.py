"""Persistence: sqlite3 users/tasks/jobs store.

The port's own copy of ``instageo_tpu/webapp/db.py`` (the reference's
SQLAlchemy + Redis split, ``instageo/new_apps/backend/app/{models,db,crud,
redis_client}.py``, as one sqlite database): tasks and their stages live in
the ``tasks`` table, the job queue is a table with atomic claim semantics
(see queue.py), and WAL mode makes concurrent worker processes safe. A
postgres ``DATABASE_URL`` binds whichever DBAPI driver is installed.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

from instageo_tpu_torch.webapp.settings import settings

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    sub TEXT PRIMARY KEY,
    email TEXT,
    name TEXT,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS tasks (
    task_id TEXT PRIMARY KEY,
    user_sub TEXT,
    status TEXT,
    bboxes TEXT,
    parameters TEXT,
    stages TEXT,
    model_key TEXT,
    model_size TEXT,
    error TEXT,
    created_at REAL,
    updated_at REAL,
    expires_at REAL
);
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY,
    queue TEXT,
    task_id TEXT,
    func TEXT,
    args TEXT,
    status TEXT,
    timeout_s REAL,
    enqueued_at REAL,
    started_at REAL,
    finished_at REAL,
    result TEXT,
    error TEXT
);
CREATE INDEX IF NOT EXISTS idx_jobs_queue_status ON jobs(queue, status);
CREATE INDEX IF NOT EXISTS idx_tasks_user ON tasks(user_sub);
CREATE TABLE IF NOT EXISTS dead_letters (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    payload TEXT,
    error TEXT,
    created_at REAL
);
"""

_local = threading.local()


# ---------------------------------------------------------------------------
# Postgres support (reference db.py:10-25 accepts a postgres DATABASE_URL
# through SQLAlchemy; here a thin DBAPI adapter binds to whichever driver
# is installed and translates the sqlite dialect)
# ---------------------------------------------------------------------------


def is_postgres_url(path: str) -> bool:
    return path.startswith(("postgres://", "postgresql://"))


def translate_sql_to_pg(sql: str) -> str:
    """sqlite dialect -> postgres: placeholders and schema types."""
    sql = sql.replace("?", "%s")
    sql = sql.replace("INTEGER PRIMARY KEY AUTOINCREMENT",
                      "BIGSERIAL PRIMARY KEY")
    sql = sql.replace(" REAL", " DOUBLE PRECISION")
    return sql


def _pg_driver():
    for name in ("psycopg", "psycopg2", "pg8000.dbapi"):
        try:
            import importlib

            return importlib.import_module(name)
        except ImportError:
            continue
    raise ImportError(
        "DATABASE_URL points at postgres but no driver is installed "
        "(tried psycopg, psycopg2, pg8000). Install one, or use a sqlite "
        "path.")


class _PgRow(dict):
    """Mapping + positional row (sqlite3.Row-compatible surface)."""

    def __init__(self, cols, values):
        super().__init__(zip(cols, values))
        self._values = tuple(values)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._values[key]
        return dict.__getitem__(self, key)

    def __iter__(self):
        # sqlite3.Row iterates VALUES; dict iterates keys — tuple
        # unpacking like ``(n,) = row`` must yield values, not column
        # names.
        return iter(self._values)


class _PgCursorResult:
    def __init__(self, cursor):
        self._cursor = cursor
        self.rowcount = cursor.rowcount

    def _cols(self):
        return [d[0] for d in self._cursor.description or []]

    def fetchone(self):
        row = self._cursor.fetchone()
        return None if row is None else _PgRow(self._cols(), row)

    def fetchall(self):
        cols = None
        out = []
        for row in self._cursor.fetchall():
            cols = cols or self._cols()
            out.append(_PgRow(cols, row))
        return out


class PgConnection:
    """sqlite3.Connection-shaped wrapper over a postgres DBAPI driver."""

    def __init__(self, url: str):
        self._raw = _pg_driver().connect(url)

    def execute(self, sql: str, params=()):
        cur = self._raw.cursor()
        cur.execute(translate_sql_to_pg(sql), tuple(params))
        return _PgCursorResult(cur)

    def executescript(self, script: str):
        cur = self._raw.cursor()
        for stmt in script.split(";"):
            stmt = stmt.strip()
            if stmt and not stmt.upper().startswith("PRAGMA"):
                cur.execute(translate_sql_to_pg(stmt))
        return cur

    def commit(self):
        self._raw.commit()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self._raw.commit()
        else:
            self._raw.rollback()


def get_conn(db_path: Optional[str] = None):
    """Per-thread connection with WAL + row factory (sqlite) or a DBAPI
    adapter (postgres DATABASE_URLs, reference db.py:10-25)."""
    path = db_path or settings.DATABASE_URL
    key = f"conn_{path}"
    conn = getattr(_local, key, None)
    if conn is None:
        if is_postgres_url(path):
            conn = PgConnection(path)
            conn.executescript(_SCHEMA)
            conn.commit()
        else:
            conn = sqlite3.connect(path, timeout=30.0)
            conn.row_factory = sqlite3.Row
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA busy_timeout=30000")
            conn.executescript(_SCHEMA)
            conn.commit()
        setattr(_local, key, conn)
    return conn


def init_db(db_path: Optional[str] = None) -> None:
    get_conn(db_path)


def reset_local_conns() -> None:
    """Drop cached per-thread connections (call in a freshly forked child —
    sqlite connections must not be shared across fork)."""
    for key in list(vars(_local)):
        delattr(_local, key)


# -- users -------------------------------------------------------------------


def upsert_user(sub: str, email: str = "", name: str = "",
                db_path: Optional[str] = None) -> None:
    conn = get_conn(db_path)
    # Keep previously enriched profile fields when the caller has none
    # (access-token claims rarely carry email/name; /userinfo does).
    conn.execute(
        "INSERT INTO users(sub, email, name, created_at) VALUES(?,?,?,?) "
        "ON CONFLICT(sub) DO UPDATE SET "
        "email=CASE WHEN excluded.email != '' THEN excluded.email "
        "ELSE users.email END, "
        "name=CASE WHEN excluded.name != '' THEN excluded.name "
        "ELSE users.name END",
        (sub, email, name, time.time()))
    conn.commit()


def get_user(sub: str, db_path: Optional[str] = None
             ) -> Optional[Dict[str, Any]]:
    conn = get_conn(db_path)
    row = conn.execute(
        "SELECT sub, email, name, created_at FROM users WHERE sub=?",
        (sub,)).fetchone()
    return dict(row) if row else None


# -- tasks -------------------------------------------------------------------


def save_task(task: Dict[str, Any], db_path: Optional[str] = None) -> None:
    conn = get_conn(db_path)
    now = time.time()
    conn.execute(
        """INSERT INTO tasks(task_id, user_sub, status, bboxes, parameters,
               stages, model_key, model_size, error, created_at, updated_at,
               expires_at)
           VALUES(?,?,?,?,?,?,?,?,?,?,?,?)
           ON CONFLICT(task_id) DO UPDATE SET
               status=excluded.status, stages=excluded.stages,
               error=excluded.error, updated_at=excluded.updated_at,
               expires_at=excluded.expires_at""",
        (
            task["task_id"], task.get("user_sub"), task.get("status"),
            json.dumps(task.get("bboxes")), json.dumps(task.get("parameters")),
            json.dumps(task.get("stages")), task.get("model_key"),
            task.get("model_size"), task.get("error"),
            task.get("created_at", now), now,
            # TTL refreshes on every write (the reference's Redis hashes
            # get their TTL reset per write too): slow-but-progressing
            # tasks are not purged; only tasks with NO writes for a full
            # TTL window expire.
            task.get("expires_at", now + settings.TASK_TTL),
        ))
    conn.commit()


def _row_to_task(row: sqlite3.Row) -> Dict[str, Any]:
    d = dict(row)
    for key in ("bboxes", "parameters", "stages"):
        if d.get(key):
            d[key] = json.loads(d[key])
    return d


def load_task(task_id: str, db_path: Optional[str] = None) -> Optional[Dict]:
    row = get_conn(db_path).execute(
        "SELECT * FROM tasks WHERE task_id=?", (task_id,)).fetchone()
    return _row_to_task(row) if row else None


def list_tasks(user_sub: Optional[str] = None, limit: int = 100,
               db_path: Optional[str] = None) -> List[Dict]:
    conn = get_conn(db_path)
    if user_sub:
        rows = conn.execute(
            "SELECT * FROM tasks WHERE user_sub=? ORDER BY created_at DESC "
            "LIMIT ?", (user_sub, limit)).fetchall()
    else:
        rows = conn.execute(
            "SELECT * FROM tasks ORDER BY created_at DESC LIMIT ?",
            (limit,)).fetchall()
    return [_row_to_task(r) for r in rows]


def dead_letter(payload: Dict, error: str, db_path: Optional[str] = None) -> None:
    """Persistence-failure fallback store (reference redis_client.py:282-395)."""
    conn = get_conn(db_path)
    conn.execute("INSERT INTO dead_letters(payload, error, created_at) "
                 "VALUES(?,?,?)", (json.dumps(payload), error, time.time()))
    conn.commit()
