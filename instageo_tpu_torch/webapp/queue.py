"""Job queue: sqlite-backed queues + worker processes (RQ/Redis replacement).

The port's own copy of ``instageo_tpu/webapp/queue.py``: the reference
distributes stage jobs over three RQ queues consumed by worker containers
(``instageo/new_apps/backend/app/jobs.py``); here the queues live in sqlite
with atomic claim updates, one worker process per queue, and each job runs
in a killable child process of its worker (or in process, for tests and
``drain``). Same queue names, timeouts, and job-status surface.
"""

from __future__ import annotations

import importlib
import json
import logging
import multiprocessing
import os
import signal
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional

from instageo_tpu_torch.webapp import db

log = logging.getLogger(__name__)

# Worker/job processes use the spawn start method: a forked child of a
# process that has initialised CUDA cannot use the card, and the enclosing
# app (or the test runner) may hold a multithreaded runtime whose held
# mutexes a forked child would inherit. Spawned children re-import their
# target module fresh, which is also what the reference's RQ workers do
# (separate worker containers, jobs.py).
_mp = multiprocessing.get_context("spawn")

QUEUE_DATA_PROCESSING = "data-processing"
QUEUE_MODEL_PREDICTION = "model-prediction"
QUEUE_VISUALIZATION = "visualization-preparation"
ALL_QUEUES = (QUEUE_DATA_PROCESSING, QUEUE_MODEL_PREDICTION, QUEUE_VISUALIZATION)

# Reference enqueue timeouts: 2h data, 1h prediction, 1h viz (tasks.py:259-307).
DEFAULT_TIMEOUTS = {
    QUEUE_DATA_PROCESSING: 2 * 3600.0,
    QUEUE_MODEL_PREDICTION: 3600.0,
    QUEUE_VISUALIZATION: 3600.0,
}


class JobStatus:
    QUEUED = "queued"
    STARTED = "started"
    FINISHED = "finished"
    FAILED = "failed"
    TIMED_OUT = "timed_out"


def enqueue(queue: str, func: str, args: Dict[str, Any], task_id: str = "",
            timeout_s: Optional[float] = None,
            db_path: Optional[str] = None) -> str:
    """Add a job; ``func`` is a ``module:function`` import path."""
    job_id = uuid.uuid4().hex
    conn = db.get_conn(db_path)
    conn.execute(
        "INSERT INTO jobs(job_id, queue, task_id, func, args, status, "
        "timeout_s, enqueued_at) VALUES(?,?,?,?,?,?,?,?)",
        (job_id, queue, task_id, func, json.dumps(args), JobStatus.QUEUED,
         timeout_s or DEFAULT_TIMEOUTS.get(queue, 3600.0), time.time()))
    conn.commit()
    return job_id


def claim_next(queue: str, db_path: Optional[str] = None) -> Optional[Dict]:
    """Atomically claim the oldest queued job."""
    conn = db.get_conn(db_path)
    with conn:
        row = conn.execute(
            "SELECT * FROM jobs WHERE queue=? AND status=? "
            "ORDER BY enqueued_at LIMIT 1", (queue, JobStatus.QUEUED)).fetchone()
        if row is None:
            return None
        updated = conn.execute(
            "UPDATE jobs SET status=?, started_at=? WHERE job_id=? AND status=?",
            (JobStatus.STARTED, time.time(), row["job_id"], JobStatus.QUEUED))
        if updated.rowcount == 0:
            return None
    job = dict(row)
    job["args"] = json.loads(job["args"])
    return job


def _finish(job_id: str, status: str, result: Any = None,
            error: Optional[str] = None, db_path: Optional[str] = None) -> None:
    conn = db.get_conn(db_path)
    conn.execute(
        "UPDATE jobs SET status=?, finished_at=?, result=?, error=? "
        "WHERE job_id=?",
        (status, time.time(), json.dumps(result, default=str), error, job_id))
    conn.commit()


def run_job(job: Dict, db_path: Optional[str] = None) -> bool:
    """Execute one claimed job; returns success."""
    module_name, func_name = job["func"].split(":")
    try:
        fn = getattr(importlib.import_module(module_name), func_name)
        result = fn(**job["args"])
        _finish(job["job_id"], JobStatus.FINISHED, result, db_path=db_path)
        return True
    except Exception as e:
        log.error("Job %s failed: %s", job["job_id"], e)
        _finish(job["job_id"], JobStatus.FAILED,
                error=f"{e}\n{traceback.format_exc()}", db_path=db_path)
        return False


def _fail_task_for(job: Dict, reason: str,
                   db_path: Optional[str] = None) -> None:
    """Mark the job's owning task failed at the stage its queue maps to."""
    if not job.get("task_id"):
        return
    from instageo_tpu_torch.webapp.tasks import Task

    task = Task.load(job["task_id"], db_path)
    if task and task.status not in ("completed", "failed"):
        stage = {
            QUEUE_DATA_PROCESSING: "data_processing",
            QUEUE_MODEL_PREDICTION: "model_prediction",
            QUEUE_VISUALIZATION: "visualization_preparation",
        }.get(job["queue"], "data_processing")
        task.fail(stage, reason)


def _job_child(job: Dict, db_path: Optional[str]) -> None:
    db.reset_local_conns()  # never reuse the parent's sqlite fds post-fork
    run_job(job, db_path)


# The worker's in-flight job child (per worker process): the SIGTERM
# handler must kill it on shutdown, or terminating the worker while it
# blocks in join() re-parents the child to init and the job keeps
# running (and using the card) after the app is gone.
_current_child = None
_current_job: Optional[Dict] = None


def _terminate_current_child(db_path: Optional[str] = None) -> None:
    child, job = _current_child, _current_job
    if child is not None and child.is_alive():
        child.terminate()
        child.join(5.0)
        if child.is_alive():
            child.kill()
        if job is not None:
            try:
                _finish(job["job_id"], JobStatus.FAILED,
                        error="worker stopped during shutdown",
                        db_path=db_path)
                _fail_task_for(job, "worker stopped during shutdown",
                               db_path)
            except Exception:
                pass  # bookkeeping is best-effort inside a signal handler


def run_job_isolated(job: Dict, db_path: Optional[str] = None) -> bool:
    """Run a claimed job in a killable child process, enforcing timeout_s.

    This is the reference's RQ work-horse model (rq kills the horse on
    timeout): without it a hung job blocks its single worker loop forever
    and the queue is wedged even after reap_timeouts marks it timed_out.
    """
    global _current_child, _current_job
    timeout_s = job.get("timeout_s") or DEFAULT_TIMEOUTS.get(job["queue"], 3600.0)
    proc = _mp.Process(target=_job_child, args=(job, db_path))
    _current_child, _current_job = proc, job
    proc.start()
    try:
        proc.join(timeout_s)
    finally:
        _current_child = _current_job = None
    if proc.is_alive():
        proc.terminate()
        proc.join(10.0)
        if proc.is_alive():
            proc.kill()
            proc.join()
        reason = f"killed after exceeding {timeout_s}s timeout"
        _finish(job["job_id"], JobStatus.TIMED_OUT, error=reason,
                db_path=db_path)
        _fail_task_for(job, reason, db_path)
        return False
    current = get_job(job["job_id"], db_path)
    if current and current["status"] == JobStatus.STARTED:
        # Child died without recording an outcome (segfault, OOM-kill...).
        reason = f"worker child exited with rc={proc.exitcode}"
        _finish(job["job_id"], JobStatus.FAILED, error=reason, db_path=db_path)
        _fail_task_for(job, reason, db_path)
        return False
    return bool(current) and current["status"] == JobStatus.FINISHED


def reap_timeouts(db_path: Optional[str] = None) -> int:
    """Mark started jobs past their timeout as timed_out and fail the task.

    Enforces the reference's RQ job timeouts (jobs run in worker processes;
    a hung stage must not wedge its task forever — tasks.py:313-361).
    """
    conn = db.get_conn(db_path)
    now = time.time()
    rows = conn.execute(
        "SELECT job_id, task_id, queue, started_at, timeout_s FROM jobs "
        "WHERE status=?", (JobStatus.STARTED,)).fetchall()
    reaped = 0
    for row in rows:
        if row["started_at"] and now - row["started_at"] > row["timeout_s"]:
            _finish(row["job_id"], JobStatus.TIMED_OUT,
                    error=f"timed out after {row['timeout_s']}s",
                    db_path=db_path)
            reaped += 1
            _fail_task_for(dict(row), f"stage timed out after "
                           f"{row['timeout_s']}s", db_path)
    reaped += reap_expired_tasks(db_path)
    return reaped


def reap_expired_tasks(db_path: Optional[str] = None) -> int:
    """Purge expired NON-terminal tasks (the reference's Redis TTL).

    The reference stores in-progress task/stage hashes in Redis with a
    24 h TTL (redis_client.py, settings.REDIS_TTL) — abandoned tasks
    evaporate; completed/failed tasks persist to the database forever.
    Here everything lives in one DB, so the reaper enforces the same
    contract: terminal tasks are kept, expired in-flight ones (and their
    queued jobs) are deleted. Task data directories are left on disk,
    as in the reference.
    """
    conn = db.get_conn(db_path)
    now = time.time()
    rows = conn.execute(
        "SELECT task_id FROM tasks WHERE expires_at IS NOT NULL "
        "AND expires_at < ? AND status NOT IN (?, ?)",
        (now, "completed", "failed")).fetchall()
    for row in rows:
        task_id = row["task_id"]
        conn.execute("DELETE FROM jobs WHERE task_id=?", (task_id,))
        conn.execute("DELETE FROM tasks WHERE task_id=?", (task_id,))
        log.info("Expired in-flight task %s purged (TTL)", task_id)
    if rows:
        conn.commit()
    return len(rows)


def work_once(queue: str, db_path: Optional[str] = None,
              isolate: bool = False) -> bool:
    """Claim + run one job; returns True if a job was processed.

    ``isolate`` runs the job in a killable child process with the queue's
    timeout enforced (production worker behavior); the in-process path is
    for tests/CLI draining.
    """
    job = claim_next(queue, db_path)
    if job is None:
        return False
    if isolate:
        run_job_isolated(job, db_path)
    else:
        run_job(job, db_path)
    return True


def drain(queues=ALL_QUEUES, db_path: Optional[str] = None,
          max_jobs: int = 1000) -> int:
    """Run jobs until all queues are empty (synchronous test/CLI helper).

    Stage handlers enqueue follow-up jobs, so loop until a full pass over
    every queue finds nothing.
    """
    done = 0
    while done < max_jobs:
        progressed = False
        for q in queues:
            while work_once(q, db_path):
                done += 1
                progressed = True
        if not progressed:
            break
    return done


def worker_loop(queue: str, db_path: Optional[str] = None,
                poll_interval: float = 1.0, stop_event=None) -> None:
    """Blocking worker: the process body of an ``rq worker <queue>``."""
    log.info("Worker started for queue %s", queue)
    last_reap = 0.0
    parent = os.getppid()
    while stop_event is None or not stop_event.is_set():
        if os.getppid() != parent:
            # Non-daemonic worker orphaned by a crashed parent: exit instead
            # of lingering (we can't be daemonic — jobs run in child procs).
            log.info("Parent gone; worker for %s exiting", queue)
            return
        if time.monotonic() - last_reap > 60:
            try:
                reap_timeouts(db_path)
            except Exception as e:  # reaping must never kill the worker
                log.warning("timeout reap failed: %s", e)
            last_reap = time.monotonic()
        try:
            worked = work_once(queue, db_path, isolate=True)
        except Exception as e:
            # A transient failure (sqlite 'database is locked' beyond the
            # busy timeout, etc.) must not kill the queue's only worker —
            # nothing restarts it and the queue would wedge forever.
            log.exception("work_once failed on %s: %s", queue, e)
            worked = False
        if not worked:
            time.sleep(poll_interval)


def _worker_main(queue: str, db_path: Optional[str]) -> None:
    db.reset_local_conns()

    def on_sigterm(signum, frame):
        # stop_workers terminates the worker while it blocks in the job
        # child's join(); kill the child too or it outlives the app.
        _terminate_current_child(db_path)
        os._exit(143)

    signal.signal(signal.SIGTERM, on_sigterm)
    worker_loop(queue, db_path)


def start_workers(queues=ALL_QUEUES, db_path: Optional[str] = None
                  ) -> List[multiprocessing.Process]:
    """Spawn one worker process per queue (docker-compose analogue).

    Workers are non-daemonic because each job runs in its own child process
    (daemonic processes may not have children); the app terminates them on
    shutdown.
    """
    procs = []
    for q in queues:
        p = _mp.Process(target=_worker_main, args=(q, db_path),
                        name=f"worker-{q}")
        p.start()
        procs.append(p)
    return procs


def stop_workers(procs: List[multiprocessing.Process]) -> None:
    """Terminate worker processes (app shutdown hook)."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10.0)
        if p.is_alive():
            p.kill()
            p.join()


def get_queues_status(db_path: Optional[str] = None) -> Dict[str, Dict]:
    """Per-queue job counts (reference jobs.py:357)."""
    conn = db.get_conn(db_path)
    out: Dict[str, Dict] = {}
    for q in ALL_QUEUES:
        counts = {}
        for status in (JobStatus.QUEUED, JobStatus.STARTED,
                       JobStatus.FINISHED, JobStatus.FAILED,
                       JobStatus.TIMED_OUT):
            (n,) = conn.execute(
                "SELECT COUNT(*) FROM jobs WHERE queue=? AND status=?",
                (q, status)).fetchone()
            counts[status] = n
        out[q] = counts
    return out


def list_jobs(queue_name: Optional[str] = None, status: Optional[str] = None,
              limit: int = 100, db_path: Optional[str] = None) -> List[Dict]:
    """Recent jobs, newest first (rq-dashboard's job listing equivalent)."""
    conn = db.get_conn(db_path)
    clauses, params = [], []
    if queue_name:
        clauses.append("queue=?")
        params.append(queue_name)
    if status:
        clauses.append("status=?")
        params.append(status)
    where = f"WHERE {' AND '.join(clauses)}" if clauses else ""
    rows = conn.execute(
        f"SELECT * FROM jobs {where} ORDER BY enqueued_at DESC LIMIT ?",
        (*params, limit)).fetchall()
    out = []
    for row in rows:
        job = dict(row)
        job["args"] = json.loads(job["args"])
        out.append(job)
    return out


def get_job(job_id: str, db_path: Optional[str] = None) -> Optional[Dict]:
    row = db.get_conn(db_path).execute(
        "SELECT * FROM jobs WHERE job_id=?", (job_id,)).fetchone()
    if row is None:
        return None
    job = dict(row)
    job["args"] = json.loads(job["args"])
    return job
