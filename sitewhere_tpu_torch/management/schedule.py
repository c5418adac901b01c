"""Schedule management: cron- and interval-triggered jobs (port of
``sitewhere_tpu/management/schedule.py``, host only).

An asyncio scheduler over CRUD-backed schedules with a dependency-free
5-field cron parser; "simple" triggers carry an interval and a repeat
count. Job types: a command invocation and a batch command by device
criteria.
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime
import time
from typing import Any, Callable

from sitewhere_tpu_torch.management.entities import EntityMeta, EntityStore

# --- cron ---------------------------------------------------------------


def _parse_field(spec: str, lo: int, hi: int) -> set[int]:
    out: set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            lo2, hi2 = int(a), int(b)
        else:
            lo2 = hi2 = int(part)
        if not (lo <= lo2 <= hi and lo <= hi2 <= hi):
            raise ValueError(f"cron field {spec!r} out of range [{lo},{hi}]")
        out.update(range(lo2, hi2 + 1, step))
    return out


@dataclasses.dataclass(frozen=True)
class CronExpression:
    """Standard 5-field cron: minute hour day-of-month month day-of-week."""

    minutes: frozenset[int]
    hours: frozenset[int]
    days: frozenset[int]
    months: frozenset[int]
    weekdays: frozenset[int]  # 0=Monday (python convention)

    @staticmethod
    def parse(expr: str) -> "CronExpression":
        fields = expr.split()
        if len(fields) != 5:
            raise ValueError(f"cron expression needs 5 fields: {expr!r}")
        mi, h, dom, mo, dow = fields
        return CronExpression(
            minutes=frozenset(_parse_field(mi, 0, 59)),
            hours=frozenset(_parse_field(h, 0, 23)),
            days=frozenset(_parse_field(dom, 1, 31)),
            months=frozenset(_parse_field(mo, 1, 12)),
            # cron dow: 0(or 7)=Sunday..6=Saturday; python weekday(): 0=Monday
            weekdays=frozenset(
                (v - 1) % 7 for v in _parse_field(dow.replace("7", "0"), 0, 6)
            ) if dow != "*" else frozenset(range(7)),
        )

    def matches(self, dt: datetime.datetime) -> bool:
        return (
            dt.minute in self.minutes
            and dt.hour in self.hours
            and dt.day in self.days
            and dt.month in self.months
            and dt.weekday() in self.weekdays
        )

    def next_fire(self, after: datetime.datetime) -> datetime.datetime:
        """Next matching minute strictly after ``after`` (bounded scan)."""
        dt = after.replace(second=0, microsecond=0) + datetime.timedelta(minutes=1)
        for _ in range(366 * 24 * 60):
            if self.matches(dt):
                return dt
            dt += datetime.timedelta(minutes=1)
        raise ValueError("cron expression never fires")


# --- schedules ----------------------------------------------------------


@dataclasses.dataclass
class Schedule:
    meta: EntityMeta
    name: str
    trigger_type: str                 # "Cron" | "Simple"
    cron: str | None = None
    interval_s: float | None = None
    repeat_count: int = -1            # -1 = forever
    start_ms: float | None = None
    end_ms: float | None = None


@dataclasses.dataclass
class ScheduledJob:
    meta: EntityMeta
    schedule_token: str
    job_type: str                     # "CommandInvocation" | "BatchCommandByCriteria"
    configuration: dict[str, Any]
    fired_count: int = 0
    last_fired_ms: float | None = None
    last_error: str | None = None


class ScheduleManager:
    """Schedule + job CRUD with an asyncio firing loop."""

    def __init__(self):
        self.schedules: EntityStore[Schedule] = EntityStore("schedule")
        self.jobs: EntityStore[ScheduledJob] = EntityStore("scheduled-job")
        self.executors: dict[str, Callable] = {}
        self._task: asyncio.Task | None = None
        self.tick_s = 1.0
        # cluster fire policy: with replicated schedules on every rank,
        # exactly ONE rank may run each schedule's jobs (the replicator
        # installs an owner-rank predicate; None = fire everything, the
        # single-node behavior). With event-plane replication the
        # predicate is failure-aware: a dead owner's schedules fire at
        # its first live follower (parallel/replication.install_fireover)
        self.fire_filter: Callable[[str], bool] | None = None
        # catch-up policy: when this predicate admits a schedule token,
        # a Cron job also fires when a matching minute passed SINCE its
        # last fire (not just when now is inside one) — the fire-over
        # path uses it so windows missed during failure detection still
        # run exactly once on the follower
        self.catchup_filter: Callable[[str], bool] | None = None
        # post-fire hook (job just updated fired_count/last_fired_ms):
        # the entity replicator ships the job's new state so a recovered
        # owner sees which windows its follower already covered — the
        # no-double-fire half of scheduler fire-over
        self.on_fired: Callable[[ScheduledJob], None] | None = None
        # span tracer: the instance wires the engine's tracer
        # in so every schedule fire records a span (its own fresh trace);
        # None = untraced (direct constructors, tests)
        self.tracer = None

    # CRUD ----------------------------------------------------------------
    def create_schedule(self, token: str, name: str, trigger_type: str,
                        cron: str | None = None, interval_s: float | None = None,
                        repeat_count: int = -1, start_ms: float | None = None,
                        end_ms: float | None = None) -> Schedule:
        if trigger_type == "Cron":
            if not cron:
                raise ValueError("Cron trigger requires a cron expression")
            CronExpression.parse(cron)  # validate
        elif trigger_type == "Simple":
            if not interval_s or interval_s <= 0:
                raise ValueError("Simple trigger requires a positive interval")
        else:
            raise ValueError(f"unknown trigger type {trigger_type!r}")
        return self.schedules.create(
            token,
            lambda m: Schedule(meta=m, name=name, trigger_type=trigger_type,
                               cron=cron, interval_s=interval_s,
                               repeat_count=repeat_count, start_ms=start_ms,
                               end_ms=end_ms),
        )

    def create_job(self, token: str, schedule_token: str, job_type: str,
                   configuration: dict[str, Any]) -> ScheduledJob:
        self.schedules.get(schedule_token)  # must exist
        if job_type not in self.executors:
            raise ValueError(f"no executor registered for job type {job_type!r}")
        return self.jobs.create(
            token,
            lambda m: ScheduledJob(meta=m, schedule_token=schedule_token,
                                   job_type=job_type, configuration=configuration),
        )

    def register_executor(self, job_type: str, fn: Callable) -> None:
        """fn(job: ScheduledJob) -> awaitable or None."""
        self.executors[job_type] = fn

    # firing --------------------------------------------------------------
    def _due(self, sched: Schedule, job: ScheduledJob, now_ms: float) -> bool:
        if sched.start_ms is not None and now_ms < sched.start_ms:
            return False
        if sched.end_ms is not None and now_ms > sched.end_ms:
            return False
        if sched.trigger_type == "Simple":
            if 0 <= sched.repeat_count < job.fired_count:
                return False
            last = job.last_fired_ms if job.last_fired_ms is not None else -1e18
            return now_ms - last >= sched.interval_s * 1000
        # Cron: fire when entering a matching minute
        expr = CronExpression.parse(sched.cron)
        dt = datetime.datetime.fromtimestamp(now_ms / 1000)
        last = job.last_fired_ms
        if expr.matches(dt):
            return last is None or (now_ms - last) >= 60_000
        if (last is not None and self.catchup_filter is not None
                and self.catchup_filter(job.schedule_token)):
            # missed-window catch-up: a matching minute elapsed between
            # the last fire and now (e.g. while the owner was dead and
            # detection ran) — fire once, late, rather than never
            try:
                nxt = expr.next_fire(
                    datetime.datetime.fromtimestamp(last / 1000))
            except ValueError:
                return False
            return nxt.timestamp() * 1000 <= now_ms
        return False

    async def fire_due(self, now_ms: float | None = None) -> int:
        """Fire all due jobs once; returns count fired. Exposed separately
        from the loop so tests and embedded hosts can drive time."""
        now_ms = now_ms if now_ms is not None else time.time() * 1000
        fired = 0
        for job in self.jobs.all():
            sched = self.schedules.try_get(job.schedule_token)
            if sched is None:
                continue
            if (self.fire_filter is not None
                    and not self.fire_filter(job.schedule_token)):
                continue   # another rank owns this schedule's firing
            if not self._due(sched, job, now_ms):
                continue
            job.fired_count += 1
            job.last_fired_ms = now_ms
            sp = (self.tracer.begin("schedule.fire", job=job.meta.token,
                                    jobType=job.job_type)
                  if self.tracer is not None else None)
            try:
                res = self.executors[job.job_type](job)
                if asyncio.iscoroutine(res):
                    await res
                job.last_error = None
            except Exception as e:
                job.last_error = str(e)
            finally:
                if sp is not None:
                    if job.last_error:
                        sp.annotate(error=job.last_error)
                    sp.end()
            if self.on_fired is not None:
                try:
                    self.on_fired(job)
                except Exception:
                    pass   # replication of fired state is best-effort
            fired += 1
        return fired

    async def _loop(self) -> None:
        while True:
            await self.fire_due()
            await asyncio.sleep(self.tick_s)

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


def command_invocation_executor(command_service):
    """Executor for CommandInvocation jobs (reference:
    schedule/jobs/CommandInvocationJob.java): config carries deviceToken,
    commandToken, parameterValues."""

    async def execute(job: ScheduledJob) -> None:
        cfg = job.configuration
        command_service.invoke(
            cfg["deviceToken"], cfg["commandToken"],
            cfg.get("parameterValues", {}),
            initiator="Scheduler", initiator_id=job.meta.token,
        )
        await command_service.pump()

    return execute


def batch_command_by_criteria_executor(device_management, batch_manager):
    """Executor for InvocationByDeviceCriteriaJob (reference:
    schedule/jobs/InvocationByDeviceCriteriaJob.java): select devices by
    device type, then run a batch command invocation."""

    async def execute(job: ScheduledJob) -> None:
        cfg = job.configuration
        devices = [
            s.token
            for s in device_management.list_devices(
                page_size=1_000_000, device_type=cfg["deviceTypeToken"]
            ).results
        ]
        if not devices:
            return
        token = f"{job.meta.token}-{job.fired_count}"
        batch_manager.create_operation(
            token, "InvokeCommand", devices,
            {"commandToken": cfg["commandToken"],
             "parameterValues": cfg.get("parameterValues", {})},
        )
        await batch_manager.process_operation(token)

    return execute
