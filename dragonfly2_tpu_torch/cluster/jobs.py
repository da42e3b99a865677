"""Async jobs: preheat fan-out and peer listing.

Port of dragonfly2_tpu/cluster/jobs.py, whole: the same task ids and job states for the same
scheduler replies.

Capability parity with the machinery(Redis)-backed job layer: manager-side
CreatePreheat resolves content into tasks and fans group jobs out to
scheduler queues (manager/job/preheat.go:73-286); scheduler-side workers
consume `preheat` (seed-peer TriggerDownloadTask, scheduler/job/job.go:152)
and `sync_peers` (:224). Here the queue is in-proc (the gRPC/Redis edge can
wrap it); preheat enqueues a seed-download trigger (TriggerSeedRequest)
on the scheduler the hash ring assigns, which the RPC edge pushes to the
seed daemon's announce connection — the ObtainSeeds path, with the task
id derived exactly as the daemons derive it (idgen.task_id_v1).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import time
import uuid
from typing import TYPE_CHECKING

from dragonfly2_tpu_torch.cluster import image_preheat
from dragonfly2_tpu_torch.cluster import messages as msg
from dragonfly2_tpu_torch.rpc import resilience
from dragonfly2_tpu_torch.utils import dferrors, idgen
from dragonfly2_tpu_torch.utils.hashring import HashRing

if TYPE_CHECKING:  # the manager's process loads no torch for a type hint
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService


class JobState(str, enum.Enum):
    PENDING = "PENDING"
    SUCCESS = "SUCCESS"
    FAILURE = "FAILURE"
    # A task this job fanned out was observed alive earlier but is now
    # unknown to its scheduler (TTL GC, restart) without a latched terminal
    # outcome — the job's result is indeterminate, not forever-PENDING
    # (GC + an unpolled job used to pin PENDING permanently).
    EXPIRED = "EXPIRED"


@dataclasses.dataclass
class PreheatRequest:
    urls: list[str]
    tag: str = ""
    application: str = ""
    piece_length: int = 4 << 20
    filtered_query_params: list[str] | None = None
    # "file" fans the raw URLs out as-is; "image" resolves each URL as an
    # OCI image reference (registry manifest walk -> config+layer blob
    # URLs, manager/job/preheat.go:90-168) and preheats every blob. An
    # empty type sniffs: URLs matching .../v2/<repo>/manifests/<tag> are
    # treated as images.
    preheat_type: str = ""
    username: str = ""
    password: str = ""
    platform: str = ""
    headers: dict | None = None


@dataclasses.dataclass
class JobResult:
    job_id: str
    state: JobState
    task_ids: list[str]
    detail: dict = dataclasses.field(default_factory=dict)
    # monotonic enqueue (or adoption) time: bounds how long a preheat may
    # sit with NO task ever observed before it expires — the seed-trigger
    # delivery TTL is 60s, so a job whose tasks never appeared by then is
    # undeliverable (no seed daemon exists), not merely late
    created_at: float = dataclasses.field(default_factory=time.monotonic)


# How long a preheat may sit with no task ever observed before it is
# declared undeliverable — longer than the RPC drain's 60s trigger TTL
# (rpc/server.SEED_TRIGGER_TTL_S) so a late-but-delivered seed still wins.
SEED_START_TTL_S = 90.0


class RemoteScheduler:
    """The JobManager-facing surface of a scheduler in ANOTHER process,
    over the wire RPC job edge (rpc/server.py JobTriggerSeed/TaskStates/
    SchedulerInfo) — the role the reference's Redis-backed machinery bus
    plays between manager and scheduler processes (internal/job/
    job.go:53-87). Degrades per-call: an unreachable scheduler fails THIS
    trigger/poll, not the manager."""

    # Every job-edge op runs under a deadline scope (rpc/resilience.py):
    # the frame carries the remaining budget, so a scheduler that digs a
    # stale trigger/poll out of a backlog SHEDS it instead of doing work
    # the manager's REST thread stopped waiting for. One budget covers
    # dial + call.
    OP_BUDGET_S = 10.0

    def __init__(self, host: str, port: int, ssl_context=None):
        from dragonfly2_tpu_torch.rpc.client import SyncSchedulerClient

        self.address = (host, port)
        self._client = SyncSchedulerClient(host, port, ssl_context=ssl_context)

    def trigger_seed_download(self, task_id, url, piece_length=4 << 20,
                              tag="", application="", host_id="",
                              headers=None) -> bool:
        try:
            with resilience.deadline(self.OP_BUDGET_S):
                resp = self._client.call(msg.JobTriggerSeedRequest(
                    task_id=task_id, url=url, piece_length=piece_length,
                    tag=tag, application=application, host_id=host_id,
                    headers=headers or {},
                ))
        except (ConnectionError, dferrors.DeadlineExceeded):
            return False
        return isinstance(resp, msg.JobTriggerSeedResponse) and resp.ok

    def task_states(self, task_ids: list[str]) -> list[int | None]:
        """None means 'this scheduler does not know the task' — a REAL
        answer. Transport failure RAISES ConnectionError instead: mapping
        it to None would read as 'scheduler forgot the task' and flip a
        healthy in-flight job to EXPIRED during a restart window."""
        with resilience.deadline(self.OP_BUDGET_S):
            resp = self._client.call(msg.TaskStatesRequest(task_ids=task_ids))
        if not isinstance(resp, msg.TaskStatesResponse):
            raise ConnectionError(f"bad TaskStates reply from {self.address}")
        return [None if s < 0 else s for s in resp.states]

    def info(self) -> tuple[dict, list]:
        """(counts, hosts) in ONE round trip — the response carries both.
        Raises ConnectionError when the scheduler is unreachable so
        callers can surface the failure instead of reporting a healthy
        empty scheduler."""
        with resilience.deadline(self.OP_BUDGET_S):
            resp = self._client.call(msg.SchedulerInfoRequest())
        if not isinstance(resp, msg.SchedulerInfoResponse):
            raise ConnectionError(f"bad SchedulerInfo reply from {self.address}")
        return resp.counts, resp.hosts

    def counts(self) -> dict:
        return self.info()[0]

    def list_hosts(self) -> list[dict]:
        return self.info()[1]

    def flight_recorder(self, last_n: int = 64) -> dict:
        """The remote scheduler's flight-recorder dump (last-N tick phase
        breakdowns + jit compile counters + open spans). Raises
        ConnectionError when unreachable so the manager surfaces the
        failure instead of an empty-but-healthy-looking dump."""
        with resilience.deadline(self.OP_BUDGET_S):
            resp = self._client.call(msg.FlightRecorderRequest(last_n=last_n))
        if not isinstance(resp, msg.FlightRecorderResponse):
            raise ConnectionError(f"bad FlightRecorder reply from {self.address}")
        return resp.dump

    def close(self) -> None:
        self._client.close()


class JobManager:
    """Routes jobs to schedulers by task-id consistent hashing — the same
    affinity the reference gets from pkg/balancer. Entries may be local
    SchedulerService objects (in-proc clusters, tests) or RemoteScheduler
    proxies (the launched manager's cross-process job edge)."""

    def __init__(self, schedulers: dict[str, SchedulerService],
                 seed_hosts: list[msg.HostInfo] | None = None):
        self.schedulers = schedulers
        self.ring = HashRing(list(schedulers))
        # Optional: with no explicit seed hosts, triggers go out with an
        # empty host_id and each SCHEDULER round-robins its own announced
        # seed hosts (SchedulerService.trigger_seed_download) — the
        # launched manager does not track per-scheduler seed daemons.
        self.seed_hosts = [h for h in (seed_hosts or [])]
        self._seed_rr = itertools.cycle(range(max(len(self.seed_hosts), 1)))
        self.jobs: dict[str, JobResult] = {}
        # per-job (task_done, task_seen) poll latches — PRIVATE bookkeeping,
        # deliberately not in JobResult.detail (the manager serializes
        # detail into the REST payload and DB record; these maps grow with
        # task count and are implementation state, not job output)
        self._latches: dict[str, tuple[dict, dict]] = {}

    def update_schedulers(self, schedulers: dict[str, SchedulerService]) -> None:
        """Swap the scheduler set (the launched manager refreshes it from
        its DB registrations before each job operation; schedulers come
        and go at runtime). Existing entries are kept by NAME so cached
        remote connections survive a no-op refresh."""
        merged = {
            name: self.schedulers.get(name, sched)
            for name, sched in schedulers.items()
        }
        for name, old in self.schedulers.items():
            if name not in merged and isinstance(old, RemoteScheduler):
                old.close()
        self.schedulers = merged
        self.ring = HashRing(list(merged))

    def adopt(self, job_id: str, task_ids: list[str]) -> JobResult:
        """Re-register a job known only from a durable record (the manager
        restarted; in-proc job state is documented non-durable). State
        recomputes from live task polling on the next get()."""
        result = self.jobs.get(job_id)
        if result is None:
            result = JobResult(job_id, JobState.PENDING, list(task_ids), {})
            self.jobs[job_id] = result
        return result

    def create_preheat(self, req: PreheatRequest) -> JobResult:
        """Resolve urls -> task ids and enqueue a TriggerSeedRequest per
        task on the owning scheduler, to be pushed to the chosen seed
        daemon's announce connection (preheat.go:90-286 + scheduler
        job.go:152-221). No peer is registered here — a peer registered
        on the seed's behalf would have no connection to receive
        responses, so nothing would download."""
        job_id = str(uuid.uuid4())
        task_ids = []
        failures = {}
        # Resolve the work list first: file preheats are the raw URLs;
        # image preheats walk the registry manifest into blob URLs
        # (preheat.go:99-117 CreatePreheat type dispatch).
        files: list[tuple[str, dict | None]] = []  # (url, headers)
        for url in req.urls:
            as_image = req.preheat_type == "image" or (
                not req.preheat_type and image_preheat.is_image_url(url)
            )
            if not as_image:
                files.append((url, req.headers))
                continue
            try:
                layers = image_preheat.resolve_image_layers(
                    url,
                    username=req.username,
                    password=req.password,
                    platform=req.platform,
                    headers=req.headers,
                )
            except Exception as e:  # noqa: BLE001 - fail THIS url, not the job run
                failures[url] = f"image resolve failed: {e}"
                continue
            files.extend((layer.url, layer.headers) for layer in layers)
        for url, headers in files:
            # v1 derivation, matching the daemons' dfget path
            # (client/daemon.py download -> idgen.task_id_v1): a preheat
            # that hashes differently from the peers seeds a task nobody
            # ever asks for.
            task_id = idgen.task_id_v1(
                url,
                tag=req.tag,
                application=req.application,
                filtered_query_params=idgen.FILTERED_QUERY_PARAMS_SEPARATOR.join(
                    req.filtered_query_params or []
                ),
            )
            task_ids.append(task_id)
            scheduler_name = self.ring.pick(task_id)
            if scheduler_name is None:
                failures[task_id] = "no scheduler"
                continue
            # explicit seed list -> manager round-robin; empty -> each
            # scheduler picks among ITS announced seed daemons
            seed_host_id = ""
            if self.seed_hosts:
                seed = self.seed_hosts[next(self._seed_rr) % len(self.seed_hosts)]
                seed_host_id = seed.host_id
            # .get, not []: a concurrent update_schedulers (manager REST
            # threads) can swap the map between the ring pick and this
            # lookup — a departed scheduler fails THIS task, not the job run
            scheduler = self.schedulers.get(scheduler_name)
            if scheduler is None:
                failures[task_id] = f"scheduler {scheduler_name} departed"
                continue
            # TriggerDownloadTask to the seed daemon (preheat.go:90-286 ->
            # scheduler job.go:152 -> seed ObtainSeeds) — NOT a proxy peer
            # registration: a peer registered on the seed's behalf has no
            # connection to receive responses, so nothing would download.
            ok = scheduler.trigger_seed_download(
                task_id=task_id,
                url=url,
                piece_length=req.piece_length,
                tag=req.tag,
                application=req.application,
                host_id=seed_host_id,
                headers=headers,
            )
            if not ok:
                failures[task_id] = "seed trigger rejected (queue full, no seed hosts, or scheduler unreachable)"
        # Enqueueing triggers is not a warm cluster: the job stays PENDING
        # until `get()` observes every task SUCCEEDED on its scheduler
        # (machinery group semantics — the reference's preheat e2e polls
        # the job state until the layers actually landed). No work at all
        # (empty urls) is an immediately-successful no-op, not a job that
        # pends forever.
        if failures:
            state = JobState.FAILURE
        elif not task_ids:
            state = JobState.SUCCESS
        else:
            state = JobState.PENDING
        result = JobResult(job_id, state, task_ids, {"failures": failures})
        self.jobs[job_id] = result
        return result

    def sync_peers(self) -> dict[str, dict]:
        """Per-scheduler entity counts plus each scheduler's announced-host
        list (scheduler/job/job.go:224 responds with its peers). The
        MANAGER layer merges `announced_hosts` into its peers table
        (manager/service.py create_job — it owns the database and the
        upsert idiom); this stays a pure data collection."""
        out = {}
        for name, s in self.schedulers.items():
            try:
                if isinstance(s, RemoteScheduler):
                    counts, hosts = s.info()  # one round trip, not two
                else:
                    counts, hosts = s.counts(), s.list_hosts()
            except ConnectionError as e:
                # an unreachable scheduler must not masquerade as a
                # healthy EMPTY one — the peer-table merge and operators
                # need to tell the two apart
                out[name] = {"unreachable": str(e), "announced_hosts": []}
                continue
            out[name] = {**counts, "announced_hosts": hosts}
        return out

    def get(self, job_id: str) -> JobResult | None:
        """Job state recomputed from LIVE task progress: a preheat is
        PENDING until every fanned-out task has actually completed on its
        owning scheduler (the reference's machinery group state the e2e
        preheat tests poll, internal/job group states + test/e2e/manager/
        preheat.go) — enqueue-time SUCCESS would claim a warm cluster
        before any seed finished downloading."""
        result = self.jobs.get(job_id)
        # Only ENQUEUE-TIME failures are terminal; a FAILED observed from
        # task polling must keep recomputing — a retried seed download can
        # recover the task (FSM allows FAILED -> SUCCEEDED), and latching
        # would make the job outcome depend on poll timing. SUCCESS *is*
        # terminal: once every task was observed SUCCEEDED the layers
        # landed, and a scheduler later forgetting the task (restart,
        # capacity eviction, TTL GC) must not regress a completed job
        # back to PENDING.
        if result is None or result.detail.get("failures") or not result.task_ids:
            return result
        if result.state == JobState.SUCCESS:
            return result
        from dragonfly2_tpu_torch.state.fsm import TaskState

        # Per-task terminal SUCCEEDED outcomes latch across polls: task
        # TTL GC (or a scheduler restart) forgetting a completed task must
        # not regress it — without the latch a job whose tasks all
        # succeeded between polls would report PENDING forever once the
        # sweep reclaimed them. A task observed alive earlier
        # but now unknown WITHOUT a latched outcome is indeterminate and
        # expires the job.
        done, seen = self._latches.setdefault(result.job_id, ({}, {}))
        # One batched TaskStates call per owning scheduler (the wire
        # message takes a list): per-task round trips made a 50-URL poll
        # pay 50 dials — minutes against a briefly-down scheduler.
        by_owner: dict[str, list[str]] = {}
        to_poll = [t for t in result.task_ids if not done.get(t)]
        for task_id in to_poll:
            name = self.ring.pick(task_id)
            if name is not None:
                by_owner.setdefault(name, []).append(task_id)
        polled: dict[str, int | None] = {}
        unreachable = False
        for task_id in to_poll:
            if self.ring.pick(task_id) is None:
                # no owner at all (empty ring): the task is gone-for-good
                # as far as this manager can tell — same semantics as a
                # reachable scheduler answering "unknown task"
                polled[task_id] = None
        for name, tids in by_owner.items():
            svc = self.schedulers.get(name)
            if svc is None:
                # owner departed between the ring pick and the lookup:
                # permanently-unknown, NOT a transient transport failure —
                # holding position forever would leave the job PENDING
                # after a decommission
                for tid in tids:
                    polled[tid] = None
                continue
            try:
                # Locked snapshot: this runs on manager REST threads while
                # the scheduler event loop mutates task state.
                for tid, raw in zip(tids, svc.task_states(tids)):
                    polled[tid] = raw
            except ConnectionError:
                # transport failure is NOT "scheduler forgot the task":
                # skip these tasks this round (last observations stand)
                # rather than expiring a healthy in-flight job
                unreachable = True
        states = []
        expired = False
        for task_id in result.task_ids:
            if done.get(task_id):
                states.append(TaskState.SUCCEEDED)
                continue
            raw = polled.get(task_id)
            if task_id not in polled:
                # unreachable scheduler (or no owner): hold position
                states.append(TaskState(seen[task_id])
                              if seen.get(task_id) is not None
                              else TaskState.PENDING)
            elif raw is None:
                if seen.get(task_id) == int(TaskState.FAILED):
                    # last observation before the task vanished was FAILED
                    # and no recovery was ever seen: the observation
                    # stands — a known-failed job must not drift to
                    # EXPIRED/PENDING just because GC reclaimed the task
                    states.append(TaskState.FAILED)
                elif seen.get(task_id) is not None:
                    expired = True
                    states.append(TaskState.PENDING)
                else:
                    states.append(TaskState.PENDING)  # seed not started yet
            else:
                state = TaskState(raw)
                seen[task_id] = int(state)
                if state == TaskState.SUCCEEDED:
                    done[task_id] = True
                states.append(state)
        # PER-TASK undelivered check: any task that NEVER appeared on a
        # reachable scheduler past the trigger-delivery TTL is
        # undeliverable (its trigger was dropped after SEED_TRIGGER_TTL_S
        # with only a log line) — a job-global flag would let one
        # delivered task mask a dropped sibling and pend the job forever.
        undelivered = [
            t for t in result.task_ids
            if not done.get(t) and seen.get(t) is None
        ]
        if (undelivered and not unreachable
                and time.monotonic() - result.created_at > SEED_START_TTL_S):
            result.state = JobState.EXPIRED
            result.detail["expired_reason"] = (
                f"{len(undelivered)} task(s) never picked up by any seed "
                "daemon within the delivery TTL"
            )
            result.detail["undelivered_task_ids"] = undelivered[:20]
            return result
        if any(s == TaskState.FAILED for s in states):
            result.state = JobState.FAILURE
            result.detail["task_states"] = [s.name for s in states]
        elif all(s == TaskState.SUCCEEDED for s in states):
            result.state = JobState.SUCCESS
            # SUCCESS is the one truly terminal outcome (the early return
            # above never recomputes it), so its latch bookkeeping is dead
            # weight from here on — without this pop the per-task maps
            # grow for every job over the manager's lifetime.
            # FAILURE/EXPIRED keep their latches: both keep
            # recomputing because a retried seed can still recover.
            self._latches.pop(result.job_id, None)
        elif expired:
            result.state = JobState.EXPIRED
            result.detail["task_states"] = [s.name for s in states]
        else:
            result.state = JobState.PENDING
        return result
