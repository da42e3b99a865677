"""Port of dragonfly2_tpu/telemetry/series.py: the metric families the
scheduler and trainer services export (the scheduler's, the trainer's,
the decision ledger's, the SLO engine's, the rpc breakers', the device
entry counters', the ml arm's activation gate's, the dfdaemon's, the
tail plane's, the manager's, the cost cards' and the soak timelines'),
the traffic label values and the version gauge. The megascale, fleet and
process families come with the scale labs (ROADMAP A11).

Capability parity with scheduler/metrics/metrics.go:44-454 (per-RPC
totals + failure twins, `traffic` by type/task_type/task_tag/task_app/
host_type, `host_traffic`, download duration histogram, concurrent
schedule gauge). Each `*_series` function is idempotent on a registry
(Registry.register returns the existing collector), so servers and tests
can call them freely.
"""

from __future__ import annotations

from dragonfly2_tpu_torch import version as _version

# traffic type label values (scheduler/metrics/metrics.go:24-38)
TRAFFIC_P2P = "p2p"
TRAFFIC_BACK_TO_SOURCE = "back_to_source"
HOST_TRAFFIC_UPLOAD = "upload"
HOST_TRAFFIC_DOWNLOAD = "download"


class _Namespace:
    def __init__(self, **metrics):
        self.__dict__.update(metrics)


def scheduler_series(reg) -> _Namespace:
    c = reg.counter
    return _Namespace(
        announce_peer=c(
            "dragonfly_scheduler_announce_peer_total", "stream messages", ("type",)
        ),
        announce_peer_failure=c(
            "dragonfly_scheduler_announce_peer_failure_total",
            "failed stream messages",
            ("type",),
        ),
        register_peer=c(
            "dragonfly_scheduler_register_peer_total", "peer registrations",
            ("priority", "task_type", "task_tag", "task_app"),
        ),
        register_peer_failure=c(
            "dragonfly_scheduler_register_peer_failure_total",
            "failed peer registrations",
            ("priority", "task_type", "task_tag", "task_app"),
        ),
        download_peer_started=c(
            "dragonfly_scheduler_download_peer_started_total", "downloads started",
            ("priority", "task_type", "task_tag", "task_app"),
        ),
        download_peer_back_to_source_started=c(
            "dragonfly_scheduler_download_peer_back_to_source_started_total",
            "back-to-source downloads started",
            ("priority", "task_type", "task_tag", "task_app"),
        ),
        download_peer_finished=c(
            "dragonfly_scheduler_download_peer_finished_total", "downloads finished",
            ("priority", "task_type", "task_tag", "task_app"),
        ),
        download_peer_finished_failure=c(
            "dragonfly_scheduler_download_peer_finished_failure_total",
            "downloads failed",
            ("priority", "task_type", "task_tag", "task_app"),
        ),
        download_piece_finished=c(
            "dragonfly_scheduler_download_piece_finished_total", "pieces finished",
            ("traffic_type", "task_type", "task_tag", "task_app"),
        ),
        download_piece_finished_failure=c(
            "dragonfly_scheduler_download_piece_finished_failure_total",
            "pieces failed",
            ("traffic_type", "task_type", "task_tag", "task_app"),
        ),
        stat_peer=c("dragonfly_scheduler_stat_peer_total", "StatPeer calls"),
        leave_peer=c("dragonfly_scheduler_leave_peer_total", "LeavePeer calls"),
        stat_task=c("dragonfly_scheduler_stat_task_total", "StatTask calls"),
        announce_host=c("dragonfly_scheduler_announce_host_total", "AnnounceHost calls"),
        leave_host=c("dragonfly_scheduler_leave_host_total", "LeaveHost calls"),
        sync_probes=c("dragonfly_scheduler_sync_probes_total", "SyncProbes calls"),
        traffic=c(
            "dragonfly_scheduler_traffic", "piece bytes moved",
            ("type", "task_type", "task_tag", "task_app", "host_type"),
        ),
        host_traffic=c(
            "dragonfly_scheduler_host_traffic", "piece bytes by host",
            ("type", "host_type", "host_id"),
        ),
        download_peer_duration=reg.histogram(
            "dragonfly_scheduler_download_peer_duration_milliseconds",
            "download duration by size scope",
            ("size_scope",),
            buckets=(100.0, 200.0, 500.0, 1000.0, 1500.0, 2000.0, 3000.0, 5000.0,
                     10000.0, 20000.0, 60000.0, 120000.0, 300000.0),
        ),
        concurrent_schedule=reg.gauge(
            "dragonfly_scheduler_concurrent_schedule_total", "peers pending schedule"
        ),
        schedule_tick=reg.histogram(
            "dragonfly_scheduler_tick_seconds", "batched schedule tick latency"
        ),
        schedule_batch=reg.histogram(
            "dragonfly_scheduler_tick_batch_size", "peers per tick",
            buckets=(1, 8, 64, 512, 4096),
        ),
        # host-vs-device attribution of the tick (the breakdown the loop
        # bench publishes — VERDICT r3 weak #5 — live for operators too)
        schedule_phase=reg.histogram(
            "dragonfly_scheduler_tick_phase_seconds",
            "per-phase tick wall time", ("phase",),
            buckets=(.0005, .002, .01, .05, .2, 1, 5),
        ),
        # trust-boundary integrity: corrupt-parent quarantine
        # (cluster/quarantine.py QuarantineBoard)
        quarantine_total=c(
            "dragonfly_scheduler_quarantine_total",
            "hosts quarantined after integrity failures", ("reason",),
        ),
        quarantine_released=c(
            "dragonfly_scheduler_quarantine_released_total",
            "quarantined hosts released after their penalty decayed",
        ),
        quarantine_active=reg.gauge(
            "dragonfly_scheduler_quarantine_active",
            "hosts currently excluded from candidate scheduling",
        ),
        quarantine_skipped=c(
            "dragonfly_scheduler_quarantine_skipped_candidates_total",
            "candidate slots skipped because their host is quarantined",
        ),
        piece_corruption=c(
            "dragonfly_scheduler_piece_corruption_total",
            "piece failures attributed to digest-verified corruption",
        ),
    )


def decision_series(reg) -> _Namespace:
    """Decision provenance ledger families (telemetry/decisions.py):
    per-arm applied-selection counts, joined outcomes, counterfactual
    shadow-scoring divergence (top-1 disagreement, rank correlation),
    measured per-arm regret on disagreement decisions, ledger occupancy,
    and the decision→outcome join latency."""
    c = reg.counter
    return _Namespace(
        decisions=c(
            "dragonfly_scheduler_decision_total",
            "applied parent selections recorded in the decision ledger",
            ("arm",),
        ),
        outcomes=c(
            "dragonfly_scheduler_decision_outcome_total",
            "terminal peer events joined to a recorded decision",
            ("outcome",),
        ),
        shadow_scored=c(
            "dragonfly_scheduler_decision_shadow_scored_total",
            "decisions re-scored by the inactive (shadow) arm",
        ),
        top1_disagreement=reg.gauge(
            "dragonfly_scheduler_decision_top1_disagreement",
            "last tick's fraction of decisions where the shadow arm's "
            "top-1 pick differed from the active arm's",
        ),
        rank_corr=reg.gauge(
            "dragonfly_scheduler_decision_rank_correlation",
            "last tick's mean rank correlation between the active arm's "
            "ranked selection and the shadow arm's ranking of the same "
            "candidate set",
        ),
        occupancy=reg.gauge(
            "dragonfly_scheduler_decision_ledger_occupancy",
            "decision-ledger ring slots currently holding a decision",
        ),
        regret=reg.gauge(
            "dragonfly_scheduler_decision_regret_ms",
            "measured regret of the active arm on disagreement decisions "
            "(mean joined-outcome TTC delta, active minus shadow pick's "
            "host; positive = the shadow pick's host did better)",
            ("arm",),
        ),
        join_latency=reg.histogram(
            "dragonfly_scheduler_decision_join_latency_seconds",
            "wall time between a recorded decision and its joined "
            "terminal outcome",
            buckets=(.01, .05, .2, 1.0, 5.0, 30.0, 120.0, 600.0),
        ),
    )


def resilience_series(reg, service: str) -> _Namespace:
    """Failure-domain resilience families (rpc/resilience.py): per-target
    circuit-breaker state/transition/fast-fail series for every dial site,
    and the deadline-budget outcome counters — client calls aborted because
    the propagated budget ran out, and server-side work shed on arrival
    because its deadline had already expired. `service` picks the metric
    namespace, so the daemon's pool, the manager's job edge, and the
    scheduler's trainer uploads each report under their own name."""
    return _Namespace(
        breaker_state=reg.gauge(
            f"dragonfly_{service}_rpc_breaker_state",
            "per-target circuit breaker state (0=closed, 1=half_open, 2=open)",
            ("target",),
        ),
        breaker_transitions=reg.counter(
            f"dragonfly_{service}_rpc_breaker_transitions_total",
            "circuit breaker state transitions", ("target", "to"),
        ),
        breaker_fast_fail=reg.counter(
            f"dragonfly_{service}_rpc_breaker_fast_fail_total",
            "calls short-circuited by an open breaker instead of dialing",
            ("target",),
        ),
        deadline_exceeded=reg.counter(
            f"dragonfly_{service}_rpc_deadline_exceeded_total",
            "client calls aborted because the propagated deadline budget "
            "was exhausted",
        ),
        deadline_shed=reg.counter(
            f"dragonfly_{service}_rpc_deadline_shed_total",
            "requests shed on arrival because their propagated deadline "
            "had already expired", ("type",),
        ),
    )


def jit_series(reg, service: str) -> _Namespace:
    """Device entry-point families (telemetry/flight.py instrument_entry),
    under the reference's jit names: per wrapped function, its calls, its
    distinct call signatures (``retraces``) and their count. The
    reference's dispatch and device-wait histograms are not kept: nothing
    in the port reads them. `service` picks the metric namespace."""
    return _Namespace(
        calls=reg.counter(
            f"dragonfly_{service}_jit_calls_total",
            "calls into wrapped jitted entry points", ("fn",),
        ),
        retraces=reg.counter(
            f"dragonfly_{service}_jit_retraces_total",
            "compiles/retraces: calls whose signature (shapes/dtypes/statics) "
            "was not seen before", ("fn",),
        ),
        cache_entries=reg.gauge(
            f"dragonfly_{service}_jit_cache_entries",
            "live compile-cache entries per wrapped jitted function", ("fn",),
        ),
    )


def costcard_series(reg) -> _Namespace:
    """Cost-card ledger families (telemetry/costcard.py): per (entry,
    signature) counted cost gauges of every instrumented device program,
    captured at warmup, at a flight dump and at the trainer's first step."""
    labels = ("entry", "signature")
    return _Namespace(
        flops=reg.gauge(
            "dragonfly_costcard_flops",
            "counted FLOPs of one call of a device program signature",
            labels,
        ),
        bytes_accessed=reg.gauge(
            "dragonfly_costcard_bytes_accessed",
            "counted memory traffic (bytes read and written) of one call of "
            "a device program signature",
            labels,
        ),
        output_bytes=reg.gauge(
            "dragonfly_costcard_output_bytes",
            "bytes of the tensors one call of a device program signature "
            "returns",
            labels,
        ),
        temp_bytes=reg.gauge(
            "dragonfly_costcard_temp_bytes",
            "bytes of the intermediate tensors one call of a device program "
            "signature allocates (a sum over its ops, not a peak)",
            labels,
        ),
        captures=reg.counter(
            "dragonfly_costcard_captures_total",
            "cost cards captured (one per new (entry, signature) pair)",
        ),
    )


def timeline_series(reg) -> _Namespace:
    """Soak-timeline families (telemetry/timeline.py): the latest sample
    of every per-interval series a TimelineRecorder tracks, labeled by
    recorder source."""
    return _Namespace(
        value=reg.gauge(
            "dragonfly_timeline_value",
            "latest per-simulated-interval sample of a timeline series",
            ("source", "metric"),
        ),
        samples=reg.counter(
            "dragonfly_timeline_samples_total",
            "timeline samples recorded", ("source",),
        ),
    )


def manager_series(reg) -> _Namespace:
    c = reg.counter
    return _Namespace(
        search_scheduler_cluster=c(
            "dragonfly_manager_search_scheduler_cluster_total",
            "scheduler-cluster searches",
        ),
        search_scheduler_cluster_failure=c(
            "dragonfly_manager_search_scheduler_cluster_failure_total",
            "failed scheduler-cluster searches",
        ),
        request=c(
            "dragonfly_manager_request_total", "REST requests", ("method", "group")
        ),
        request_failure=c(
            "dragonfly_manager_request_failure_total",
            "REST requests answered >= 400",
            ("method", "group"),
        ),
    )


def trainer_series(reg) -> _Namespace:
    c = reg.counter
    return _Namespace(
        training=c("dragonfly_trainer_training_total", "training runs"),
        training_failure=c(
            "dragonfly_trainer_training_failure_total", "failed training runs"
        ),
        train_chunks=c(
            "dragonfly_trainer_train_chunks_total", "dataset chunks", ("dataset",)
        ),
        train_runs=c("dragonfly_trainer_train_total", "train runs", ("state",)),
    )


def serving_series(reg) -> _Namespace:
    """Guarded model activation (registry/serving.py): every new params
    version is gated — sha256 manifest at load, finite-leaves check, and
    a canary scoring pass — before it can become the serving snapshot."""
    c = reg.counter
    return _Namespace(
        activation_rejected=c(
            "dragonfly_serving_activation_rejected_total",
            "params versions rejected by the activation gate (serving "
            "stays on the last-good snapshot)", ("reason",),
        ),
        activation_accepted=c(
            "dragonfly_serving_activation_accepted_total",
            "params versions that passed the activation gate",
        ),
    )


def slo_series(reg) -> _Namespace:
    """Streaming SLO engine families (telemetry/slo.py): per-objective
    error-budget remaining, multi-window burn rates, alert state and
    fire transitions, SLI event accounting, and the engine's three-state
    health verdict — the live-scrape mirror of the `/debug/health`
    verdict plane and the deterministic alert timelines in megascale
    artifacts."""
    return _Namespace(
        budget_remaining=reg.gauge(
            "dragonfly_slo_budget_remaining",
            "fraction of the SLO's error budget remaining over its "
            "accounting window (1.0 = untouched, below 0 = overspent)",
            ("source", "slo"),
        ),
        burn_rate=reg.gauge(
            "dragonfly_slo_burn_rate",
            "error-budget burn rate over one alert-rule window "
            "(1.0 = consuming exactly the budget)",
            ("source", "slo", "rule", "window"),
        ),
        alert_state=reg.gauge(
            "dragonfly_slo_alert_state",
            "multi-window burn-rate alert state (1 = firing: both the "
            "rule's windows burn at or above its factor)",
            ("source", "slo", "rule", "severity"),
        ),
        alerts_fired=reg.counter(
            "dragonfly_slo_alerts_fired_total",
            "burn-rate alert fire transitions",
            ("source", "slo", "rule", "severity"),
        ),
        verdict_state=reg.gauge(
            "dragonfly_slo_verdict_state",
            "health verdict of one SLO engine "
            "(0=ok, 1=degraded, 2=critical)",
            ("source",),
        ),
        sli_events=reg.counter(
            "dragonfly_slo_sli_events_total",
            "good/bad SLI events accounted by the streaming SLO engine",
            ("source", "sli", "outcome"),
        ),
    )


def daemon_series(reg) -> _Namespace:
    c = reg.counter
    return _Namespace(
        proxy_request=c(
            "dragonfly_dfdaemon_proxy_request_total", "proxy requests", ("method",)
        ),
        proxy_request_via=c(
            "dragonfly_dfdaemon_proxy_request_via_dragonfly_total",
            "proxy requests routed through P2P",
        ),
        proxy_request_not_via=c(
            "dragonfly_dfdaemon_proxy_request_not_via_dragonfly_total",
            "proxy requests passed straight through",
        ),
        peer_task=c("dragonfly_dfdaemon_peer_task_total", "peer tasks started"),
        peer_task_failed=c(
            "dragonfly_dfdaemon_peer_task_failed_total", "peer tasks failed", ("type",)
        ),
        piece_task=c("dragonfly_dfdaemon_piece_task_total", "piece downloads"),
        piece_task_failed=c(
            "dragonfly_dfdaemon_piece_task_failed_total", "piece downloads failed"
        ),
        file_task=c("dragonfly_dfdaemon_file_task_total", "file tasks"),
        stream_task=c("dragonfly_dfdaemon_stream_task_total", "stream tasks"),
        seed_peer_download=c(
            "dragonfly_dfdaemon_seed_peer_download_total", "seed downloads"
        ),
        seed_peer_download_failure=c(
            "dragonfly_dfdaemon_seed_peer_download_failure_total",
            "seed downloads failed",
        ),
        seed_peer_download_traffic=c(
            "dragonfly_dfdaemon_seed_peer_download_traffic", "seed bytes", ("type",)
        ),
        peer_task_cache_hit=c(
            "dragonfly_dfdaemon_peer_task_cache_hit_total", "local reuse hits"
        ),
        scheduler_failover=c(
            "dragonfly_dfdaemon_scheduler_failover_total",
            "downloads recovered by failing over to another scheduler "
            "after the announce stream died",
        ),
        seed_task_reannounce=c(
            "dragonfly_dfdaemon_seed_task_reannounce_total",
            "completed tasks re-announced to a scheduler that triggered a "
            "seed download this daemon already holds",
        ),
    )


def tail_series(reg) -> _Namespace:
    """Tail-attribution families (telemetry/tailtrace.py): per-region
    completion/dominant-phase counters bumped on every observed
    download, plus the TTC-quantile, phase-share and exemplar-retention
    gauges refreshed at dump/report time — the live-scrape mirror of the
    deterministic ``tail`` block in megascale artifacts and the
    ``tail`` section of ``/debug/flight``."""
    return _Namespace(
        completions=reg.counter(
            "dragonfly_tail_completions_total",
            "downloads whose TTC was decomposed by the tail plane",
            ("source", "region"),
        ),
        dominant=reg.counter(
            "dragonfly_tail_dominant_total",
            "downloads whose attributed time was dominated by this "
            "lifecycle phase",
            ("source", "region", "phase"),
        ),
        ttc_ms=reg.gauge(
            "dragonfly_tail_ttc_ms",
            "time-to-complete quantile (ms) from the tail plane's "
            "streaming sketch — includes scheduler-wait time, unlike the "
            "transfer-only region percentiles",
            ("source", "region", "quantile"),
        ),
        phase_share=reg.gauge(
            "dragonfly_tail_phase_share",
            "fraction of all attributed download time spent in this "
            "lifecycle phase (shares sum to 1 per region)",
            ("source", "region", "phase"),
        ),
        exemplars_kept=reg.gauge(
            "dragonfly_tail_exemplars_kept",
            "exemplar downloads currently retained by the deterministic "
            "sampler (slowest-K always kept; uniform ring bounded)",
            ("source", "kind"),
        ),
    )


def register_version(reg, service: str) -> None:
    _version.register_version_gauge(reg, service)
