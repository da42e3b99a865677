"""The scheduler service (cluster/scheduler.py, with its messages, probes,
quarantine and simulator), the trainer service (cluster/trainer_service.py)
and the announcer that streams a scheduler's traces to it
(cluster/announcer.py)."""
