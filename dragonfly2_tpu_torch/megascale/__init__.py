"""Port of dragonfly2_tpu/megascale/__init__.py: the megascale scenario
lab, vectorized event-batch simulation at 10^5–10^6 hosts, driving the
port's scheduler on the card.

The per-peer ``cluster/simulator.ClusterSimulator`` — retained unchanged
as the decision-equivalence oracle — advances one piece per Python loop
iteration; this package advances ALL in-flight downloads one event batch
per round as numpy ops over columnar peer state, feeding the scheduler's
bulk APIs (``pieces_finished_batch``, ``register_peers_batch``,
``leave_hosts_batch``):

- ``engine``:   ``EventBatchEngine`` (the oracle's vectorized twin) +
                ``megascale_service`` (a scheduler sized for the scale);
- ``topology``: region/WAN host populations, the vectorized
                counter-hashed uniform sampler, and ``WanCostModel``
                (parameterized RTT/bandwidth tiers per topology relation
                — the analytic model of arXiv 2103.10515);
- ``soak``:     the compressed 24h-in-production run (every fault family
                at once) behind the ``soak`` scenario builtin;
- ``fleet``:    ``SchedulerFleet`` (K task-sharded scheduler replicas
                behind one consistent hashring, cross-scheduler peer
                handoff on ring rebalance) + ``FleetEventBatchEngine``
                (the fleet-routed engine) behind the ``fleet`` builtin.

Every entry that builds a service (``megascale_service``,
``megascale_fleet``, ``run_megascale``) takes ``device``: None is the
card, and raises where there is none.
"""

from dragonfly2_tpu_torch.megascale.engine import (  # noqa: F401
    EventBatchEngine,
    MegaStats,
    megascale_service,
)
from dragonfly2_tpu_torch.megascale.topology import (  # noqa: F401
    WanCostModel,
    hash_u01,
    make_region_cluster,
)
from dragonfly2_tpu_torch.megascale.soak import run_megascale  # noqa: F401
from dragonfly2_tpu_torch.megascale.fleet import (  # noqa: F401
    FleetEventBatchEngine,
    SchedulerFleet,
    megascale_fleet,
)
