"""Port of dragonfly2_tpu/procworld/__init__.py: procworld, the
real-process planet harness, over the port's launchers; its schedulers
run on the card unless ``run_procday`` is asked for the CPU.

One supervised multi-process deployment of the actual services
(schedulers, dfdaemons, manager) over real sockets, with process-level
chaos the simulator cannot express (SIGKILL mid-download, SIGSTOP
partitions, rolling restarts of real processes), reduced to the SAME
timeline/SLO artifact the megascale simulator emits — so dfslo replays
it unchanged and the divergence report compares sim and real
like-for-like.
"""

from dragonfly2_tpu_torch.procworld.divergence import (
    DEFAULT_BANDS,
    compute_divergence,
    publish_divergence,
)
from dragonfly2_tpu_torch.procworld.origin import OriginServer
from dragonfly2_tpu_torch.procworld.planet import real_facts, run_procday
from dragonfly2_tpu_torch.procworld.sample import (
    RoundObservation,
    announce_page_rounds,
    build_sample,
    quantile,
    synthesize_timeline,
)
from dragonfly2_tpu_torch.procworld.supervisor import (
    ManagedProc,
    ProcessPlanet,
    spawn_cmd,
    stop_proc,
    wait_for,
)

__all__ = [
    "DEFAULT_BANDS",
    "ManagedProc",
    "OriginServer",
    "ProcessPlanet",
    "RoundObservation",
    "announce_page_rounds",
    "build_sample",
    "compute_divergence",
    "publish_divergence",
    "quantile",
    "real_facts",
    "run_procday",
    "spawn_cmd",
    "stop_proc",
    "synthesize_timeline",
    "wait_for",
]
