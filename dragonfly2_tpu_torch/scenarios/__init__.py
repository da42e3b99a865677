"""Port of dragonfly2_tpu/scenarios/__init__.py: ``spec`` and ``engine``.

Scenario lab: heterogeneous-workload + fault-injection subsystem.

The round-5 A/B ran on a homogeneous simulated cluster, where every
evaluator measures identical because there is nothing for a learned
scorer to exploit — while the paper's premise is learning over
heterogeneous networktopology probes and piece-download traces. This
package generates the structured, adversarial cluster conditions that
premise needs, deterministically from a (spec, seed) pair:

- ``spec``:     declarative scenario specs (dataclasses, TOML/JSON
                loadable) — link models (bimodal racks, oversubscribed
                spines, slow NICs), peer churn, flaky parents, Zipf task
                popularity;
- ``engine``:   the seed-driven deterministic sampler behind a spec —
                per-host assignments, per-event fault decisions via
                counter-based hashing (same seed + spec => identical
                fault schedule, independent of wall clock), plus the
                ``FaultInjector`` the real client upload path consumes;
- ``ab``:       the scenario-matrix A/B harness running
                {default, ml, random[, nt]} evaluators across a scenario
                grid with paired seeds and confidence intervals; its ml
                arm trains through the trainer service.

The megascale builtins (``megascale_scenarios``) drive the megascale lab
(megascale/) and the process planet (procworld/); the reference's
``bench_scenarios.py`` CLI comes with the port's bench harness (A6).
"""

from dragonfly2_tpu_torch.scenarios.spec import (  # noqa: F401
    ChurnSpec,
    ControlPlaneSpec,
    FlakySpec,
    FlashCrowdSpec,
    LinkSpec,
    ScenarioSpec,
    SkewSpec,
    TrafficSpec,
    UpgradeSpec,
    WanSpec,
    builtin_scenarios,
    load_scenario,
    megascale_scenarios,
    resolve_scenario,
)
from dragonfly2_tpu_torch.scenarios.engine import FaultInjector, ScenarioEngine  # noqa: F401
