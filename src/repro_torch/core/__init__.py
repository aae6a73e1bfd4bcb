"""PipeSim core on PyTorch (mirrors :mod:`repro.core`): trace-driven
simulation of AI operations platforms.

- :mod:`repro_torch.core.model` — conceptual system model (pipelines,
  tasks, resources, assets) as struct-of-arrays;
- :mod:`repro_torch.core.stats`, :mod:`repro_torch.core.gmm` — fit/export/
  sample statistical machinery (Dist records, EM GMM on the card);
- :mod:`repro_torch.core.workload` — ground-truth "real system" trace
  generator;
- :mod:`repro_torch.core.fitting` — trace -> SimulationParams fitting;
- :mod:`repro_torch.core.synthesizer` — pipeline & data synthesizer;
- :mod:`repro_torch.core.des` / :mod:`repro_torch.core.vdes` — the exact
  heap engine and the batched wave-loop engine on the card;
- :mod:`repro_torch.core.metrics`, :mod:`repro_torch.core.runtime` — model
  metrics, the fleet drift algebra, and the declarative model-lifecycle
  specs (FleetSpec/TriggerSpec) lowered into both engines;
- :mod:`repro_torch.core.trace` — columnar trace store + analytics;
- :mod:`repro_torch.core.experiment` — experiment runner / sweeps;
- :mod:`repro_torch.core.costmodel` — roofline-grounded task durations
  from the one-card dry-run (the trace link between simulator and real
  system).

The names below are the reference's, with :class:`TorchEngine` in the
place of its ``JaxEngine``.
"""

from repro_torch.core.des import POLICY_FIFO, POLICY_PRIORITY, POLICY_SJF  # noqa: F401
from repro_torch.core.engines import (Engine, NumpyEngine, TorchEngine,  # noqa: F401
                                      get_engine, register_engine)
from repro_torch.core.experiment import (ExperimentResult,  # noqa: F401
                                         ExperimentSpec, Sweep, as_spec,
                                         run_experiment)
from repro_torch.core.fitting import (SimulationParams,  # noqa: F401
                                      fit_simulation_params)
from repro_torch.core.model import (PlatformConfig, ResourceConfig,  # noqa: F401
                                    Workload)
from repro_torch.core.runtime import (FleetSpec, LifecycleResult,  # noqa: F401
                                      TriggerSpec, run_feedback_simulation)
from repro_torch.core.synthesizer import synthesize_workload  # noqa: F401
from repro_torch.core.workload import generate_empirical_workload  # noqa: F401
