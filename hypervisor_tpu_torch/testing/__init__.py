"""Test utilities shipped with the framework: seeded chaos injection
(`testing.chaos`) and the masks that hold two runs of one sequence equal
(`testing.compare`). The adversarial scenario harness (`testing.scenarios`)
comes with the upper planes (ROADMAP A7)."""

from hypervisor_tpu_torch.testing.chaos import (
    ChaosExecutorFactory,
    ChaosFailure,
    ChaosPlan,
    InjectedCorruption,
    InjectedDeviceLoss,
    InjectedFleetFault,
    InjectedWaveFault,
    WaveChaosInjector,
    WaveChaosPlan,
)
from hypervisor_tpu_torch.testing.compare import same_health_on_every_run, supervisor_accounting

__all__ = [
    "ChaosExecutorFactory",
    "ChaosFailure",
    "ChaosPlan",
    "InjectedCorruption",
    "InjectedDeviceLoss",
    "InjectedFleetFault",
    "InjectedWaveFault",
    "WaveChaosInjector",
    "WaveChaosPlan",
    "same_health_on_every_run",
    "supervisor_accounting",
]
