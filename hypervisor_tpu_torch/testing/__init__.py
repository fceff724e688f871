"""Test utilities shipped with the framework: seeded chaos injection
(`testing.chaos`), the masks that hold two runs of one sequence equal
(`testing.compare`), and the seeded adversarial scenario harness
(`testing.scenarios`)."""

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
from hypervisor_tpu_torch.testing.compare import (
    masked_output,
    same_health_on_every_run,
    supervisor_accounting,
)
from hypervisor_tpu_torch.testing import scenarios

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
    "masked_output",
    "same_health_on_every_run",
    "scenarios",
    "supervisor_accounting",
]
