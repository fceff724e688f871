"""Test utilities shipped with the framework: seeded chaos injection
(`testing.chaos`). The adversarial scenario harness (`testing.scenarios`)
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
]
