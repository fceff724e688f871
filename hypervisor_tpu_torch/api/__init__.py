"""REST API: service layer + FastAPI/stdlib transports."""

from hypervisor_tpu_torch.api.service import ApiError, HypervisorService
from hypervisor_tpu_torch.api.server import (
    HypervisorHTTPServer,
    ROUTES,
    create_app,
    serve,
)

__all__ = [
    "ApiError",
    "HypervisorService",
    "HypervisorHTTPServer",
    "ROUTES",
    "create_app",
    "serve",
]
