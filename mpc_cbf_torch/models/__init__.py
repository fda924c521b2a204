from mpc_cbf_torch.models.double_integrator import (  # noqa: F401
    DoubleIntegrator,
    double_integrator_xyyaw,
)
