from mpc_cbf_torch.parallel.sim import (  # noqa: F401
    BezierMPCSim,
    CBFOnlySim,
    CBFSimResult,
    MultiAgentSim,
    SimResult,
)
