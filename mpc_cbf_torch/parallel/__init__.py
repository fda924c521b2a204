from mpc_cbf_torch.parallel.mesh import (  # noqa: F401
    SCENARIO_AXIS,
    AGENT_AXIS,
    make_mesh,
    scenario_sharding,
    scenario_agent_sharding,
)
from mpc_cbf_torch.parallel.sim import (  # noqa: F401
    BezierMPCSim,
    CBFOnlySim,
    CBFSimResult,
    MultiAgentSim,
    SimResult,
    sharded_rollout,
)
