"""Deployment layer (counterpart of ``mpc_cbf_tpu/deploy``), the equivalent
of the reference ROS stack (``workspace/src``): message bus + virtual-time
scheduler + nodes."""

from mpc_cbf_torch.deploy.runtime import Bus, Scheduler, Node  # noqa: F401
from mpc_cbf_torch.deploy.nodes import (  # noqa: F401
    ControlNode,
    FilterNode,
    GoalNode,
    IdsNode,
    SITLPlant,
    launch_formation,
)
