from mpc_cbf_torch.controllers.bezier_mpc import (  # noqa: F401
    BezierParams,
    MPCParams,
    BezierMPCOperator,
    BezierMPC,
)
from mpc_cbf_torch.controllers.mpc_cbf import (  # noqa: F401
    IMPCParams,
    IMPCResult,
    FovIMPCCBF,
    BezierMPCCBF,
    ConnectivityIMPCCBF,
    StructuredIMPC,
)
from mpc_cbf_torch.controllers.cbf_qp import (  # noqa: F401
    CBFControlResult,
    FovCBFController,
    ConnectivityCBFController,
)
