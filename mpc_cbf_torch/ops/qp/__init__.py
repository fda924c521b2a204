from mpc_cbf_torch.ops.qp.structured import (  # noqa: F401
    StructuredConfig,
    StructuredQPOperator,
    StructuredSolution,
)
from mpc_cbf_torch.ops.qp.ipm import (  # noqa: F401
    HYBRID_PROD,
    IPM_F32_ENTRY,
    IPM_F64_TAIL,
    IPM_F64_TAIL_PROD,
    HybridIPM,
    HybridIPMConfig,
    IPMConfig,
    IPMSolution,
    StructuredIPM,
)
