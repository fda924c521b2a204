from mpc_cbf_torch.estimation.particle_filter import (  # noqa: F401
    PFParams,
    PFState,
    pf_init,
    pf_predict,
    pf_update,
    pf_resample,
    pf_estimate,
    process_fov_update,
)
