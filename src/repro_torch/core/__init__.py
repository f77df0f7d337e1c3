"""The BPCC core (port of ``repro.core``): allocation, codes, simulator, adaptive
control, streaming and block-MDS decoding, coded ops and parity control.

Re-exports what the reference's ``repro.core`` does, where it is ported
(``peel_decode_torch`` is the counterpart of ``peel_decode_jax``):

    from repro_torch.core import (
        ShiftedExp, bpcc_allocation, hcmm_allocation, allocate,
        LTCode, GaussianCode, encode_matrix,
        peel_decode_np, ls_decode, masked_pinv_decode,
        simulate_scheme, accumulation_curve,
        CodedLinear, coded_block_matmul, bpcc_batched_matvec,
        GradCode, frc_code, cyclic_code, decode_weights,
    )
"""
from repro_torch.core.distributions import (  # noqa: F401
    ShiftedExp,
    estimate_parameters,
    sample_heterogeneous_cluster,
)
from repro_torch.core.allocation import (  # noqa: F401
    Allocation,
    allocate,
    bpcc_allocation,
    hcmm_allocation,
    load_balanced_allocation,
    load_infimum,
    lambda_infimum,
    lambda_supremum,
    solve_lambda,
    tau_star,
    tau_star_infimum,
    tau_star_supremum,
    uniform_allocation,
)
from repro_torch.core.encoding import (  # noqa: F401
    EncodePlan,
    GaussianCode,
    LTCode,
    encode_matrix,
    required_rows,
    robust_soliton,
)
from repro_torch.core.decoding import (  # noqa: F401
    ls_decode,
    masked_pinv_decode,
    peel_decode_np,
    peel_decode_plan,
    peel_decode_torch,
)
from repro_torch.core.coded_ops import (  # noqa: F401
    CodedLinear,
    block_mds_generator,
    bpcc_batched_matvec,
    coded_block_matmul,
    decode_blocks,
    encode_blocks,
    row_coded_matvec,
)
from repro_torch.core.simulator import (  # noqa: F401
    AdaptiveSimResult,
    SimResult,
    accumulation_curve,
    completion_time,
    sample_rates,
    simulate_adaptive_scheme,
    simulate_scheme,
)
from repro_torch.core.adaptive import (  # noqa: F401
    ChurnEvent,
    ChurnSchedule,
    EstimatorConfig,
    OnlineRateEstimator,
    ParityController,
    ReallocationPolicy,
    simulate_adaptive,
)
from repro_torch.core.gradient_coding import (  # noqa: F401
    GradCode,
    cyclic_code,
    decode_weights,
    decode_weights_checked,
    frc_code,
)
