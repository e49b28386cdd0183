"""Seeker's core: coresets, recovery, memoization, energy model, the
decision flow, the classical codecs it is compared with, and the gradient
and activation codecs of the training fleet."""
from .coreset import (  # noqa: F401
    ClusterCoreset, SamplingCoreset, points_from_window, window_from_points,
    channel_cluster_coresets, kmeans_coreset, importance_weights,
    importance_coreset, topk_importance_coreset, quantize_uniform,
    dequantize_uniform, EncodedClusterCoreset, encode_cluster_coreset,
    decode_cluster_coreset,
    raw_payload_bytes, cluster_payload_bytes, sampling_payload_bytes,
)
from .recovery import (  # noqa: F401
    recover_cluster_points, recover_cluster_window, GeneratorParams,
    init_generator, generator_apply, recover_sampling_window,
    DiscriminatorParams, init_discriminator, discriminator_apply,
)
from .memo import (  # noqa: F401
    pearson, signature_correlations, memo_decision, MemoResult,
)
from .energy import (  # noqa: F401
    EnergyCosts, TABLE2_COSTS, BEARING_COST_SCALE, D5_RAW, harvest_trace,
    EH_SOURCES, fleet_source_assignment, fleet_harvest_traces,
    fleet_phase_offsets, fleet_alive_traces, BrownoutConfig, supercap_step,
    supercap_step_direct, SUPERCAP_CAP_UJ, SUPERCAP_CHARGE_EFF,
    PredictorState, predictor_init, predictor_update, predictor_forecast,
)
from .aac import (  # noqa: F401
    AACTable, make_aac_table, select_k, aac_payload_bytes,
)
from .decision import (  # noqa: F401
    D0_MEMO, D1_DNN_FULL, D2_DNN_QUANT, D3_CLUSTER, D4_SAMPLING, DEFER,
    D6_PARTIAL, D7_EARLY_EXIT, D8_STAGED_FULL, N_INTERMITTENT_DECISIONS,
    IntermittentConfig, DecisionOutcome, choose_decision, decision_energy,
)
from .classical import (  # noqa: F401
    dct_compress, dwt_compress, fourier_compress, classical_payload_bytes,
)
from .compression import (  # noqa: F401
    CompressionConfig, topk_compress, topk_decompress, topk_block_compress,
    topk_block_decompress, kmeans1d, kmeans1d_decompress, Kmeans1dCoreset,
    coreset_allreduce, compress_activation, decompress_activation,
    wire_bytes_dense_psum, wire_bytes_topk_allgather, wire_bytes_kmeans1d,
)
