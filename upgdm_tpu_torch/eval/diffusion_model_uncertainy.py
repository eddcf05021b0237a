"""The evaluation module under its other name, ``diffusion_model_uncertainy``
(sic): everything lives in :mod:`upgdm_tpu_torch.eval.uncertainty`, and the
window helpers keep the names they have there."""
from .uncertainty import *  # noqa: F401,F403
from .uncertainty import (  # noqa: F401
    batched_gx,
    default_sample_window_step,
    load_sensitivity_model,
    normalize_diffstg_pred_future_list,
    plot_single_model_check,
    read_model_config,
    resolve_cache_path,
    resolve_figure_path,
    run_diffstg_evaluation_cache,
    run_slbp_gx_cache_for_fig6,
    run_slbp_sensitivity_cache,
    summarize_slbp_gx_for_fig6,
    summarize_slbp_mpv_cache_for_fig5,
    summarize_slbp_sampling_for_fig6,
    summarize_slbp_sensitivity,
    torch_data_preprocessing_like_slbp,
)
from ..ops.windows import (  # noqa: F401
    build_sliding_windows_compat as build_sliding_windows,
    infer_sample_window_step_from_cache,
    normalize_time_series,
    sample_time_series,
    sampling_interval_from_t,
    sliding_window_count,
    slbp_sensitivity_windows as build_slbp_sensitivity_windows,
)
