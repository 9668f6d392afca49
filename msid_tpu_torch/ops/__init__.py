"""Ops of the PyTorch port: preprocessing, corruption (kernel K2), the
dead-band fill, SSIM and metrics, the fused ResidualBlock (kernels K1 in
bf16 and K4 in fp32) and the dihedral test-time self-ensemble.

The names re-exported here are the JAX package's; the kernels' wrappers
(``cuda_decoder``, ``cuda_noise``, ``cuda_probe``) are imported directly,
and nothing here builds or loads a kernel."""

from msid_tpu_torch.ops.fill import (
    detect_alive,
    detect_and_fill,
    fit_gram,
    linear_fill,
)
from msid_tpu_torch.ops.metrics import (
    MetricsTracker,
    batch_metric_sums,
    calculate_mae,
    calculate_psnr,
    calculate_rmse,
    calculate_sam,
    calculate_ssim,
    mae_per_sample,
    psnr_per_sample,
    rmse_per_sample,
    sam_per_sample,
)
from msid_tpu_torch.ops.noise import NoiseConfig, apply_sensor_noise
from msid_tpu_torch.ops.preprocess import (
    from_model_range,
    normalize_raw,
    preprocess_tiles,
    resize_bilinear,
    to_model_range,
)
from msid_tpu_torch.ops.ssim import ssim, ssim_map, ssim_per_sample
from msid_tpu_torch.ops.tta import dihedral_ensemble, dihedral_inverse, dihedral_transform

__all__ = [
    "MetricsTracker",
    "NoiseConfig",
    "apply_sensor_noise",
    "batch_metric_sums",
    "calculate_mae",
    "calculate_psnr",
    "calculate_rmse",
    "calculate_sam",
    "calculate_ssim",
    "detect_alive",
    "detect_and_fill",
    "dihedral_ensemble",
    "dihedral_inverse",
    "dihedral_transform",
    "fit_gram",
    "from_model_range",
    "linear_fill",
    "mae_per_sample",
    "normalize_raw",
    "preprocess_tiles",
    "psnr_per_sample",
    "resize_bilinear",
    "rmse_per_sample",
    "sam_per_sample",
    "ssim",
    "ssim_map",
    "ssim_per_sample",
    "to_model_range",
]
