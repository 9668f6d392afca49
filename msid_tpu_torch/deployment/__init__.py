"""Serving for the PyTorch port: export (``torch.export``; ``export_program``
in the place of the JAX package's ``export_stablehlo``), verification,
inference sessions, the folded graphs, int8 weights and scene restoration."""

from msid_tpu_torch.deployment.export import (
    ComparisonResult,
    compare_live_vs_exported,
    export_program,
    load_exported,
    make_inference_fn,
    verify_exported_model,
)
from msid_tpu_torch.deployment.fastpath import (
    make_fast_inference_fn,
    make_hybrid_inference_fn,
    optimize_for_hybrid,
    optimize_for_inference,
)
from msid_tpu_torch.deployment.inference import InferenceSession
from msid_tpu_torch.deployment.quantize import (
    dequantize_params,
    quantization_report,
    quantize_params,
)
from msid_tpu_torch.deployment.sliding_window import (
    make_device_scene_step,
    make_scene_step,
    restore_scene,
    restore_scene_streaming,
)

__all__ = [
    "ComparisonResult",
    "InferenceSession",
    "dequantize_params",
    "make_device_scene_step",
    "make_scene_step",
    "quantization_report",
    "quantize_params",
    "restore_scene",
    "restore_scene_streaming",
    "compare_live_vs_exported",
    "export_program",
    "load_exported",
    "make_fast_inference_fn",
    "make_hybrid_inference_fn",
    "make_inference_fn",
    "optimize_for_hybrid",
    "optimize_for_inference",
    "verify_exported_model",
]
