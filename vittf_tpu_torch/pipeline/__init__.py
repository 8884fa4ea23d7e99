"""pipeline layer of the PyTorch/CUDA port (see vittf_tpu/pipeline)."""
from vittf_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "features": ("ExtractConfig", "compute_im_sizes", "extract_features"),
    "ntf": ("compute_similarities", "fuse_predictions", "upscale_prediction"),
    "annotations": ("annotations_from_labels", "sample_both", "sample_surface", "sample_uniform"),
    "evaluate": ("confusion_matrix", "evaluate_user_study", "metrics_from_confusion",
                 "segmentation_metrics"),
    "refine": ("refine_similarity",),
})
