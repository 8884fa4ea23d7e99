"""ops layer of the PyTorch/CUDA port (see vittf_tpu/ops)."""
from vittf_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "resize": ("resize_nearest", "resize_linear", "adaptive_avg_pool", "resize_cubic"),
    "sampling": ("grid_sample_2d", "grid_sample_3d", "rel_coords_from_abs", "sample_features2d",
                 "sample_features3d"),
    "similarity": ("fused_similarity", "fused_similarity_m"),
    "attention": ("multi_head_attention",),
    "bilateral": ("apply_bilateral_solver2d", "apply_bilateral_solver3d"),
    "bilateral_sparse": ("apply_bilateral_solver3d_rgb",),
    "connected": ("connected_components", "filter_similarity_largest_island",
                  "largest_component"),
    "crop": ("crop_pad", "write_crop_into"),
    "morphology": ("binary_erosion", "binary_fill_holes", "filter_gauss_separated",
                   "filter_sobel_separated"),
    "query": ("resample_topk", "take_most_dissimilar"),
})
