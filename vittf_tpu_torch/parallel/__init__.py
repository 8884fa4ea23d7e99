"""Multi-device layer of the PyTorch/CUDA port (see vittf_tpu/parallel), on
``torch.distributed``: a (dcn, data, model) ``DeviceMesh`` over the default
process group's ranks, data-parallel extraction and similarity, tensor- and
pipeline-parallel ViT forwards."""
from vittf_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "mesh": ("make_mesh", "shard_params", "vit_param_shardings"),
    "extract": ("extract_features_sharded", "similarity_sharded"),
})
