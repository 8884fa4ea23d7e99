"""The trainer layer of the port (``vittf_tpu/train``). The trainers
themselves are not ported yet; this exports what is."""
from vittf_tpu_torch.train.gather import gather_receptive_fields  # noqa: F401
from vittf_tpu_torch.train.losses import (  # noqa: F401
    feature_std,
    infonce_loss,
    paws_loss,
    sharpen,
    snn,
    transform_paws_crops,
)
from vittf_tpu_torch.train.probe import ProbeConfig, ProbeTrainer  # noqa: F401
