"""PatchmatchNet modules of the port."""

from patchmatchnet_torch.models.net import PatchmatchNet

__all__ = ["PatchmatchNet"]
