"""Flat-key ``.npz`` checkpoints of trees of tensors."""
from repro_torch.checkpoint.ckpt import (load_checkpoint, load_meta,  # noqa: F401
                                         save_checkpoint, save_json)
