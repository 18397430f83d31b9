"""Flat-key ``.npz`` checkpoints of trees of tensors."""
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint, save_json  # noqa: F401
