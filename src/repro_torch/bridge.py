"""Parameter and LoRA trees between the JAX package and the port.

Both sides exchange flat ``{path: numpy array}`` dicts keyed like
``repro.trees.flatten`` — ``stages/0/layers/0/mixer/wq`` for a weight with
its leading repeat axis, ``stages/0/layers/0/mixer/wq/{a,b,mask}`` for a
LoRA factor leaf.  The port's trees are the same nesting (dicts, with
``stages`` and ``layers`` as lists) holding tensors, so a round trip is
bit-exact.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import trees
from repro_torch.configs.base import ModelConfig


def _tensor(arr, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, copy=True))
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _listify_stages(tree: dict, cfg: ModelConfig, *, fill_missing: bool):
    """Turn the ``stages``/``layers`` levels (dicts keyed '0', '1', … after
    ``unflatten``) into lists sized by the config.  A LoRA tree may lack a
    layer that carries no factors (``fill_missing`` → empty dict); a
    parameter tree may not."""
    stages_in = tree.get("stages", {})
    stages = []
    for si, stage in enumerate(cfg.stages):
        sd = stages_in.get(str(si))
        if sd is None:
            if not fill_missing:
                raise KeyError(f"params lack stage {si}")
            sd = {}
        layers_in = sd.get("layers", {})
        layers = []
        for pi in range(len(stage.pattern)):
            lp = layers_in.get(str(pi))
            if lp is None:
                if not fill_missing:
                    raise KeyError(f"params lack stages/{si}/layers/{pi}")
                lp = {}
            for path, leaf in trees.flatten(lp).items():
                if leaf.shape[0] != stage.repeats:
                    raise ValueError(
                        f"stages/{si}/layers/{pi}/{path}: leading axis "
                        f"{leaf.shape[0]} != repeats {stage.repeats}")
            layers.append(lp)
        extra = set(layers_in) - {str(i) for i in range(len(stage.pattern))}
        if extra:
            raise KeyError(f"stage {si} has layers {sorted(extra)} beyond its pattern")
        stages.append(dict(sd, layers=layers))
    return dict(tree, stages=stages)


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                      device="cpu", dtype: Optional[torch.dtype] = None):
    """Flat JAX-exported params → the port's nested tensor tree."""
    tree = trees.unflatten({k: _tensor(v, device, dtype) for k, v in flat.items()})
    return _listify_stages(tree, cfg, fill_missing=False)


def lora_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                    device="cpu", dtype: Optional[torch.dtype] = None):
    """Flat JAX-exported LoRA factors (``…/wq/a``, ``…/wq/b``,
    ``…/wq/mask``) → the port's factor tree; layers without factors become
    empty dicts."""
    tree = trees.unflatten({k: _tensor(v, device, dtype) for k, v in flat.items()})
    bad = [p for p in trees.flatten(tree)
           if p.rsplit("/", 1)[-1] not in ("a", "b", "mask")]
    if bad:
        raise ValueError(f"not LoRA factor leaves: {sorted(bad)[:4]}")
    return _listify_stages(tree, cfg, fill_missing=True)


def to_numpy(tree) -> Dict[str, np.ndarray]:
    """The port's tree → flat ``{path: numpy array}`` (the inverse of the
    two loaders)."""
    return {k: v.detach().cpu().numpy() for k, v in trees.flatten(tree).items()}
