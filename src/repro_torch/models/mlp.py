"""Dense feed-forward layers (bias-free, as in the JAX package)."""
import torch.nn.functional as F

from repro_torch.models.peft import lora_proj
from repro_torch.sharding import copy_to, reduce_from


def act_fn(name: str):
    if name == "swiglu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda t: F.gelu(t, approximate="tanh")


def mlp(x, params, act: str, lora=None, scale: float = 1.0, mc=None):
    """swiglu/geglu: act(x·Wg) * (x·Wu) · Wd ;  gelu: act(x·Wu) · Wd.

    ``lora`` is an optional factor subtree mirroring ``params``: a
    projection that carries factors runs through ``lora_proj``.  ``mc``
    (a ``sharding.MeshCtx``): tensor-parallel, ``params`` this rank's
    columns of Wg/Wu and rows of Wd (and ``lora`` in that layout,
    ``parallel.plan_factors``): the input's gradient and the output summed
    over the model axis."""
    if mc is not None:
        x = copy_to(x, mc, mc.model_axis)

    def proj(t, name):
        return lora_proj(t, params[name], None if lora is None else lora.get(name),
                         scale=scale)

    if act in ("swiglu", "geglu"):
        h = act_fn(act)(proj(x, "wg")) * proj(x, "wu")
    else:
        h = act_fn(act)(proj(x, "wu"))
    out = proj(h, "wd")
    return out if mc is None else reduce_from(out, mc, mc.model_axis)
