"""Dense feed-forward layers (bias-free, as in the JAX package)."""
import torch.nn.functional as F

from repro_torch.models.peft import lora_proj


def act_fn(name: str):
    if name == "swiglu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda t: F.gelu(t, approximate="tanh")


def mlp(x, params, act: str, lora=None, scale: float = 1.0):
    """swiglu/geglu: act(x·Wg) * (x·Wu) · Wd ;  gelu: act(x·Wu) · Wd.

    ``lora`` is an optional factor subtree mirroring ``params``: a
    projection that carries factors runs through ``lora_proj``."""
    def proj(t, name):
        return lora_proj(t, params[name], None if lora is None else lora.get(name),
                         scale=scale)

    if act in ("swiglu", "geglu"):
        h = act_fn(act)(proj(x, "wg")) * proj(x, "wu")
    else:
        h = act_fn(act)(proj(x, "wu"))
    return proj(h, "wd")
