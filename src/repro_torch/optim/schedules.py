"""Learning-rate schedules (the port of ``repro.optim.schedules``): each
maps the optimizer's int step tensor to an f32 learning rate."""
import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    def fn(step):
        s = step.float()
        warm = s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return lr * torch.where(s < warmup, warm, cos)
    return fn
