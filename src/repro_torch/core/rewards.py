"""Double reward model and the personalized reward function (paper §IV-C):
the port of ``repro.core.rewards``.

Each client holds preference weights (α_help, α_safe); its quality reward
is the linear combination of the two reward models' scores, and the full
personalized reward adds the negative L2 pull toward the global model (the
knowledge-sharing term):

    r_i(x) = α_h^i · r_help(x) + α_s^i · r_safe(x) − λ_i · ‖θ_i − θ_g‖²
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch import trees
from repro_torch.rlhf.reward_model import RewardModel


@dataclasses.dataclass(frozen=True)
class ClientPreference:
    alpha_help: float = 0.5
    alpha_safe: float = 0.5
    lambda_reg: float = 1e-4


@dataclasses.dataclass
class DoubleReward:
    rm_help: RewardModel
    rm_help_params: dict
    rm_safe: RewardModel
    rm_safe_params: dict

    def quality(self, tokens, mask, pref: ClientPreference):
        h = self.rm_help.score(self.rm_help_params, tokens, mask)
        s = self.rm_safe.score(self.rm_safe_params, tokens, mask)
        return pref.alpha_help * h + pref.alpha_safe * s

    def personalized(self, tokens, mask, pref: ClientPreference,
                     local_params: Optional[dict] = None,
                     global_params: Optional[dict] = None):
        r = self.quality(tokens, mask, pref)
        if local_params is not None and global_params is not None \
                and pref.lambda_reg > 0:
            r = r - pref.lambda_reg * trees.tree_l2(local_params, global_params)
        return r
