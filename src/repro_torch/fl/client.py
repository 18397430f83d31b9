"""Generic federated client: local trainable state + a supplied step fn
(the port of ``repro.fl.client``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

from repro_torch import trees


@dataclasses.dataclass
class FLClient:
    cid: int
    trainable: Any                       # tree of tensors
    opt_state: Any
    data_iter: Iterator
    step_fn: Callable                    # (trainable, opt_state, batch) → (t, o, loss)
    upload_pred: Optional[Callable[[str], bool]] = None

    def local_epoch(self, steps: int):
        loss = None
        for _ in range(steps):
            self.trainable, self.opt_state, loss = self.step_fn(
                self.trainable, self.opt_state, next(self.data_iter))
        return loss

    def upload(self):
        if self.upload_pred is None:
            return self.trainable
        return trees.select(self.trainable, self.upload_pred)

    def receive(self, aggregated):
        self.trainable = trees.merge(self.trainable, aggregated)
