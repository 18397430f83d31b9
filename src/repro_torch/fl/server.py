"""Generic federated server: aggregation strategy + channel bookkeeping
(the port of ``repro.fl.server``)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.core.aggregation import fedavg
from repro_torch.wireless import CommLedger, RayleighChannel, tree_bytes


@dataclasses.dataclass
class FLServer:
    channel: Optional[RayleighChannel] = None
    aggregate_fn: Callable = fedavg
    ledger: CommLedger = dataclasses.field(default_factory=CommLedger)

    def round(self, clients: Sequence, weights=None):
        """Collect uploads over the channel, aggregate survivors, broadcast."""
        uploads, reports = [], []
        gains = (self.channel.realize(len(clients))
                 if self.channel else [None] * len(clients))
        for c, g in zip(clients, gains):
            up = c.upload()
            if self.channel is not None:
                rep = self.channel.uplink(tree_bytes(up), gain=g)
                reports.append(rep)
                if rep.outage:
                    continue
            uploads.append(up)
        if self.channel is not None:
            self.ledger.log_round(reports)
        if not uploads:
            return None
        agg = self.aggregate_fn(uploads, weights)
        for c in clients:
            c.receive(agg)
        return agg
