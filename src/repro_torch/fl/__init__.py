"""Federated-learning runtime pieces, the port of ``repro.fl``: the generic
client/server/round loop and the host-resident client population of
sampled-cohort training."""
from repro_torch.fl.client import FLClient  # noqa: F401
from repro_torch.fl.population import (  # noqa: F401
    ClientSampler, PopulationConfig, PopulationData, PopulationRunner,
    PopulationStore, stacked_client_init)
from repro_torch.fl.rounds import run_rounds  # noqa: F401
from repro_torch.fl.server import FLServer  # noqa: F401
