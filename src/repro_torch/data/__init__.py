"""Synthetic corpora, non-IID partitioning and batching (numpy only):
copies of the JAX package's ``repro.data`` modules."""
from repro_torch.data.partition import dirichlet_partition  # noqa: F401
from repro_torch.data.pipeline import batch_iterator  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    SPECIAL, VOCAB, ClassificationCorpus, InstructionCorpus,
)
