"""Federated learning core: aggregation operators, the cohort engine and
PFTT (the paper's §IV-D)."""
