"""Numpy data sources of the port (copies of the JAX package's)."""
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.pipeline import BatchedFederatedLoader, FederatedLoader
from repro_torch.data.synthetic import SyntheticClassification, make_federated_classification

__all__ = ["dirichlet_partition", "FederatedLoader", "BatchedFederatedLoader",
           "SyntheticClassification", "make_federated_classification"]
