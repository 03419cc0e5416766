"""Data sources of the port: numpy copies of the JAX package's, and the
sparse substrate's mini-batch draw on the device."""
from repro_torch.data.dirichlet import dirichlet_partition, heterogeneity_index
from repro_torch.data.pipeline import (
    BatchedFederatedLoader,
    FederatedLoader,
    client_batch_indices,
    gather_client_batches,
)
from repro_torch.data.synthetic import SyntheticClassification, make_federated_classification

__all__ = ["dirichlet_partition", "heterogeneity_index", "FederatedLoader",
           "BatchedFederatedLoader", "client_batch_indices", "gather_client_batches",
           "SyntheticClassification", "make_federated_classification"]
