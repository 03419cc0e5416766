"""Data sources of the port: numpy copies of the JAX package's (the FL
classification problem, the model zoo's token stream), and the sparse
substrate's mini-batch draw on the device."""
from repro_torch.data.dirichlet import dirichlet_partition, heterogeneity_index
from repro_torch.data.pipeline import (
    BatchedFederatedLoader,
    FederatedLoader,
    client_batch_indices,
    gather_client_batches,
)
from repro_torch.data.synthetic import (
    SyntheticClassification,
    make_federated_classification,
    synthetic_lm_batches,
)

__all__ = ["dirichlet_partition", "heterogeneity_index", "FederatedLoader",
           "BatchedFederatedLoader", "client_batch_indices", "gather_client_batches",
           "SyntheticClassification", "make_federated_classification",
           "synthetic_lm_batches"]
