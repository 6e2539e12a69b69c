from .data_loader import load  # noqa: F401
from .federated_dataset import FederatedDataset, build_federated  # noqa: F401
