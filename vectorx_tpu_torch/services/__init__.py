from vectorx_tpu_torch.services.contract import (ContractError, MockGateway,
                                           VectorXContract, range_key)
from vectorx_tpu_torch.services.events import EventsIndexer
from vectorx_tpu_torch.services.fill_block_range import apply_fill, compute_fill
from vectorx_tpu_torch.services.genesis import compute_genesis
from vectorx_tpu_torch.services.indexer import JustificationIndexer
from vectorx_tpu_torch.services.operator import OperatorConfig, VectorXOperator
from vectorx_tpu_torch.services.prover_service import make_gateway

__all__ = [
    "ContractError", "MockGateway", "VectorXContract", "range_key",
    "EventsIndexer", "apply_fill", "compute_fill", "compute_genesis",
    "JustificationIndexer", "OperatorConfig", "VectorXOperator",
    "make_gateway",
]
