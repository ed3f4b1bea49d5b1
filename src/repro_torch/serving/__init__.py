from repro_torch.serving.bst_server import WRITE_OPS, BSTServer, OpStats, ServerStats

__all__ = ["BSTServer", "OpStats", "ServerStats", "WRITE_OPS"]
