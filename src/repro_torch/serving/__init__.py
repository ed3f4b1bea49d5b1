from repro_torch.serving.bst_server import BSTServer, OpStats, ServerStats

__all__ = ["BSTServer", "OpStats", "ServerStats"]
