from repro_torch.sharding import specs

__all__ = ["specs"]
