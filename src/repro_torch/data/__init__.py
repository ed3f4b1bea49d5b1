from repro_torch.data.keysets import leaf_keys, make_key_sets, make_tree_data
from repro_torch.data.pipeline import TokenPipeline

__all__ = ["TokenPipeline", "leaf_keys", "make_key_sets", "make_tree_data"]
