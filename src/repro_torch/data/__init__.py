from repro_torch.data.keysets import leaf_keys, make_key_sets, make_tree_data

__all__ = ["leaf_keys", "make_key_sets", "make_tree_data"]
