"""The LM substrate of the port: configs, layers, attention, the
mixture-of-experts FFN, the dense and moe model and the weights carried
across from the JAX package."""
