"""The LM substrate of the port: configs, layers, attention, the
mixture-of-experts FFN, the SSD mixer, the model of every family and the
weights carried across from the JAX package."""
