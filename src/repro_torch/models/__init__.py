"""The LM substrate of the port: configs, layers, attention, the dense
model and the weights carried across from the JAX package."""
