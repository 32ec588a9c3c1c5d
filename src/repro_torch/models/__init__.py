"""Dense decoder models: parameters, layers, the layer stack, serving steps."""
