"""LM layers, attention, the dense block and the decoder LM of the port."""
