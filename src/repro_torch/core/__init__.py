"""The port's core: configs, device helpers, trees, and the BPT trainer's
two layers (the local step, the outer layer's engines, merges and server)."""
