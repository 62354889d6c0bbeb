"""Hand-written Hopper kernels of the port, their oracles and dispatch."""
