"""Plain PyTorch and NumPy references: the same semantics as the port,
written independently of it. Nothing here imports the port, JAX or the
JAX package, and nothing takes what the port derived: weights come from
`portbench.weights` (the benchmark's own inputs), texts from the traffic.
"""
