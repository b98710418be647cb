"""Field arithmetic: host scalars (host), NumPy vectors (npref), and
tensors with kernels K1 and K5 (device)."""
