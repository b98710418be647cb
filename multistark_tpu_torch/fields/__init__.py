"""Field arithmetic: host scalars (host), NumPy vectors (npref), and
tensors with kernel K1 (device)."""
