"""Hashes: BLAKE3 (host half blake3_host, tensor half blake3) and Poseidon2
(host half poseidon2_host, tensor half poseidon2)."""
