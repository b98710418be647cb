"""BLAKE3: host (blake3_host) and tensor (blake3) halves."""
