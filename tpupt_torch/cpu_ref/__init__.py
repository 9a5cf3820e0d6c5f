"""The brute-force reference renderer (the correctness oracle)."""
