"""The plain reference of the benchmark: a STARK verifier for the
GoldilocksBlake3 configuration in NumPy and Python integers, which judges
the proofs the prover under test writes.

It imports nothing of the program.  The field, FRI, Merkle, transcript and
proof-reading code is a frozen copy of the verifier's host code, with its
own BLAKE3 (`blake3.py`); the constraints and lookups are evaluated at ζ by
a plain recursive walk of the circuit author's expression trees
(`constraints.py`), never through a compiled constraint graph, and the
logUp constraints by their formula (`lookup.py`).  It computes the
verifying key, the preprocessed commitment, itself (`system.System`).  A proof it accepts proves the claims it is given, under
the circuits it is given, at the FRI parameters it is given.
"""
