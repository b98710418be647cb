"""The port's single-device examples (multistark_tpu_torch/examples/),
run in-process on CPU tensors: each proves and verifies with the port and
prints the needle its JAX counterpart in examples/ prints (tests/test_examples.py)."""

import importlib

import pytest

EXAMPLES = [
    ("simple_proof", "Proof size"),
    ("preprocessed_proof", "Proof size"),
    ("lookup_proof", "Wrong claim rejected"),
    ("pcs_example", "Opened value matches Horner evaluation"),
]


@pytest.mark.parametrize("name,needle", EXAMPLES, ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_cpu(name, needle, capsys):
    report = importlib.import_module(f"multistark_tpu_torch.examples.{name}").main(device="cpu")
    out = capsys.readouterr().out
    assert needle in out
    assert "Verified in" in out
    assert report["verify_s"] > 0


def test_blake3_proof_example_runs_on_cpu(capsys):
    """The BLAKE3 example (JAX examples/blake3_proof.py) on a 2-block message
    at 4-bit limbs: the 10-circuit proof verifies and a tampered digest word
    is rejected."""
    from multistark_tpu_torch.examples import blake3_proof

    report = blake3_proof.main(device="cpu", message_len=128, limb_bits=4)
    out = capsys.readouterr().out
    assert "Tampered digest rejected" in out
    assert "Verified in" in out and "2 compression claims" in out
    assert report["claims"] == 2 and report["verify_s"] > 0
