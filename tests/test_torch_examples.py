"""The port's four single-device examples (multistark_tpu_torch/examples/),
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
