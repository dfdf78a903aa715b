"""The benchmark of the PyTorch and CUDA port (`harness.py`, `run.py`)."""
