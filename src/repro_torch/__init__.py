"""PyTorch + CUDA port of the in-situ FFT system (reference: ``repro``).

Each module mirrors the file of the same path under ``src/repro/`` and
is held against it by the ``tests/test_torch_*.py`` parity tests. The
port imports ``torch`` and never ``jax`` or ``repro``. Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; on CPU
tensors the kernel wrappers take their plain PyTorch versions.
"""
