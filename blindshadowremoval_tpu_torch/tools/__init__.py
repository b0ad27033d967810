"""The port's measurement programs, one module for each program that
measures the JAX package (`bench.py` and `tools/` at the repository root).

Each runs as `python -m blindshadowremoval_tpu_torch.tools.<name>`, takes
the JAX program's arguments plus `--device {cuda,cpu}` (CUDA by default;
without a card it raises), and exposes `main(argv) -> int` and a function
that does the measuring.  Each prints what the JAX program prints, under
the same JSON keys, with one key added, `"device"`: the card's name and
power limit as nvidia-smi gives them, or "cpu".  `_timing.py` is the
harness they share.
"""
