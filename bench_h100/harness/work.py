"""The work a kernel or a step needs, from its shapes: the attention's
least time on the card (its roofline), and FLOPs counted on the
benchmark's own plain reference, so the count is the same whatever the
program runs in its place."""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode

from bench_h100.harness.device import PEAK_BF16_FLOPS, PEAK_BYTES, \
    PEAK_TF32_FLOPS

_ELEMENT_BYTES = {"bf16": 2, "f32": 4}


def product_seconds(flops: float, dtype: str) -> float:
    """Least seconds for `flops` of matrix products: bf16 at the dense bf16
    rate; f32 to f32 accuracy as three TF32 passes (3xTF32)."""
    if dtype == "bf16":
        return flops / PEAK_BF16_FLOPS
    return 3.0 * flops / PEAK_TF32_FLOPS


def attention_bound_s(b: int, n: int, d: int, dtype: str,
                      lse: bool = False) -> float:
    """Least seconds of one forward call out = softmax(theta phi^T) g over
    [B, N, D]: two N x N x D products a batch element against three inputs
    read and one output written once (and the f32 row logsumexp)."""
    nbytes = 4.0 * b * n * d * _ELEMENT_BYTES[dtype] + (4.0 * b * n if lse
                                                        else 0.0)
    return max(product_seconds(4.0 * b * n * n * d, dtype),
               nbytes / PEAK_BYTES)


def attention_bwd_bound_s(b: int, n: int, d: int, dtype: str) -> float:
    """Least seconds of one backward call: five N x N x D products a batch
    element; theta, phi, g, out and dout read, the logsumexp read, three
    gradients written, each once."""
    nbytes = 8.0 * b * n * d * _ELEMENT_BYTES[dtype] + 4.0 * b * n
    return max(product_seconds(10.0 * b * n * n * d, dtype),
               nbytes / PEAK_BYTES)


def op_dtype(profiler_dtype: str) -> str:
    """The profiler's name of a tensor's dtype as "bf16" or "f32"."""
    if "BFloat16" in profiler_dtype:
        return "bf16"
    if profiler_dtype == "float":
        return "f32"
    raise ValueError(f"the attention runs in bf16 or f32, not "
                     f"{profiler_dtype}")


def count_flops(fn) -> int:
    """FLOPs of the matrix products and convolutions `fn()` runs."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()
