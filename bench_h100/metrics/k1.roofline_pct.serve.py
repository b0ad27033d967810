"""K1's share of its roofline over the traced window: the least time the
card needs for every forward attention call the window made (from each
`bsr::nonlocal_attn*` op's shapes and dtype), over the device time of
K1's kernels."""

from bench_h100.harness import work

LAYER = "kernel K1 (ops/nonlocal_attn.py, csrc/nonlocal_attn.cu)"
UNIT = "%"
MOVES = "faces_per_s"
KERNELS = ("attn_fwd", "fwd_combine")
OPS = {"bsr::nonlocal_attn": False, "bsr::nonlocal_attn_lse": True}


def read(run):
    bound = 0.0
    for name, shapes, dtypes in run.trace.ops:
        if name in OPS:
            b, n, d = shapes[0]
            bound += work.attention_bound_s(b, n, d, work.op_dtype(dtypes[0]),
                                            lse=OPS[name])
    seconds = run.trace.kernel_seconds(KERNELS)
    if not bound or not seconds:
        return None
    return 100.0 * bound / seconds
