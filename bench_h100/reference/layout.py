"""The generator's parameters as the published model lays them out (the
reference repository's `model.py` and `model_with_TSM.py`), from the
configuration file's widths alone: every name, in the unfolded state-dict
names that the program's checkpoints use, with its shape, in one fixed
order.

The benchmark draws its weights from this list and checks the program's
own layout against it, so a width that the program narrows or widens fails
set-up instead of changing the reference with it.
"""

from __future__ import annotations

BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def generator_layout(config: dict) -> tuple[list[tuple[str, tuple]],
                                            set[str]]:
    """([(name, shape)] of every f32 parameter and BatchNorm statistic of
    the configuration's generator, the names of its transposed
    convolutions' kernels ([in, out, 3, 3]))."""
    c = config["channels"]                  # model.py:201
    res = config["bottleneck_channels"]     # the residual blocks' width
    inner = config["res_inner_channels"]    # their 1x1 -> 3x3 -> 1x1 middle
    head_dim = config["attention"]["head_dim"]
    clr = config["clr_channels"]
    uv = config["uv_channels"]
    # a ShareLayer adds `share_width` channels a feature channel (its max
    # and its mean) at both bottleneck concats; GSC has none
    k = 1 + config.get("share_width", 0)
    n_res = config["n_res"]
    entries: list[tuple[str, tuple]] = []
    transposed: set[str] = set()

    def conv(name, cin, cout, ksize):
        entries.extend([(f"{name}.weight", (cout, cin, ksize, ksize)),
                        (f"{name}.bias", (cout,))])

    def bn(name, ch):
        entries.extend((f"{name}.{leaf}", (ch,)) for leaf in BN_LEAVES)

    def block(name, cin, cout, ksize=3, norm=True):
        conv(f"{name}.conv", cin, cout, ksize)
        if norm:
            bn(f"{name}.bn", cout)

    def up(name, cin, cout):
        entries.extend([(f"{name}.conv.weight", (cin, cout, 3, 3)),
                        (f"{name}.conv.bias", (cout,))])
        transposed.add(f"{name}.conv.weight")
        bn(f"{name}.bn", cout)

    def res_block(name, cin):
        conv(f"{name}.conv1", cin, inner, 1)
        bn(f"{name}.bn1", inner)
        conv(f"{name}.conv2", inner, inner, 3)
        bn(f"{name}.bn2", inner)
        conv(f"{name}.conv3", inner, res, 1)
        bn(f"{name}.bn3", res)
        for m in ("g", "phi", "theta"):
            conv(f"{name}.non_local.{m}", res, head_dim, 1)
        conv(f"{name}.non_local.w", head_dim, res, 1)
        bn(f"{name}.non_local.bn", res)

    block("conv1", 3, c[0], 7)
    block("down1", c[0], c[1])
    block("down2", c[1], c[2])
    block("down3", c[2], c[3])
    # the bottleneck: the encoder's features (and their shared statistics)
    # and the UV map; a residual block pads the narrower of its input and
    # its branch, so each half keeps the wider of its input and `res`.
    # The RGB half takes the gated features (and theirs), the gate, the UV
    shared_in = c[3] * k + uv
    shared_out = max(shared_in, res)
    rgb_in = shared_out * k + 1 + uv
    rgb_out = max(rgb_in, res)
    half = n_res // 2
    for i in range(n_res):
        if i < half:
            res_block(f"res.{i}", shared_in if i == 0 else shared_out)
        else:
            res_block(f"res.{i}", rgb_in if i == half else rgb_out)
    up("up1", shared_out, c[3])
    up("up2", c[3] + c[2], c[2])
    up("up3", c[2] + c[1], c[1])
    block("head", c[1], 2, 7, norm=False)       # the tanh gain and offset
    up("clr_up1", rgb_out, c[4])
    up("clr_up2", c[4], c[3])
    up("clr_up3", c[3], c[2])
    block("clr_conv1", 1 + c[2], clr, 3)
    block("clr_conv2", clr, clr, 1)
    block("clr_conv3", clr, 3, 1, norm=False)
    return entries, transposed


def bn_counters(entries: list[tuple[str, tuple]]) -> list[str]:
    """The BatchNorm step counters that go with the layout's statistics."""
    return [n[:-len("running_mean")] + "num_batches_tracked"
            for n, _ in entries if n.endswith(".running_mean")]
