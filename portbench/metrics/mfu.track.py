"""The tracker's model and correlation FLOPs in the window over the
window's seconds times the card's bf16 dense peak (DroidNet computes in
bf16), in percent.

Counted from shapes the traced run records at the model's and the
correlation's entry points, only what these inputs need: the two
encoders a frame, the update operator for each live edge and iteration
(padded edge slots excluded), the context gates once a round, the damping
pool and the export's upsampling head, each correlation volume and
pyramid built.  Convolutions and products only (normalizations,
activations and the BA's small solves are not counted), so this is a
floor of the work done."""
from portbench.yardstick import conv_flops, peaks


def encoder_flops(H: int, W: int, out_dim: int) -> float:
    """RAFT's BasicEncoder (7x7/2 stem, three residual stages, 1x1 head)."""
    def half(n):
        return (n + 1) // 2
    h1, w1 = half(H), half(W)
    f = conv_flops(3, 32, 7, h1, w1)
    f += 4 * conv_flops(32, 32, 3, h1, w1)
    for cin, planes, (h, w) in ((32, 64, (half(h1), half(w1))),
                                (64, 128, (half(half(h1)),
                                           half(half(w1))))):
        f += conv_flops(cin, planes, 3, h, w) \
            + 3 * conv_flops(planes, planes, 3, h, w) \
            + conv_flops(cin, planes, 1, h, w)
        h_last, w_last = h, w
    return f + conv_flops(128, out_dim, 1, h_last, w_last)


def update_flops(h: int, w: int, gates: bool) -> float:
    """One edge through the update operator (ConvGRU over the hidden
    state, the correlation and motion features; delta and weight heads);
    with ``gates`` the context's part of the gates comes precomputed."""
    gin = 128 + (320 - 128 if gates else 320)
    f = conv_flops(196, 128, 1, h, w) + conv_flops(128, 128, 3, h, w)
    f += conv_flops(4, 128, 7, h, w) + conv_flops(128, 64, 3, h, w)
    f += 3 * conv_flops(gin, 128, 3, h, w) + conv_flops(128, 128, 1, h, w)
    f += 3 * conv_flops(128, 128, 1, 1, 1)
    f += 2 * (conv_flops(128, 128, 3, h, w) + conv_flops(128, 2, 3, h, w))
    return f


def call_flops(call) -> float:
    kind = call[0]
    if kind == "features":
        return encoder_flops(call[1], call[2], 128)
    if kind == "context":
        return encoder_flops(call[1], call[2], 256)
    if kind == "gates":
        _, n, h, w = call
        return n * 3 * conv_flops(128, 128, 3, h, w)
    if kind == "update":
        _, n, h, w, gates, _, _ = call
        return n * update_flops(h, w, bool(gates))
    if kind in ("eta", "aggregate"):
        _, n, k, h, w = call
        f = n * conv_flops(128, 128, 3, h, w) + k * (
            conv_flops(128, 128, 3, h, w) + conv_flops(128, 1, 3, h, w))
        if kind == "aggregate":
            f += k * conv_flops(128, 576, 1, h, w)
        return f
    if kind == "pyramid":
        _, e, c, h, w, levels = call
        return sum(2.0 * e * h * w * (h >> l) * (w >> l) * c
                   for l in range(levels))
    if kind == "volume":
        _, e, c, h, w = call
        return 2.0 * e * (h * w) ** 2 * c
    return 0.0


def read(run):
    p = peaks(run.device_name)
    if not run.model_calls or p is None:
        return None
    flops = sum(call_flops(c) for c in run.model_calls)
    return 100.0 * flops / ((run.t_close - run.t_open) * p["bf16"])
