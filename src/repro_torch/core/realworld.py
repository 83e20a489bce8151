"""Real-world neural-architecture builders (paper Appendix A analogue).

The paper evaluates on 102 NAs from 25 papers.  We implement compact,
faithful-in-structure builders for 14 families (×width multipliers →
~40 architectures), covering the op diversity the paper highlights:
plain conv stacks, depthwise-separable stacks, inverted residuals with
SE, residual adds, fire modules, channel shuffle + split/concat, dense
concatenation, and grouped convolutions.

These architectures have a *different op-parameter distribution* than
the synthetic NAS space (smaller channel counts per paper Fig. 17) —
the §5.3 dataset-shift evaluation relies on that.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.ir import OpGraph
from repro_torch.utils.registry import Registry

REALWORLD = Registry("realworld_arch")


def _c(ch: float, mult: float, divisor: int = 4) -> int:
    v = max(divisor, int(ch * mult + divisor / 2) // divisor * divisor)
    return v


def _cdiv(a: int, b: int) -> int:
    return max(1, (a + b - 1) // b)


class _B:
    """Small builder helper around OpGraph for NHWC conv nets."""

    def __init__(self, name: str, resolution: int):
        self.g = OpGraph(name)
        self.x = self.g.add_input((1, resolution, resolution, 3))

    def shape(self, t: Optional[int] = None) -> Tuple[int, ...]:
        return self.g.tensor(self.x if t is None else t).shape

    def conv(self, t: int, out_c: int, k: int = 3, s: int = 1, groups: int = 1,
             act: Optional[str] = "relu") -> int:
        b, h, w, _ = self.g.tensor(t).shape
        op = "grouped_conv2d" if groups > 1 else "conv2d"
        (y,) = self.g.add_op(
            op, [t], [(b, _cdiv(h, s), _cdiv(w, s), out_c)],
            {"kernel_h": k, "kernel_w": k, "stride": s, "groups": groups,
             "act": act if act in ("relu", "relu6", None) else None},
        )
        if act and act not in ("relu", "relu6"):
            (y,) = self.g.add_op("activation", [y], [self.g.tensor(y).shape], {"act": act})
        return y

    def dwconv(self, t: int, k: int = 3, s: int = 1, act: Optional[str] = "relu") -> int:
        b, h, w, c = self.g.tensor(t).shape
        (y,) = self.g.add_op(
            "dwconv2d", [t], [(b, _cdiv(h, s), _cdiv(w, s), c)],
            {"kernel_h": k, "kernel_w": k, "stride": s,
             "act": act if act in ("relu", "relu6", None) else None},
        )
        if act and act not in ("relu", "relu6"):
            (y,) = self.g.add_op("activation", [y], [self.g.tensor(y).shape], {"act": act})
        return y

    def add(self, a: int, b: int) -> int:
        (y,) = self.g.add_op("elementwise", [a, b], [self.g.tensor(a).shape],
                             {"ew_kind": "add"})
        return y

    def mul(self, a: int, b: int) -> int:
        (y,) = self.g.add_op("elementwise", [a, b], [self.g.tensor(a).shape],
                             {"ew_kind": "mul"})
        return y

    def pool(self, t: int, kind: str = "max", k: int = 3, s: int = 2) -> int:
        b, h, w, c = self.g.tensor(t).shape
        (y,) = self.g.add_op(f"pool_{kind}", [t], [(b, _cdiv(h, s), _cdiv(w, s), c)],
                             {"kernel_h": k, "kernel_w": k, "stride": s})
        return y

    def se(self, t: int, reduction: int = 4) -> int:
        b, h, w, c = self.g.tensor(t).shape
        mid = max(4, c // reduction)
        (s,) = self.g.add_op("mean", [t], [(b, c)], {"kernel_h": h, "kernel_w": w})
        (s,) = self.g.add_op("fully_connected", [s], [(b, mid)], {"act": "relu"})
        (s,) = self.g.add_op("fully_connected", [s], [(b, c)], {})
        (s,) = self.g.add_op("activation", [s], [(b, c)], {"act": "sigmoid"})
        return self.mul(t, s)

    def concat(self, ts: List[int]) -> int:
        b, h, w, _ = self.g.tensor(ts[0]).shape
        c = sum(self.g.tensor(t).shape[-1] for t in ts)
        (y,) = self.g.add_op("concat", ts, [(b, h, w, c)], {"axis": -1})
        return y

    def split(self, t: int, n: int) -> List[int]:
        b, h, w, c = self.g.tensor(t).shape
        return self.g.add_op("split", [t], [(b, h, w, c // n)] * n,
                             {"num_splits": n, "axis": -1})

    def shuffle(self, t: int, groups: int = 2) -> int:
        (y,) = self.g.add_op("channel_shuffle", [t], [self.g.tensor(t).shape],
                             {"groups": groups})
        return y

    def head(self, t: int, classes: int = 1000) -> OpGraph:
        b, h, w, c = self.g.tensor(t).shape
        (y,) = self.g.add_op("mean", [t], [(b, c)], {"kernel_h": h, "kernel_w": w})
        (y,) = self.g.add_op("fully_connected", [y], [(b, classes)], {})
        self.g.mark_output(y)
        self.g.validate()
        return self.g


# ---------------------------------------------------------------------------
# Families.  Channel plans follow the original papers, spatially scaled to
# the profiling resolution (stage strides preserved).
# ---------------------------------------------------------------------------

@REALWORLD.register("mobilenet_v1")
def mobilenet_v1(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"mobilenet_v1_x{mult}", resolution)
    x = b.conv(b.x, _c(32, mult), 3, 2)
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (1024, 2)]
    for ch, s in plan:
        x = b.dwconv(x, 3, s)
        x = b.conv(x, _c(ch, mult), 1, 1)
    return b.head(x)


@REALWORLD.register("mobilenet_v2")
def mobilenet_v2(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"mobilenet_v2_x{mult}", resolution)
    x = b.conv(b.x, _c(32, mult), 3, 2, act="relu6")

    def inverted(x, out_c, s, expand):
        in_c = b.shape(x)[-1]
        h = b.conv(x, in_c * expand, 1, 1, act="relu6") if expand > 1 else x
        h = b.dwconv(h, 3, s, act="relu6")
        h = b.conv(h, out_c, 1, 1, act=None)
        if s == 1 and out_c == in_c:
            h = b.add(h, x)
        return h

    plan = [(16, 1, 1), (24, 2, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6),
            (64, 2, 6), (64, 1, 6), (96, 1, 6), (160, 2, 6), (160, 1, 6),
            (320, 1, 6)]
    for ch, s, e in plan:
        x = inverted(x, _c(ch, mult), s, e)
    x = b.conv(x, _c(1280, max(1.0, mult)), 1, 1, act="relu6")
    return b.head(x)


@REALWORLD.register("mobilenet_v3_small")
def mobilenet_v3_small(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"mobilenet_v3s_x{mult}", resolution)
    x = b.conv(b.x, _c(16, mult), 3, 2, act="hswish")

    def block(x, k, exp, out_c, use_se, act, s):
        in_c = b.shape(x)[-1]
        h = b.conv(x, _c(exp, mult), 1, 1, act=act) if exp != in_c else x
        h = b.dwconv(h, k, s, act=act)
        if use_se:
            h = b.se(h)
        h = b.conv(h, out_c, 1, 1, act=None)
        if s == 1 and out_c == in_c:
            h = b.add(h, x)
        return h

    plan = [(3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
            (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hswish", 2),
            (5, 240, 40, True, "hswish", 1), (5, 120, 48, True, "hswish", 1),
            (5, 288, 96, True, "hswish", 2), (5, 576, 96, True, "hswish", 1)]
    for k, exp, out, se, act, s in plan:
        x = block(x, k, exp, _c(out, mult), se, act, s)
    x = b.conv(x, _c(576, mult), 1, 1, act="hswish")
    return b.head(x)


@REALWORLD.register("resnet18")
def resnet18(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"resnet18_x{mult}", resolution)
    x = b.conv(b.x, _c(64, mult), 7, 2)
    x = b.pool(x, "max", 3, 2)

    def basic(x, out_c, s):
        in_c = b.shape(x)[-1]
        h = b.conv(x, out_c, 3, s)
        h = b.conv(h, out_c, 3, 1, act=None)
        sc = b.conv(x, out_c, 1, s, act=None) if (s != 1 or out_c != in_c) else x
        return b.add(h, sc)

    for out_c, blocks, s in [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]:
        for i in range(blocks):
            x = basic(x, _c(out_c, mult), s if i == 0 else 1)
    return b.head(x)


@REALWORLD.register("resnet34")
def resnet34(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"resnet34_x{mult}", resolution)
    x = b.conv(b.x, _c(64, mult), 7, 2)
    x = b.pool(x, "max", 3, 2)

    def basic(x, out_c, s):
        in_c = b.shape(x)[-1]
        h = b.conv(x, out_c, 3, s)
        h = b.conv(h, out_c, 3, 1, act=None)
        sc = b.conv(x, out_c, 1, s, act=None) if (s != 1 or out_c != in_c) else x
        return b.add(h, sc)

    for out_c, blocks, s in [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]:
        for i in range(blocks):
            x = basic(x, _c(out_c, mult), s if i == 0 else 1)
    return b.head(x)


@REALWORLD.register("squeezenet")
def squeezenet(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"squeezenet_x{mult}", resolution)
    x = b.conv(b.x, _c(96, mult), 7, 2)
    x = b.pool(x, "max", 3, 2)

    def fire(x, squeeze, expand):
        s = b.conv(x, _c(squeeze, mult), 1, 1)
        e1 = b.conv(s, _c(expand, mult), 1, 1)
        e3 = b.conv(s, _c(expand, mult), 3, 1)
        return b.concat([e1, e3])

    x = fire(x, 16, 64)
    x = fire(x, 16, 64)
    x = fire(x, 32, 128)
    x = b.pool(x, "max", 3, 2)
    x = fire(x, 32, 128)
    x = fire(x, 48, 192)
    x = fire(x, 48, 192)
    x = fire(x, 64, 256)
    x = b.pool(x, "max", 3, 2)
    x = fire(x, 64, 256)
    x = b.conv(x, 1000, 1, 1)
    return b.head(x)


@REALWORLD.register("shufflenet_v2")
def shufflenet_v2(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"shufflenet_v2_x{mult}", resolution)
    x = b.conv(b.x, _c(24, 1.0), 3, 2)
    x = b.pool(x, "max", 3, 2)

    def unit(x, out_c, s):
        if s == 1:
            l, r = b.split(x, 2)
            c = b.shape(r)[-1]
            r = b.conv(r, c, 1, 1)
            r = b.dwconv(r, 3, 1, act=None)
            r = b.conv(r, c, 1, 1)
            y = b.concat([l, r])
        else:
            c = out_c // 2
            l = b.dwconv(x, 3, 2, act=None)
            l = b.conv(l, c, 1, 1)
            r = b.conv(x, c, 1, 1)
            r = b.dwconv(r, 3, 2, act=None)
            r = b.conv(r, c, 1, 1)
            y = b.concat([l, r])
        return b.shuffle(y, 2)

    for out_c, blocks in [(_c(116, mult), 4), (_c(232, mult), 8), (_c(464, mult), 4)]:
        x = unit(x, out_c, 2)
        for _ in range(blocks - 1):
            x = unit(x, out_c, 1)
    x = b.conv(x, _c(1024, mult), 1, 1)
    return b.head(x)


@REALWORLD.register("efficientnet_b0")
def efficientnet_b0(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"efficientnet_b0_x{mult}", resolution)
    x = b.conv(b.x, _c(32, mult), 3, 2, act="swish")

    def mbconv(x, k, out_c, s, expand):
        in_c = b.shape(x)[-1]
        h = b.conv(x, in_c * expand, 1, 1, act="swish") if expand > 1 else x
        h = b.dwconv(h, k, s, act="swish")
        h = b.se(h)
        h = b.conv(h, out_c, 1, 1, act=None)
        if s == 1 and out_c == in_c:
            h = b.add(h, x)
        return h

    plan = [(3, 16, 1, 1, 1), (3, 24, 2, 6, 2), (5, 40, 2, 6, 2),
            (3, 80, 2, 6, 3), (5, 112, 1, 6, 3), (5, 192, 2, 6, 4),
            (3, 320, 1, 6, 1)]
    for k, ch, s, e, reps in plan:
        for i in range(reps):
            x = mbconv(x, k, _c(ch, mult), s if i == 0 else 1, e)
    x = b.conv(x, _c(1280, mult), 1, 1, act="swish")
    return b.head(x)


@REALWORLD.register("mnasnet")
def mnasnet(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"mnasnet_x{mult}", resolution)
    x = b.conv(b.x, _c(32, mult), 3, 2)
    x = b.dwconv(x, 3, 1)
    x = b.conv(x, _c(16, mult), 1, 1, act=None)

    def mb(x, k, out_c, s, expand, use_se=False):
        in_c = b.shape(x)[-1]
        h = b.conv(x, in_c * expand, 1, 1)
        h = b.dwconv(h, k, s)
        if use_se:
            h = b.se(h)
        h = b.conv(h, out_c, 1, 1, act=None)
        if s == 1 and out_c == in_c:
            h = b.add(h, x)
        return h

    plan = [(3, 24, 2, 6, False, 2), (5, 40, 2, 3, True, 3),
            (3, 80, 2, 6, False, 4), (3, 112, 1, 6, True, 2),
            (5, 160, 2, 6, True, 3), (3, 320, 1, 6, False, 1)]
    for k, ch, s, e, se, reps in plan:
        for i in range(reps):
            x = mb(x, k, _c(ch, mult), s if i == 0 else 1, e, se)
    x = b.conv(x, _c(1280, mult), 1, 1)
    return b.head(x)


@REALWORLD.register("fd_mobilenet")
def fd_mobilenet(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    """Fast-downsampling MobileNet: all strides early."""
    b = _B(f"fd_mobilenet_x{mult}", resolution)
    x = b.conv(b.x, _c(32, mult), 3, 2)
    x = b.pool(x, "max", 3, 2)
    plan = [(64, 2), (128, 2), (256, 1), (512, 1), (512, 1), (512, 1),
            (1024, 1)]
    for ch, s in plan:
        x = b.dwconv(x, 3, s)
        x = b.conv(x, _c(ch, mult), 1, 1)
    return b.head(x)


@REALWORLD.register("ghostnet")
def ghostnet(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    """Ghost modules: half the features from cheap depthwise ops."""
    b = _B(f"ghostnet_x{mult}", resolution)
    x = b.conv(b.x, _c(16, mult), 3, 2)

    def ghost(x, out_c):
        prim = b.conv(x, out_c // 2, 1, 1)
        cheap = b.dwconv(prim, 3, 1)
        return b.concat([prim, cheap])

    def bottleneck(x, mid_c, out_c, s, use_se=False):
        in_c = b.shape(x)[-1]
        h = ghost(x, _c(mid_c, mult))
        if s == 2:
            h = b.dwconv(h, 3, 2, act=None)
        if use_se:
            h = b.se(h)
        h = ghost(h, out_c) if out_c % 2 == 0 else b.conv(h, out_c, 1, 1)
        if s == 1 and out_c == in_c:
            h = b.add(h, x)
        return h

    plan = [(16, 16, 1, False), (48, 24, 2, False), (72, 24, 1, False),
            (72, 40, 2, True), (120, 40, 1, True), (240, 80, 2, False),
            (200, 80, 1, False), (480, 112, 1, True), (672, 160, 2, True)]
    for mid, out, s, se in plan:
        x = bottleneck(x, mid, _c(out, mult), s, se)
    x = b.conv(x, _c(960, mult), 1, 1)
    return b.head(x)


@REALWORLD.register("densenet_lite")
def densenet_lite(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"densenet_lite_x{mult}", resolution)
    growth = _c(32, mult)
    x = b.conv(b.x, 2 * growth, 7, 2)
    x = b.pool(x, "max", 3, 2)
    for stage, layers in enumerate([4, 8, 6]):
        feats = [x]
        for _ in range(layers):
            inp = b.concat(feats) if len(feats) > 1 else feats[0]
            h = b.conv(inp, 4 * growth, 1, 1)
            h = b.conv(h, growth, 3, 1)
            feats.append(h)
        x = b.concat(feats)
        if stage < 2:  # transition
            x = b.conv(x, b.shape(x)[-1] // 2, 1, 1)
            x = b.pool(x, "avg", 2, 2)
    return b.head(x)


@REALWORLD.register("regnetx")
def regnetx(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    """RegNetX: residual bottlenecks with GROUPED 3×3 convs (Fig. 9's star)."""
    b = _B(f"regnetx_x{mult}", resolution)
    x = b.conv(b.x, _c(32, mult), 3, 2)

    def xblock(x, out_c, s, group_w):
        in_c = b.shape(x)[-1]
        groups = max(1, out_c // group_w)
        while out_c % groups != 0 or groups < 1:
            groups -= 1
        h = b.conv(x, out_c, 1, 1)
        h = b.conv(h, out_c, 3, s, groups=max(1, groups))
        h = b.conv(h, out_c, 1, 1, act=None)
        sc = b.conv(x, out_c, 1, s, act=None) if (s != 1 or out_c != in_c) else x
        return b.add(h, sc)

    for out_c, blocks, s in [(_c(64, mult), 1, 1), (_c(128, mult), 2, 2),
                             (_c(288, mult), 4, 2), (_c(672, mult), 2, 2)]:
        for i in range(blocks):
            x = xblock(x, out_c, s if i == 0 else 1, 16)
    return b.head(x)


@REALWORLD.register("proxyless_mobile")
def proxyless_mobile(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"proxyless_x{mult}", resolution)
    x = b.conv(b.x, _c(32, mult), 3, 2, act="relu6")

    def mb(x, k, out_c, s, expand):
        in_c = b.shape(x)[-1]
        h = b.conv(x, in_c * expand, 1, 1, act="relu6") if expand > 1 else x
        h = b.dwconv(h, k, s, act="relu6")
        h = b.conv(h, out_c, 1, 1, act=None)
        if s == 1 and out_c == in_c:
            h = b.add(h, x)
        return h

    plan = [(3, 16, 1, 1), (5, 24, 2, 3), (3, 24, 1, 3), (7, 40, 2, 3),
            (3, 40, 1, 3), (7, 80, 2, 6), (5, 80, 1, 3), (5, 96, 1, 6),
            (7, 192, 2, 6), (7, 192, 1, 6), (7, 320, 1, 6)]
    for k, ch, s, e in plan:
        x = mb(x, k, _c(ch, mult), s, e)
    x = b.conv(x, _c(1280, mult), 1, 1, act="relu6")
    return b.head(x)


@REALWORLD.register("peleenet_lite")
def peleenet_lite(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"peleenet_x{mult}", resolution)
    # Stem with 2-way dense connectivity.
    x = b.conv(b.x, _c(32, mult), 3, 2)
    l = b.conv(x, _c(16, mult), 1, 1)
    l = b.conv(l, _c(32, mult), 3, 2)
    r = b.pool(x, "max", 2, 2)
    x = b.concat([l, r])
    x = b.conv(x, _c(32, mult), 1, 1)

    def dense_block(x, growth, layers):
        for _ in range(layers):
            a = b.conv(x, growth * 2, 1, 1)
            a = b.conv(a, growth // 2, 3, 1)
            c = b.conv(x, growth * 2, 1, 1)
            c = b.conv(c, growth // 2, 3, 1)
            c = b.conv(c, growth // 2, 3, 1)
            x = b.concat([x, a, c])
        return x

    growth = _c(16, mult)
    for layers, s in [(2, True), (3, True), (4, False)]:
        x = dense_block(x, growth, layers)
        x = b.conv(x, b.shape(x)[-1], 1, 1)
        if s:
            x = b.pool(x, "avg", 2, 2)
    return b.head(x)


@REALWORLD.register("vovnet_lite")
def vovnet_lite(mult: float = 1.0, resolution: int = 32) -> OpGraph:
    b = _B(f"vovnet_x{mult}", resolution)
    x = b.conv(b.x, _c(64, mult), 3, 2)
    x = b.conv(x, _c(64, mult), 3, 1)

    def osa(x, mid, out, layers=3):
        feats = [x]
        h = x
        for _ in range(layers):
            h = b.conv(h, mid, 3, 1)
            feats.append(h)
        y = b.concat(feats)
        return b.conv(y, out, 1, 1)

    for mid, out, s in [(_c(64, mult), _c(128, mult), True),
                        (_c(80, mult), _c(256, mult), True),
                        (_c(96, mult), _c(384, mult), False)]:
        x = osa(x, mid, out)
        if s:
            x = b.pool(x, "max", 3, 2)
    return b.head(x)


DEFAULT_MULTIPLIERS: Dict[str, Tuple[float, ...]] = {
    "mobilenet_v1": (0.5, 0.75, 1.0),
    "mobilenet_v2": (0.5, 0.75, 1.0),
    "mobilenet_v3_small": (0.75, 1.0),
    "resnet18": (0.25, 0.5, 1.0),
    "resnet34": (0.25, 0.5),
    "squeezenet": (0.75, 1.0),
    "shufflenet_v2": (0.5, 1.0, 1.5),
    "efficientnet_b0": (0.5, 1.0),
    "mnasnet": (0.5, 0.75, 1.0),
    "fd_mobilenet": (0.5, 1.0),
    "ghostnet": (0.75, 1.0, 1.3),
    "densenet_lite": (0.5, 1.0),
    "regnetx": (0.5, 1.0),
    "proxyless_mobile": (0.75, 1.0),
    "peleenet_lite": (1.0,),
    "vovnet_lite": (0.75, 1.0),
}


def build_realworld_suite(resolution: int = 32,
                          multipliers: Optional[Dict[str, Tuple[float, ...]]] = None
                          ) -> List[OpGraph]:
    """All real-world architectures × width multipliers (~40 graphs)."""
    multipliers = multipliers or DEFAULT_MULTIPLIERS
    graphs = []
    for name, fn in REALWORLD.items():
        for mult in multipliers.get(name, (1.0,)):
            graphs.append(fn(mult, resolution))
    return graphs
