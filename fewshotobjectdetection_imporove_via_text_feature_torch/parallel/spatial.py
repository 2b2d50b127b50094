"""Spatial partitioning of one image's backbone (TPU.SPATIAL_PARTITION = S):
the counterpart of the JAX package's ``spatial_axis``, where GSPMD splits
the image's H axis over S devices inside ``jit`` and inserts the
convolutions' halo exchanges itself.

Here the same is written out. The padded image is cut into S row bands
(``band_rows``), band i on ``devices[i]``. The ResNet C4 backbone runs
through res4 band by band: before every layer that reads neighbouring rows
(the stem's 7x7/2 convolution, its 3x3/2 max-pool, every bottleneck's 3x3
``conv2``) each band takes the rows it needs from the bands above and below
(``halo_input``) and the layer runs with H padding 0; 1x1 convolutions, the
shortcut, FrozenBN, relu and the residual add run on each band alone. res4
is then gathered onto ``devices[0]``, where the RPN and the ROI heads run
unsplit. Serving only: training and evaluation refuse the option.

``HALO`` counts what the exchanges did, for tests and the card's smoke run.
"""

from __future__ import annotations

import copy
import weakref
from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F

# The C4 backbone's output stride: bands start on multiples of it, so every
# stride-2 layer up to res4 sees band edges on even rows and the bands'
# outputs tile the unsplit output.
STRIDE = 16


@dataclass
class HaloStats:
    """What the banded backbone did since ``reset()``: halo exchanges (one
    a band and a side, at every halo layer), the rows and bytes they moved
    (counted also where both bands share a device), the tallest input and
    the most rows beyond its own band any banded layer ran on, halo-layer
    passes, res4 gathers and the halo-layer passes made before the last
    gather."""

    exchanges: int = 0
    rows: int = 0
    bytes: int = 0
    max_input_rows: int = 0
    max_extra_rows: int = 0
    halo_layers: int = 0
    gathers: int = 0
    halo_layers_at_gather: int = 0

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, f.default)


HALO = HaloStats()


def band_rows(height: int, bands: int):
    """S row ranges [(start, end), ...] of a padded image of ``height`` rows:
    each band starts on a multiple of ``STRIDE``, the res4 rows are shared
    out as evenly as they go (the first bands take one more), the last band
    ends at ``height``. Raises ``ValueError`` when there are fewer res4 rows
    than bands."""
    rows = -(-height // STRIDE)
    if bands > rows:
        raise ValueError(
            f"TPU.SPATIAL_PARTITION {bands}: an image of {height} rows has "
            f"{rows} res4 rows, fewer than the bands")
    base, extra = divmod(rows, bands)
    out, start = [], 0
    for i in range(bands):
        end = start + base + (i < extra)
        out.append((start * STRIDE, min(end * STRIDE, height)))
        start = end
    return out


def out_rows(rows, height: int, kernel: int, stride: int, padding: int,
             dilation: int = 1):
    """The bands' row ranges after a layer, and the layer's output height:
    a band starting at input row r0 starts at output row r0 / stride."""
    span = dilation * (kernel - 1) + 1
    out_h = (height + 2 * padding - span) // stride + 1
    new = []
    for i, (r0, r1) in enumerate(rows):
        last = i == len(rows) - 1
        if r0 % stride or (not last and r1 % stride):
            raise ValueError(f"band rows {(r0, r1)} are not on the layer's "
                             f"stride {stride}")
        new.append((r0 // stride, out_h if last else r1 // stride))
    return new, out_h


def _take(xs, rows, j, a, b, device):
    """Rows [a, b) of band j, on ``device``; counted in ``HALO``."""
    r0, r1 = rows[j]
    if not r0 <= a < b <= r1:
        raise ValueError(f"halo rows {(a, b)} are not all in the "
                         f"neighbouring band {(r0, r1)}")
    part = xs[j][:, :, a - r0:b - r0]
    HALO.exchanges += 1
    HALO.rows += b - a
    HALO.bytes += part.numel() * part.element_size()
    return part.to(device)


def halo_input(xs, rows, height: int, kernel: int, stride: int,
               padding: int, dilation: int = 1, fill: float = 0.0):
    """Each band's input to a layer (kernel, stride, H padding, dilation)
    that then runs with H padding 0: the input rows its output rows read,
    its own and those of the neighbouring bands, with ``fill`` rows beyond
    the image's edges as the unsplit layer's padding. Returns those inputs,
    the bands' output rows and the layer's output height."""
    span = dilation * (kernel - 1) + 1
    new, out_h = out_rows(rows, height, kernel, stride, padding, dilation)
    out = []
    for i, ((r0, r1), (o0, o1)) in enumerate(zip(rows, new)):
        x = xs[i]
        lo = o0 * stride - padding
        hi = (o1 - 1) * stride - padding + span
        parts = []
        if lo < 0:
            parts.append(x.new_full((*x.shape[:2], -lo, x.shape[3]), fill))
        if max(lo, 0) < r0:
            parts.append(_take(xs, rows, i - 1, max(lo, 0), r0, x.device))
        parts.append(x[:, :, max(lo, r0) - r0:min(hi, r1) - r0])
        if r1 < min(hi, height):
            parts.append(_take(xs, rows, i + 1, r1, min(hi, height),
                               x.device))
        if hi > height:
            parts.append(x.new_full((*x.shape[:2], hi - height, x.shape[3]),
                                    fill))
        inp = torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]
        HALO.max_input_rows = max(HALO.max_input_rows, inp.shape[2])
        HALO.max_extra_rows = max(HALO.max_extra_rows,
                                  inp.shape[2] - (r1 - r0))
        out.append(inp)
    HALO.halo_layers += 1
    return out, new, out_h


def _conv_rows(conv, x):
    """``backbone.Conv2d`` (with its norm) on rows that carry their halo:
    H padding 0, its own W padding."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                 (0, conv.padding[1]), conv.dilation, conv.groups)
    return y if conv.norm is None else conv.norm(y)


def _conv_geometry(conv):
    return (conv.kernel_size[0], conv.stride[0], conv.padding[0],
            conv.dilation[0])


def _banded_conv(convs, xs, rows, height):
    """A k x k ``Conv2d`` + norm + relu over the bands: halo, then each
    band's convolution with its own band's copy of the layer."""
    ins, new, out_h = halo_input(xs, rows, height,
                                 *_conv_geometry(convs[0]))
    return [F.relu(_conv_rows(c, x)) for c, x in zip(convs, ins)], new, out_h


def _check_rows(xs, rows):
    for x, (r0, r1) in zip(xs, rows):
        if x.shape[2] != r1 - r0:
            raise RuntimeError(f"a band of {x.shape[2]} rows, its plan "
                               f"{(r0, r1)}")


def _device_key(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# backbone -> {device: its copy there}, made once per device
_COPIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def band_modules(backbone, devices):
    """The backbone each band runs: ``backbone`` itself on its own device,
    a copy on every other device, made at the first call and kept (weights
    loaded into ``backbone`` after that do not reach the copies)."""
    home = _device_key(next(backbone.parameters()).device)
    copies = _COPIES.setdefault(backbone, {})
    out = []
    for dev in map(_device_key, devices):
        if dev == home:
            out.append(backbone)
            continue
        if dev not in copies:
            copies[dev] = copy.deepcopy(backbone).to(dev)
        out.append(copies[dev])
    return out


def banded_backbone(backbone, x, devices):
    """``backbone`` (a ``models.backbone.ResNetC4``) on ``x`` (B, 3, H, W)
    split into ``len(devices)`` row bands, band i on ``devices[i]``, in
    ``backbone.dtype``. Returns res4 (B, C, ceil(H / 16), W / 16) gathered
    on ``devices[0]``; res2 and res3 stay banded and are not returned.
    Raises when autograd is enabled: spatial partitioning serves only."""
    if torch.is_grad_enabled():
        raise RuntimeError("TPU.SPATIAL_PARTITION applies to "
                           "DefaultPredictor serving only; run it under "
                           "torch.inference_mode() or torch.no_grad()")
    mods = band_modules(backbone, devices)
    height = x.shape[2]
    rows = band_rows(height, len(devices))
    x = x.to(backbone.dtype)
    xs = [x[:, :, r0:r1].to(dev) for (r0, r1), dev in zip(rows, devices)]

    # stem: 7x7/2 convolution + FrozenBN + relu, 3x3/2 max-pool (-inf pads)
    xs, rows, height = _banded_conv([m.stem.conv1 for m in mods], xs, rows,
                                    height)
    ins, rows, height = halo_input(xs, rows, height, 3, 2, 1,
                                   fill=float("-inf"))
    xs = [F.max_pool2d(x, 3, 2, padding=(0, 1)) for x in ins]
    _check_rows(xs, rows)

    for name in backbone.stage_names:
        for j in range(len(getattr(backbone, name))):
            blocks = [getattr(m, name)[j] for m in mods]
            conv1 = blocks[0].conv1
            h = [F.relu(b.conv1(x)) for b, x in zip(blocks, xs)]
            hrows, hheight = out_rows(rows, height,
                                      *_conv_geometry(conv1))
            _check_rows(h, hrows)
            h, hrows, hheight = _banded_conv([b.conv2 for b in blocks], h,
                                             hrows, hheight)
            xs = [F.relu(b.conv3(o) + (x if b.shortcut is None
                                       else b.shortcut(x)))
                  for b, o, x in zip(blocks, h, xs)]
            rows, height = hrows, hheight
            _check_rows(xs, rows)

    out = torch.cat([x.to(devices[0]) for x in xs], dim=2)
    HALO.gathers += 1
    HALO.halo_layers_at_gather = HALO.halo_layers
    return out
