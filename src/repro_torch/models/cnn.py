"""The paper's CNN (feature extractor + fully-connected classifier, §3.1),
from ``repro/models/cnn.py``.

Configurable to the seven network scales of Table 2.  Convolutions run
through ``layers.conv2d`` (K4 forward with the bias + relu epilogue,
K5/K6 backward), pooling through ``ops.max_pool2d`` (K7/K8, ties split
evenly) and the classifier through ``layers.fc`` (K1 forward, K2/K3
backward).  The training objective is the paper's squared error over the
softmax outputs (Eq. 16).

Activations stay NHWC from the images to the classifier: its input is
``x.reshape(B, -1)`` of an NHWC map, the flatten order of the reference's
first FC weight.  Params are ``{"conv": [...], "fc": [...]}`` of
``{"w", "b"}`` dicts in the reference's layouts.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers

__all__ = ["CNNConfig", "init_cnn", "cnn_forward", "cnn_loss", "cnn_accuracy",
           "TABLE2_CASES", "make_case"]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    image_size: int = 32
    in_channels: int = 3
    conv_layers: int = 2            # layers(Conv) in Table 2
    filters: int = 4                # filters(Conv)
    filter_size: int = 3
    fc_layers: int = 3              # layers(FC)
    fc_neurons: int = 500           # neurons(FC)
    num_classes: int = 10
    pool_every: int = 1             # 2x2 max-pool after every k-th conv

    def __post_init__(self):
        if self.pool_every < 1:
            raise ValueError(
                f"pool_every must be >= 1, got {self.pool_every}")


# Table 2 of the paper: (conv layers, filters, FC layers, FC neurons); the
# filters are filter_size x filter_size (3 x 3) in every case
_T2 = {
    "case1": (2, 4, 3, 500), "case2": (4, 4, 3, 1000),
    "case3": (6, 8, 5, 1500), "case4": (8, 8, 5, 1500),
    "case5": (8, 10, 7, 2000), "case6": (10, 10, 7, 2000),
    "case7": (10, 12, 7, 2000),
}
TABLE2_CASES = tuple(_T2)


def make_case(case: str, image_size: int = 32, num_classes: int = 10,
              in_channels: int = 3) -> CNNConfig:
    cl, f, fl, n = _T2[case]
    # deep cases can't pool every layer at 32px; pool only while >= 8px
    return CNNConfig(name=case, image_size=image_size,
                     in_channels=in_channels, conv_layers=cl, filters=f,
                     fc_layers=fl, fc_neurons=n, num_classes=num_classes)


def _conv_shapes(cfg: CNNConfig):
    """Per-layer (in_ch, out_ch, spatial, pooled) with same-padding convs,
    and the final spatial size.  A layer pools iff it is a
    ``pool_every``-th conv layer AND its map is still >= 8 px."""
    shapes = []
    size, cin = cfg.image_size, cfg.in_channels
    for i in range(cfg.conv_layers):
        pooled = (i + 1) % cfg.pool_every == 0 and size >= 8
        shapes.append((cin, cfg.filters, size, pooled))
        if pooled:
            size //= 2
        cin = cfg.filters
    return shapes, size


def init_cnn(cfg: CNNConfig, generator, device="cuda", dtype=torch.float32):
    """He-initialised params drawn from ``generator`` on ``device``
    (``"meta"`` builds shapes only and takes ``generator=None``)."""
    if torch.device(device).type == "meta":
        dev = torch.device("meta")
    else:
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            raise TypeError("init_cnn needs an explicit torch.Generator")
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device} cannot draw "
                             f"params on {dev}")
    kw = dict(dtype=dtype, device=dev)
    shapes, final = _conv_shapes(cfg)
    k = cfg.filter_size
    params = {"conv": [layers.init_conv2d(generator, k, k, cin, cout, **kw)
                       for cin, cout, _, _ in shapes], "fc": []}
    dims = ([final * final * cfg.filters] + [cfg.fc_neurons]
            * (cfg.fc_layers - 1) + [cfg.num_classes])
    for j in range(cfg.fc_layers):
        params["fc"].append(layers.init_fc(generator, dims[j], dims[j + 1],
                                           **kw))
    return params


def cnn_forward(params, images, cfg: CNNConfig):
    """images: (B, H, W, C) -> logits (B, classes)."""
    x = images
    shapes, _ = _conv_shapes(cfg)
    for p, (_, _, _, pooled) in zip(params["conv"], shapes, strict=True):
        x = layers.conv2d(p, x, padding="SAME", activation="relu")
        if pooled:
            x = ops.max_pool2d(x, window=2, stride=2)
    x = x.reshape(x.shape[0], -1)
    for j, p in enumerate(params["fc"]):
        hidden = j < len(params["fc"]) - 1
        x = layers.fc(p, x, activation="relu" if hidden else "none")
    return x


def cnn_loss(params, batch, cfg: CNNConfig):
    """Paper's Eq. 16: squared error between one-hot labels and the
    softmax outputs, summed over classes and averaged over the batch.

    An optional ``batch["mask"]`` (B,) of 0/1 weights drops padded rows by
    switching to the masked mean ``sum(per * mask) / max(sum(mask), 1)``.
    """
    logits = cnn_forward(params, batch["images"], cfg)
    y = torch.nn.functional.one_hot(batch["labels"].long(),
                                    cfg.num_classes).to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    per_example = ((y - probs) ** 2).sum(dim=-1)
    mask = batch.get("mask")
    if mask is None:
        return per_example.mean()
    mask = mask.to(per_example.dtype)
    return (per_example * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cnn_accuracy(params, batch, cfg: CNNConfig):
    """The share of argmax hits, as the reference's ``jnp.mean`` computes
    it: the f32 count times the f32 reciprocal of B (XLA's rewrite of a
    division by a constant), so the two packages give the same float."""
    logits = cnn_forward(params, batch["images"], cfg)
    hits = (logits.argmax(-1) == batch["labels"].long()).float().sum()
    return hits * (1.0 / logits.shape[0])
