"""The work of a ResNet training step, counted from the configuration's layer
shapes alone: multiply-accumulates of every convolution and of the head,
"SAME" padding (output size ceil(size / stride)), nothing of BN, the
activations or the pools. A training step is three forwards' worth (the
forward, and the backward's data and weight gradients); recomputation is not
counted."""

from __future__ import annotations


def forward_macs(model: dict) -> int:
    """Multiply-accumulates of one image's forward."""
    size, w = model["image_size"], model["width"]
    s = -(-size // 2)
    macs = s * s * w * 3 * 7 * 7                    # the stem's 7x7 conv, stride 2
    s = -(-s // 2)                                   # the max pool, stride 2
    cin = w
    for stage, n in enumerate(model["stage_sizes"]):
        inner = w * 2 ** stage
        cout = inner * 4
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            out = -(-s // stride)
            macs += s * s * cin * inner                  # conv1, 1x1
            macs += out * out * inner * inner * 9        # conv2, 3x3 at the stride
            macs += out * out * inner * cout             # conv3, 1x1
            if cin != cout:
                macs += out * out * cin * cout           # the projection, 1x1 at the stride
            s, cin = out, cout
    return macs + cin * model["num_classes"]


def train_flops(model: dict, images: int) -> int:
    """Model FLOPs of a training step over ``images``."""
    return 3 * 2 * forward_macs(model) * images
