"""ResNet v2 (pre-activation) symbol builder (parity: mxnet_tpu/models/resnet.py).

The same graph as the JAX package, built on the port's ``sym``: NCHW by
default, or ``layout="NHWC"`` for channel-last activations with HWIO conv
weights.
"""
from .. import symbol as sym

__all__ = ["get_resnet", "resnet50"]


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True, bn_mom=0.9,
                  layout="NCHW"):
    """One pre-activation residual unit (ResNet v2)."""
    ax = -1 if layout.endswith("C") else 1
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom, axis=ax, name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4, kernel=(1, 1), stride=(1, 1),
                                pad=(0, 0), no_bias=True, layout=layout, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom, axis=ax, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4, kernel=(3, 3), stride=stride,
                                pad=(1, 1), no_bias=True, layout=layout, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=bn_mom, axis=ax, name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1), stride=(1, 1),
                                pad=(0, 0), no_bias=True, layout=layout, name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1), stride=stride,
                                       no_bias=True, layout=layout, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom, axis=ax, name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3), stride=stride,
                            pad=(1, 1), no_bias=True, layout=layout, name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom, axis=ax, name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3), stride=(1, 1),
                            pad=(1, 1), no_bias=True, layout=layout, name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1), stride=stride,
                                   no_bias=True, layout=layout, name=name + "_sc")
    return conv2 + shortcut


def get_resnet(units, filter_list, num_classes=1000, bottle_neck=True, image_shape=(3, 224, 224),
               bn_mom=0.9, layout="NCHW"):
    """Build a ResNet symbol (reference resnet.py `resnet` fn behavior).

    `layout="NHWC"` builds the channel-last graph: data (N, H, W, C) and
    conv weights HWIO."""
    ax = -1 if layout.endswith("C") else 1
    data = sym.Variable("data")
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom, axis=ax, name="bn_data")
    (nchannel, height, width) = image_shape
    if height <= 32:  # cifar
        body = sym.Convolution(data, num_filter=filter_list[0], kernel=(3, 3), stride=(1, 1),
                               pad=(1, 1), no_bias=True, layout=layout, name="conv0")
    else:  # imagenet
        body = sym.Convolution(data, num_filter=filter_list[0], kernel=(7, 7), stride=(2, 2),
                               pad=(3, 3), no_bias=True, layout=layout, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom, axis=ax, name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
                           layout=layout)
    num_stages = len(units)
    for i in range(num_stages):
        body = residual_unit(
            body, filter_list[i + 1], (1 if i == 0 else 2, 1 if i == 0 else 2), False,
            name="stage%d_unit%d" % (i + 1, 1), bottle_neck=bottle_neck, bn_mom=bn_mom,
            layout=layout,
        )
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, bn_mom=bn_mom, layout=layout)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom, axis=ax, name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7), pool_type="avg", name="pool1",
                        layout=layout)
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


_DEPTH_CONFIGS = {
    18: ([2, 2, 2, 2], [64, 64, 128, 256, 512], False),
    34: ([3, 4, 6, 3], [64, 64, 128, 256, 512], False),
    50: ([3, 4, 6, 3], [64, 256, 512, 1024, 2048], True),
    101: ([3, 4, 23, 3], [64, 256, 512, 1024, 2048], True),
    152: ([3, 8, 36, 3], [64, 256, 512, 1024, 2048], True),
    200: ([3, 24, 36, 3], [64, 256, 512, 1024, 2048], True),
}


def resnet50(num_classes=1000, image_shape=(3, 224, 224), layout="NCHW"):
    return resnet(50, num_classes, image_shape, layout=layout)


def resnet(depth, num_classes=1000, image_shape=(3, 224, 224), layout="NCHW"):
    if depth not in _DEPTH_CONFIGS:
        raise ValueError("no experiments done on depth %d" % depth)
    units, filters, bottle = _DEPTH_CONFIGS[depth]
    if image_shape[1] <= 32:
        # cifar-style stages (reference resnet.py cifar path)
        per_unit = [(depth - 2) // 9] * 3 if bottle else [(depth - 2) // 6] * 3
        flist = [16, 64, 128, 256] if bottle else [16, 16, 32, 64]
        return get_resnet(per_unit, flist, num_classes, bottle, image_shape, layout=layout)
    return get_resnet(units, filters, num_classes, bottle, image_shape, layout=layout)
