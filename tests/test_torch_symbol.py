"""ResNet symbols of the port against the JAX package's: argument and
auxiliary-state names, output names, the HWIO layout stamp on conv weights,
and every inferred shape must be identical.  Shape-only and cheap."""
import pytest

from mxnet_tpu.models.resnet import resnet as resnet_j
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.models.resnet import resnet as resnet_t


@pytest.fixture(autouse=True)
def _fresh_port_names():
    tname.NameManager._current.value = tname.NameManager()
    yield


@pytest.mark.parametrize("depth,layout,data", [
    (50, "NHWC", (2, 224, 224, 3)),
    (50, "NCHW", (2, 3, 224, 224)),
    (18, "NHWC", (2, 224, 224, 3)),
])
def test_resnet_names_and_shapes_match(depth, layout, data):
    sj, st = resnet_j(depth, layout=layout), resnet_t(depth, layout=layout)
    assert st.list_arguments() == sj.list_arguments()
    assert st.list_auxiliary_states() == sj.list_auxiliary_states()
    assert st.list_outputs() == sj.list_outputs()
    assert st.infer_shape(data=data) == sj.infer_shape(data=data)
    layouts_j = {k: v.get("__layout__") for k, v in sj.attr_dict().items()}
    layouts_t = {k: v.get("__layout__") for k, v in st.attr_dict().items()}
    assert layouts_t == layouts_j


def test_resnet50_has_51_batchnorms():
    from mxnet_tpu_torch.symbol import _topo_order

    net = resnet_t(50, layout="NHWC")
    bns = [n for n in _topo_order(net._entries)
           if n.op is not None and n.op.name == "BatchNorm"]
    assert len(bns) == 51
