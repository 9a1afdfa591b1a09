"""Vision model zoo (the port of `paddle_tpu/vision/models`; ref
python/paddle/vision/models). The layers are built as the JAX package's
are, so their state-dict keys, shapes and layouts are the same
(BatchNorm's `_mean` and `_variance` included): `set_state_dict` of a
JAX model's `state_dict()` as numpy arrays carries its weights across."""
from .lenet import LeNet
from .resnet import (ResNet, BasicBlock, BottleneckBlock,
                     resnet18, resnet34, resnet50, resnet101, resnet152)
from .vgg import VGG, make_layers, vgg11, vgg13, vgg16, vgg19
from .mobilenet import (MobileNetV1, MobileNetV2, ConvBNLayer,
                        DepthwiseSeparable, InvertedResidual,
                        mobilenet_v1, mobilenet_v2)

# ref mobilenetv2 exports ConvBNReLU; this zoo's equivalent fused block
ConvBNReLU = ConvBNLayer
