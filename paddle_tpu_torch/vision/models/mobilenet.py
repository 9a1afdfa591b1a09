"""MobileNet V1/V2 (the port of `paddle_tpu/vision/models/mobilenet.py`;
ref python/paddle/vision/models/mobilenetv1.py, v2)."""
from ... import nn


class ConvBNLayer(nn.Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, act="relu"):
        super().__init__()
        self.conv = nn.Conv2D(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_channels)
        self.act = nn.ReLU() if act == "relu" else (
            nn.ReLU6() if act == "relu6" else None)

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act is not None:
            x = self.act(x)
        return x


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale):
        super().__init__()
        self.dw = ConvBNLayer(in_channels, int(out_channels1 * scale), 3,
                              stride=stride, padding=1,
                              groups=int(num_groups * scale))
        self.pw = ConvBNLayer(int(out_channels1 * scale),
                              int(out_channels2 * scale), 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1)
        cfg = [(32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
               (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
               (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
               (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
               (1024, 1024, 1024, 1024, 1)]
        blocks = []
        for in_c, c1, c2, g, s in cfg:
            blocks.append(DepthwiseSeparable(int(in_c * scale), c1, c2, g, s,
                                             scale))
        self.blocks = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.conv1(x)
        x = self.blocks(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden_dim, 1, act="relu6"))
        layers.extend([
            ConvBNLayer(hidden_dim, hidden_dim, 3, stride=stride, padding=1,
                        groups=hidden_dim, act="relu6"),
            ConvBNLayer(hidden_dim, oup, 1, act=None),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = 32
        last_channel = 1280
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_channel = _make_divisible(input_channel * scale)
        self.last_channel = _make_divisible(last_channel * max(1.0, scale))
        features = [ConvBNLayer(3, input_channel, 3, stride=2, padding=1,
                                act="relu6")]
        for t, c, n, s in cfg:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                stride = s if i == 0 else 1
                features.append(InvertedResidual(input_channel, output_channel,
                                                 stride, t))
                input_channel = output_channel
        features.append(ConvBNLayer(input_channel, self.last_channel, 1,
                                    act="relu6"))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
