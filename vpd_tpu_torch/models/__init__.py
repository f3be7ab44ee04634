from .fc import FCNet  # noqa
from .resnet import ResNet, ENCODER_ARCH, build_encoder  # noqa
