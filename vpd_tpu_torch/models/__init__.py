from .fc import FCNet, FCPoseDecoder, FCResNet, FCResNetPoseDecoder  # noqa
from .resnet import ResNet, ENCODER_ARCH, build_encoder  # noqa
